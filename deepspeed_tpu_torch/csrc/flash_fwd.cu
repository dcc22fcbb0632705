// Flash-attention forward for Hopper (sm_90a), head_dim 64.
//
// Replaces the Pallas TPU kernel deepspeed_tpu/ops/pallas/flash_attention.py
// `_fwd_kernel` (launched by `_fwd` through `pl.pallas_call`): attention over
// [B*H, T, 64] with an online softmax across key tiles, fp32 running max m,
// normaliser l and output accumulator, the causal mask, the additive key
// mask, the `kv_length` validity floor, the in-kernel hash dropout and the
// dead-row rule (a row with no valid key outputs 0 and lse = +1e30).  The
// mask and hash math lives in flash_common.cuh, shared with both backward
// kernels; the Hopper plumbing (TMA, mbarrier ring, wgmma) in
// flash_sm90.cuh, shared with both backward kernels.
//
// What bounds it on the H100: at the training shape ([8, 12, 1024, 64]
// causal, bf16) the two products are ~12.9 GFLOP against ~50.7 MB of
// q/k/v/o/lse traffic: 13.0 us at the tensor cores' 989 TFLOP/s against
// 15.1 us at 3.35 TB/s, so it sits near the ridge between bytes and
// operations; the serving prefill ([1, 12, 512, 64]) is ~0.4 GFLOP against
// ~3.2 MB, bytes-bound (~1 us).  Beside the products, every live (q, k) pair
// pays the softmax (a scale, a max, one ex2) and under dropout the
// position hash (~10 integer operations), ~50 M pairs a training call: that
// per-element work, not the products, is what the design has to hide.
//
// What the design does about it (bf16 and fp16):
// - one block per (query tile of 128 rows, batch*head): two consumer
//   warpgroups of 64 rows and one producer warp; 64 rows (one warpgroup)
//   where 128-row blocks would leave SMs idle (the serving prefill);
//   causal grids launch the longest query tiles first;
// - the producer warp brings Q once and each 64-key K/V tile through TMA
//   into a 3-stage mbarrier ring, so the next tiles' loads are in flight
//   while the consumers compute; ragged tiles are zero-filled by the
//   hardware and masked in the epilogue;
// - S = Q.K^T and O += P.V run on the tensor cores (wgmma m64n64k16, fp32
//   accumulators, Q/K/V straight from the swizzled tiles); the softmax,
//   masks and dropout hash run on S's accumulator fragment in registers,
//   and P feeds the second product from registers with no trip through
//   shared memory;
// - P enters P.V as two terms in the input type, hi = round(p) and
//   lo = round(p - hi), so the product keeps ~16 bits of p: one rounding
//   (the JAX kernel's `pd.astype(v.dtype)`) moves the output by ~10 bf16
//   ulps at a BERT-shaped call, the split stays within one
//   (tests/test_torch_flash_split.py);
// - the key loop stops at the causal diagonal of each warpgroup's last row
//   and at kv_length; the normaliser l sums the undropped p, and only the
//   value product sees the dropped one; dead rows are found on the
//   natural-log scale (the kernel works in exp2);
// - O is written in the input dtype and lse as a plain fp32 [B*H, T].
//
// The fp32 arm keeps the first kernel below (plain fp32 FMAs out of shared
// memory, one block per 64 query rows, four threads a row): it is the parity
// path that holds the fp32 kernel-path losses within 1e-4 of the dense
// path's, and wgmma would take fp32 inputs only as TF32 (10-bit mantissa),
// which would not.
#include "flash_sm90.cuh"

namespace {

using namespace flash;

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 32;        // keys per shared-memory tile
constexpr int THREADS = 256;  // 4 threads per query row
constexpr int CPT = BK / 4;   // key columns per thread per tile
constexpr int OPT = D / 4;    // output columns per thread

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int tq, int tk, Mask mk) {
  __shared__ float ks[BK][D + 1];
  __shared__ float vs[BK][D];
  __shared__ float ps[BQ][BK + 1];
  __shared__ float kms[BK];

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int row = tid >> 2;  // query row within the tile
  const int cg = tid & 3;    // column group: columns cg, cg+4, cg+8, ...
  const int qi = q0 + row;
  const bool row_live = qi < tq;
  const uint32_t hid = bh_id(bh, mk);

  const T* qb = q + (size_t)bh * tq * D;
  const T* kb = k + (size_t)bh * tk * D;
  const T* vb = v + (size_t)bh * tk * D;

  float qr[D];
#pragma unroll
  for (int d = 0; d < D; ++d) qr[d] = row_live ? to_f(qb[(size_t)qi * D + d]) : 0.f;

  float acc[OPT];
#pragma unroll
  for (int j = 0; j < OPT; ++j) acc[j] = 0.f;
  float m = NEG_INF, l = 0.f;

  // keys any row of this tile can see: below kv_length, and (causal) at or
  // below the diagonal of the tile's last row
  int kend = min(tk, mk.seq_len);
  if (mk.causal) kend = min(kend, q0 + BQ);
  const int ntiles = (kend + BK - 1) / BK;

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // every warp is done with the previous tile
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, c = i % D;
      const int kj = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (kj < tk) {
        kv = to_f(kb[(size_t)kj * D + c]);
        vv = to_f(vb[(size_t)kj * D + c]);
      }
      ks[r][c] = kv;
      vs[r][c] = vv;
    }
    if (tid < BK) kms[tid] = key_mask(bh, k0 + tid, tk, mk);
    __syncthreads();

    float s[CPT];
    float mt = NEG_INF;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = cg + 4 * j;
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], ks[c][d], dot);
      s[j] = masked_score(dot, kms[c], qi, k0 + c, mk);
      mt = fmaxf(mt, s[j]);
    }
    // the four threads of a row are adjacent lanes of one warp
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
    const float m_new = fmaxf(m, mt);
    const float alpha = expf(m - m_new);
    float lsum = 0.f;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = cg + 4 * j;
      float p = expf(s[j] - m_new);
      lsum += p;  // the normaliser sums the undropped probabilities
      if (mk.dropout) p = keep(qi, k0 + c, hid, mk) ? p / mk.keep_div : 0.f;
      ps[row][c] = p;
    }
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
    l = alpha * l + lsum;
    m = m_new;
    __syncwarp();  // the row's p values come from the same warp

#pragma unroll
    for (int j = 0; j < OPT; ++j) acc[j] *= alpha;
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      const float p = ps[row][c];
#pragma unroll
      for (int j = 0; j < OPT; ++j) acc[j] = fmaf(p, vs[c][cg + 4 * j], acc[j]);
    }
  }

  if (!row_live) return;
  // dead rows (no valid key) hard-zero; their lse is +1e30
  const bool dead = m <= DEAD_ROW_THRESH;
  const float l_safe = (l == 0.f) ? 1.f : l;
  T* ob = o + ((size_t)bh * tq + qi) * D;
#pragma unroll
  for (int j = 0; j < OPT; ++j) ob[cg + 4 * j] = from_f<T>(dead ? 0.f : acc[j] / l_safe);
  if (cg == 0) lse[(size_t)bh * tq + qi] = dead ? DEAD_LSE : m + logf(l_safe);
}

template <typename T>
void launch(const void* q, const void* k, const void* v, void* o, void* lse,
            int bh, int tq, int tk, const Mask& mk, cudaStream_t st) {
  const dim3 grid(bh, (tq + BQ - 1) / BQ);
  flash_fwd_kernel<T><<<grid, THREADS, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), tq, tk, mk);
}

}  // namespace

namespace sm90k {

using namespace flash;
using namespace flash::sm90;

// One consumer warpgroup's walk over the block's key tiles: 64 query rows
// starting at qw, the accumulator fragments in registers.
template <typename T, int NWG>
__device__ __forceinline__ void consume(uint8_t* sm, T* __restrict__ o,
                                        float* __restrict__ lse, int bh, int qw,
                                        int ntiles, int tq, int tk, const Mask& mk) {
  using P = Plan<NWG, 1, 1>;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + P::BAR);
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + STAGES;
  const float* kms = reinterpret_cast<const float*>(sm + P::ROWS);
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int wg = threadIdx.x >> 7;
  const int r0 = qw + acc_row(0, warp, lane);  // this thread's rows r0, r0 + 8
  const int kvalid = min(tk, mk.seq_len);
  const float scale2 = mk.sm_scale * LOG2E;
  const float inv_keep = 1.f / mk.keep_div;
  const uint32_t slt = salt(bh_id(bh, mk), mk);
  const uint32_t rt[2] = {row_term(r0), row_term(r0 + 8)};

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};  // l: this thread's part

  const uint64_t qd = desc(sm + P::STAT + wg * TILE_BYTES);
  mbar_wait(bars, 0);
  for (int t = 0; t < ntiles; ++t) {
    const int s = t % STAGES;
    const int k0 = t * TILE;
    mbar_wait(&full[s], (t / STAGES) & 1);
    if (!(mk.causal && k0 > qw + TILE - 1)) {  // past every row's diagonal
      const uint64_t kd = desc(sm + P::RING0 + s * TILE_BYTES);
      const uint64_t vd = desc(sm + P::RING1 + s * TILE_BYTES);
      float sc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = 0.f;
      fence_regs(sc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_ss<T, 0>(sc, qd + kk * K_MAJOR_STEP, kd + kk * K_MAJOR_STEP, kk > 0);
      wg_commit();
      wg_wait<0>();
      fence_regs(sc);

      // scores on the log2 scale, masked, and the tile's row maxima
      const bool edge = k0 + TILE > kvalid || (mk.causal && k0 + TILE - 1 > qw);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int h = (i >> 1) & 1;
        const int c = acc_col(i, lane);
        float x = sc[i] * scale2;
        if (mk.kmask != nullptr) x = fmaf(kms[s * TILE + c], LOG2E, x);
        if (edge) {
          const int kj = k0 + c;
          const bool valid = kj < kvalid && (!mk.causal || kj <= r0 + 8 * h);
          x = valid ? x : NEG_INF;
        }
        sc[i] = x;
        mx[h] = fmaxf(mx[h], x);
      }
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        alpha[h] = ex2(m[h] - mx[h]);
        m[h] = mx[h];
        l[h] *= alpha[h];
      }
      // p (undropped into l), dropout, and P as hi + lo pairs of T
      uint32_t phi[16], plo[16];
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int h = (i >> 1) & 1;
        float p0 = ex2(sc[i] - m[h]);
        float p1 = ex2(sc[i + 1] - m[h]);
        l[h] += p0 + p1;
        if (mk.dropout) {
          const int kj = k0 + acc_col(i, lane);
          p0 = keep_at(rt[h], kj, slt, mk.thresh) ? p0 * inv_keep : 0.f;
          p1 = keep_at(rt[h], kj + 1, slt, mk.thresh) ? p1 * inv_keep : 0.f;
        }
        phi[i >> 1] = pack2<T>(p0, p1);
        const float2 hv = unpack2<T>(phi[i >> 1]);
        plo[i >> 1] = pack2<T>(p0 - hv.x, p1 - hv.y);
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] *= alpha[(i >> 1) & 1];
      fence_regs(acc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        mma_rs<T, 1>(acc, &phi[4 * kk], vd + kk * MN_MAJOR_STEP, 1);
        mma_rs<T, 1>(acc, &plo[4 * kk], vd + kk * MN_MAJOR_STEP, 1);
      }
      wg_commit();
      wg_wait<0>();
      fence_regs(acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // the row sums live in the four threads of a row
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = r0 + 8 * h;
    if (qi >= tq) continue;
    // dead rows (no valid key) hard-zero; their lse is +1e30
    const bool dead = m[h] * LN2 <= DEAD_ROW_THRESH;
    const float inv = dead ? 0.f : 1.f / (l[h] == 0.f ? 1.f : l[h]);
    T* ob = o + ((size_t)bh * tq + qi) * D;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i = 4 * j + 2 * h;
      *reinterpret_cast<uint32_t*>(ob + acc_col(i, lane)) =
          pack2<T>(acc[i] * inv, acc[i + 1] * inv);
    }
    if ((lane & 3) == 0)
      lse[(size_t)bh * tq + qi] = dead ? DEAD_LSE : (m[h] + log2f(l[h])) * LN2;
  }
}

template <typename T, int NWG>
__global__ void __launch_bounds__(NWG * 128 + 32)
flash_fwd_sm90(const __grid_constant__ CUtensorMap tmq,
               const __grid_constant__ CUtensorMap tmk,
               const __grid_constant__ CUtensorMap tmv, T* __restrict__ o,
               float* __restrict__ lse, int tq, int tk, Mask mk) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align_1k(smem_raw);
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * (NWG * TILE);  // longest first
  const int ntiles = (key_end(q0, NWG * TILE, tk, mk) + TILE - 1) / TILE;
  init_barriers<NWG, 1, 1>(sm);
  if ((threadIdx.x >> 7) == NWG) {  // the producer warp
    produce<NWG, 1, 1>(sm, &tmq, nullptr, &tmk, &tmv, bh, q0, 0, ntiles,
                       KeyMaskRows{bh, tk, mk});
  } else {
    consume<T, NWG>(sm, o, lse, bh, q0 + TILE * (threadIdx.x >> 7), ntiles, tq,
                    tk, mk);
  }
}

template <typename T, int NWG>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int bh, int tq, int tk, const Mask& mk, bool fp16, cudaStream_t st) {
  CUtensorMap mq, mkk, mv;
  int rc = make_map(&mq, q, bh, tq, fp16);
  if (rc == 0) rc = make_map(&mkk, k, bh, tk, fp16);
  if (rc == 0) rc = make_map(&mv, v, bh, tk, fp16);
  if (rc != 0) return rc;
  const int bytes = Plan<NWG, 1, 1>::LAUNCH_BYTES;
  const int smem_rc = allow_smem(flash_fwd_sm90<T, NWG>, bytes);
  if (smem_rc != 0) return smem_rc;
  const dim3 grid(bh, (tq + NWG * TILE - 1) / (NWG * TILE));
  flash_fwd_sm90<T, NWG><<<grid, NWG * 128 + 32, bytes, st>>>(
      mq, mkk, mv, static_cast<T*>(o), static_cast<float*>(lse), tq, tk, mk);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_tc(const void* q, const void* k, const void* v, void* o, void* lse,
              int bh, int tq, int tk, const Mask& mk, bool fp16, cudaStream_t st) {
  if (two_warpgroups(bh, tq))
    return launch<T, 2>(q, k, v, o, lse, bh, tq, tk, mk, fp16, st);
  return launch<T, 1>(q, k, v, o, lse, bh, tq, tk, mk, fp16, st);
}

}  // namespace sm90k

// dtype: 0 fp32 (the FMA kernel), 1 bf16, 2 fp16 (the tensor-core kernel).
// q/o are [bh, tq, 64], k/v [bh, tk, 64], lse [bh, tq] fp32, kmask [bh, tk]
// fp32 or null, all contiguous; bf16/fp16 bases 16-byte aligned.  Returns a
// CUDA error code (cudaGetLastError() after the launch), 0 on success.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         void* lse, const void* kmask, int bh, int tq, int tk,
                         int kv_len, float sm_scale, int causal, int dropout,
                         unsigned seed, unsigned thresh, float keep_div,
                         unsigned bh_base, int bh_period, unsigned bh_stride,
                         int dtype, void* stream) {
  const Mask mk = make_mask(kmask, kv_len, sm_scale, causal, dropout, seed, thresh,
                            keep_div, bh_base, bh_period, bh_stride);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: launch<float>(q, k, v, o, lse, bh, tq, tk, mk, st); break;
    case 1:
      return sm90k::launch_tc<__nv_bfloat16>(q, k, v, o, lse, bh, tq, tk, mk, false, st);
    case 2:
      return sm90k::launch_tc<__half>(q, k, v, o, lse, bh, tq, tk, mk, true, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
