// Flash-attention backward, dQ, for Hopper (sm_90a), head_dim 64.
//
// Replaces the Pallas TPU kernel deepspeed_tpu/ops/pallas/flash_attention.py
// `_bwd_dq_kernel` (launched by `_bwd` through `pl.pallas_call`): for each
// query row, walk the key tiles it can see, recompute the probabilities from
// the saved lse, and accumulate
//     p  = exp(s - lse)                   (s: flash_common.cuh masked_score)
//     dp = dO . V^T, times keep / (1 - rate) under dropout
//     ds = p * (dp - delta) * sm_scale    (delta = rowsum(dO * O), given)
//     dQ += ds . K
// in fp32, writing dQ once in the input dtype.  The dropout keep mask is
// regenerated from the same position hash as the forward's, bit for bit.
//
// What bounds it on the H100: three products per live (query, key) pair
// (q.k, dO.v, ds.k), 6 * 64 flops a pair; at the training shape
// ([8, 12, 1024, 64] causal, bf16) that is ~19.3 GFLOP (19.6 us at the
// tensor cores' 989 TFLOP/s) against ~63.7 MB of q/k/v/dO/dQ/lse/delta
// traffic (19.0 us at 3.35 TB/s): bounded by operations, by a hair.  As in
// the forward, the per-pair epilogue (ex2, the masks, the dropout hash) is
// the work the tensor cores cannot do.
//
// What the design does about it (bf16 and fp16), on flash_sm90.cuh like the
// forward:
// - one block per (query tile of 128 rows, batch*head): two consumer
//   warpgroups of 64 rows and one producer warp (64 rows where 128 would
//   leave SMs idle); the block owns its dQ rows, so no atomics; causal
//   grids launch the longest query tiles first;
// - the producer brings Q and dO once and each 64-key K/V tile through TMA
//   into a 3-stage mbarrier ring; lse and delta are per-row registers;
// - per key tile, S = Q.K^T and dP = dO.V^T are issued back to back on the
//   tensor cores (wgmma m64n64k16, fp32 accumulators); p is recomputed
//   from S while dP is still in flight; dS = p (dP - delta) scale is
//   rounded to the input type in registers (as the JAX kernel's
//   `ds.astype(k.dtype)`) and feeds dQ += dS . K from registers, K read
//   down its rows (the transposed operand);
// - the key loop stops at the causal diagonal of each warpgroup's last row
//   and at kv_length; rows past T and dead rows read lse = +1e30, so their
//   p, and their dQ, are exactly 0.
//
// The fp32 arm keeps the first kernel below (plain fp32 FMAs, four threads
// a query row): it is the parity path that holds the fp32 kernel-path
// losses within 1e-4 of the dense path's, which TF32 wgmma would not.
#include "flash_sm90.cuh"

namespace {

using namespace flash;

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 32;        // keys per shared-memory tile
constexpr int THREADS = 256;  // 4 threads per query row
constexpr int CPT = BK / 4;   // key columns per thread per tile
constexpr int OPT = D / 4;    // dQ columns per thread

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, int tq, int tk, Mask mk) {
  __shared__ float ks[BK][D + 1];
  __shared__ float vs[BK][D + 1];
  __shared__ float dss[BQ][BK + 1];
  __shared__ float kms[BK];

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int row = tid >> 2;
  const int cg = tid & 3;
  const int qi = q0 + row;
  const bool row_live = qi < tq;
  const uint32_t hid = bh_id(bh, mk);

  const T* kb = k + (size_t)bh * tk * D;
  const T* vb = v + (size_t)bh * tk * D;
  const size_t qoff = ((size_t)bh * tq + qi) * D;

  float qr[D], dor[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = row_live ? to_f(q[qoff + d]) : 0.f;
    dor[d] = row_live ? to_f(dout[qoff + d]) : 0.f;
  }
  const float lse_i = row_live ? lse[(size_t)bh * tq + qi] : DEAD_LSE;
  const float delta_i = row_live ? delta[(size_t)bh * tq + qi] : 0.f;

  float acc[OPT];
#pragma unroll
  for (int j = 0; j < OPT; ++j) acc[j] = 0.f;

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

#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = cg + 4 * j;
      const int kj = k0 + c;
      float dot = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        dot = fmaf(qr[d], ks[c][d], dot);
        dp = fmaf(dor[d], vs[c][d], dp);
      }
      const float p = expf(masked_score(dot, kms[c], qi, kj, mk) - lse_i);
      if (mk.dropout) dp = keep(qi, kj, hid, mk) ? dp / mk.keep_div : 0.f;
      dss[row][c] = p * (dp - delta_i) * mk.sm_scale;
    }
    __syncwarp();  // the row's ds values come from the same warp

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      const float ds = dss[row][c];
#pragma unroll
      for (int j = 0; j < OPT; ++j) acc[j] = fmaf(ds, ks[c][cg + 4 * j], acc[j]);
    }
  }

  if (!row_live) return;
  T* out = dq + qoff;
#pragma unroll
  for (int j = 0; j < OPT; ++j) out[cg + 4 * j] = from_f<T>(acc[j]);
}

template <typename T>
void launch(const void* q, const void* k, const void* v, const void* dout,
            const void* lse, const void* delta, void* dq, int bh, int tq, int tk,
            const Mask& mk, cudaStream_t st) {
  const dim3 grid(bh, (tq + BQ - 1) / BQ);
  flash_bwd_dq_kernel<T><<<grid, THREADS, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq), tq, tk, mk);
}

}  // namespace

namespace sm90k {

using namespace flash;
using namespace flash::sm90;

// One consumer warpgroup: dQ of 64 query rows starting at qw.
template <typename T, int NWG>
__device__ __forceinline__ void consume(uint8_t* sm, const float* __restrict__ lse,
                                        const float* __restrict__ delta,
                                        T* __restrict__ dq, int bh, int qw, int ntiles,
                                        int tq, int tk, const Mask& mk) {
  using P = Plan<NWG, 2, 1>;
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
  float lse2[2], dlt[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = r0 + 8 * h;
    const bool live = qi < tq;
    lse2[h] = (live ? lse[(size_t)bh * tq + qi] : DEAD_LSE) * LOG2E;
    dlt[h] = live ? delta[(size_t)bh * tq + qi] : 0.f;
  }

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;

  const uint64_t qd = desc(sm + P::STAT + wg * TILE_BYTES);
  const uint64_t dod = desc(sm + P::STAT + (NWG + wg) * TILE_BYTES);
  mbar_wait(bars, 0);
  for (int t = 0; t < ntiles; ++t) {
    const int s = t % STAGES;
    const int k0 = t * TILE;
    mbar_wait(&full[s], (t / STAGES) & 1);
    if (!(mk.causal && k0 > qw + TILE - 1)) {  // past every row's diagonal
      const uint64_t kd = desc(sm + P::RING0 + s * TILE_BYTES);
      const uint64_t vd = desc(sm + P::RING1 + s * TILE_BYTES);
      float sc[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
      fence_regs(sc);
      fence_regs(dp);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_ss<T, 0>(sc, qd + kk * K_MAJOR_STEP, kd + kk * K_MAJOR_STEP, kk > 0);
      wg_commit();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_ss<T, 0>(dp, dod + kk * K_MAJOR_STEP, vd + kk * K_MAJOR_STEP, kk > 0);
      wg_commit();
      wg_wait<1>();  // S is in; dP may still be running
      fence_regs(sc);

      // p = exp(s - lse), masked, on the log2 scale
      const bool edge = k0 + TILE > kvalid || (mk.causal && k0 + TILE - 1 > qw);
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
        sc[i] = ex2(x - lse2[h]);
      }
      wg_wait<0>();
      fence_regs(dp);
      // dS = p (dp' - delta) scale, dp' = dp keep / (1 - rate)
      uint32_t ds[16];
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int h = (i >> 1) & 1;
        float d0 = dp[i], d1 = dp[i + 1];
        if (mk.dropout) {
          const int kj = k0 + acc_col(i, lane);
          d0 = keep_at(rt[h], kj, slt, mk.thresh) ? d0 * inv_keep : 0.f;
          d1 = keep_at(rt[h], kj + 1, slt, mk.thresh) ? d1 * inv_keep : 0.f;
        }
        ds[i >> 1] = pack2<T>(sc[i] * (d0 - dlt[h]) * mk.sm_scale,
                              sc[i + 1] * (d1 - dlt[h]) * mk.sm_scale);
      }
      fence_regs(acc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_rs<T, 1>(acc, &ds[4 * kk], kd + kk * MN_MAJOR_STEP, 1);
      wg_commit();
      wg_wait<0>();
      fence_regs(acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = r0 + 8 * h;
    if (qi >= tq) continue;
    T* out = dq + ((size_t)bh * tq + qi) * D;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i = 4 * j + 2 * h;
      *reinterpret_cast<uint32_t*>(out + acc_col(i, lane)) = pack2<T>(acc[i], acc[i + 1]);
    }
  }
}

template <typename T, int NWG>
__global__ void __launch_bounds__(NWG * 128 + 32)
flash_bwd_dq_sm90(const __grid_constant__ CUtensorMap tmq,
                  const __grid_constant__ CUtensorMap tmk,
                  const __grid_constant__ CUtensorMap tmv,
                  const __grid_constant__ CUtensorMap tmdo,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  T* __restrict__ dq, int tq, int tk, Mask mk) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align_1k(smem_raw);
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * (NWG * TILE);  // longest first
  const int ntiles = (key_end(q0, NWG * TILE, tk, mk) + TILE - 1) / TILE;
  init_barriers<NWG, 2, 1>(sm);
  if ((threadIdx.x >> 7) == NWG) {  // the producer warp
    produce<NWG, 2, 1>(sm, &tmq, &tmdo, &tmk, &tmv, bh, q0, 0, ntiles,
                       KeyMaskRows{bh, tk, mk});
  } else {
    consume<T, NWG>(sm, lse, delta, dq, bh, q0 + TILE * (threadIdx.x >> 7), ntiles,
                    tq, tk, mk);
  }
}

template <typename T, int NWG>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dq, int bh, int tq, int tk,
           const Mask& mk, bool fp16, cudaStream_t st) {
  CUtensorMap mq, mkk, mv, mdo;
  int rc = make_map(&mq, q, bh, tq, fp16);
  if (rc == 0) rc = make_map(&mkk, k, bh, tk, fp16);
  if (rc == 0) rc = make_map(&mv, v, bh, tk, fp16);
  if (rc == 0) rc = make_map(&mdo, dout, bh, tq, fp16);
  if (rc != 0) return rc;
  const int bytes = Plan<NWG, 2, 1>::LAUNCH_BYTES;
  const int smem_rc = allow_smem(flash_bwd_dq_sm90<T, NWG>, bytes);
  if (smem_rc != 0) return smem_rc;
  const dim3 grid(bh, (tq + NWG * TILE - 1) / (NWG * TILE));
  flash_bwd_dq_sm90<T, NWG><<<grid, NWG * 128 + 32, bytes, st>>>(
      mq, mkk, mv, mdo, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq), tq, tk, mk);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_tc(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int bh, int tq, int tk,
              const Mask& mk, bool fp16, cudaStream_t st) {
  if (two_warpgroups(bh, tq))
    return launch<T, 2>(q, k, v, dout, lse, delta, dq, bh, tq, tk, mk, fp16, st);
  return launch<T, 1>(q, k, v, dout, lse, delta, dq, bh, tq, tk, mk, fp16, st);
}

}  // namespace sm90k

// dtype: 0 fp32 (the FMA kernel), 1 bf16, 2 fp16 (the tensor-core kernel).
// q/dout/dq are [bh, tq, 64], k/v [bh, tk, 64], lse/delta [bh, tq] fp32,
// kmask [bh, tk] fp32 or null, all contiguous; bf16/fp16 bases 16-byte
// aligned.  Returns a CUDA error code (cudaGetLastError() after the
// launch), 0 on success.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse, const void* delta,
                            void* dq, const void* kmask, int bh, int tq, int tk,
                            int kv_len, float sm_scale, int causal, int dropout,
                            unsigned seed, unsigned thresh, float keep_div,
                            unsigned bh_base, int bh_period, unsigned bh_stride,
                            int dtype, void* stream) {
  const Mask mk = make_mask(kmask, kv_len, sm_scale, causal, dropout, seed, thresh,
                            keep_div, bh_base, bh_period, bh_stride);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: launch<float>(q, k, v, dout, lse, delta, dq, bh, tq, tk, mk, st); break;
    case 1:
      return sm90k::launch_tc<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, bh, tq,
                                             tk, mk, false, st);
    case 2:
      return sm90k::launch_tc<__half>(q, k, v, dout, lse, delta, dq, bh, tq, tk, mk,
                                      true, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
