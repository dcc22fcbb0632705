// Flash-attention forward for Hopper (sm_90a), head_dim 64.
//
// Replaces the Pallas TPU kernel deepspeed_tpu/ops/pallas/flash_attention.py
// `_fwd_kernel` (launched by `_fwd` through `pl.pallas_call`): attention over
// [B*H, T, 64] with an online softmax across key tiles, fp32 running max m,
// normaliser l and output accumulator, the causal mask, the additive key
// mask, the `kv_length` validity floor, the in-kernel hash dropout and the
// dead-row rule (a row with no valid key outputs 0 and lse = +1e30).  The
// mask and hash math lives in flash_common.cuh, shared with both backward
// kernels.
//
// What bounds it on the H100: at the serving prefill's shape (T = 512,
// causal, 12 heads, bf16) the work is ~0.4 GFLOP per layer against ~3.2 MB
// of q/k/v/o/lse traffic: at the tensor cores' 989 TFLOP/s the bytes bound
// it (~1 us).  This first kernel does its two products per tile with plain
// fp32 FMAs out of shared memory, so its own bound is the operations at the
// 67 TFLOP/s fp32 rate (~6 us): moving both products onto wgmma
// (FlashAttention-3) is the later step.
//
// What the design does about it:
// - one block per (query tile of 64 rows, batch*head); 256 threads, four
//   per query row, each owning a quarter of the tile's key columns and a
//   quarter of the output columns;
// - the query row lives in registers, each K/V tile of 32 keys is staged
//   once in shared memory (converted to fp32) and read by all 64 rows;
//   the K tile rows are padded to 65 floats so the four column groups of
//   a warp hit distinct banks;
// - the key loop stops at the causal diagonal of the tile's last row and
//   at kv_length, so no tile past either is read;
// - the ragged edge (T not a multiple of the tile) and kv_length are
//   masked in the kernel, with no padded copies of q/k/v;
// - dropout regenerates its keep mask from (batch*head, q, k, seed) with
//   the position hash, so no mask is stored: the normaliser l sums the
//   undropped p and only the value product sees the dropped one;
// - O is written in the input dtype and lse as a plain fp32 [B*H, T]
//   (no 8-row sublane broadcast: that layout only served Mosaic's tiling).
#include "flash_common.cuh"

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

// dtype: 0 fp32, 1 bf16, 2 fp16.  q/o are [bh, tq, 64], k/v [bh, tk, 64],
// lse [bh, tq] fp32, kmask [bh, tk] fp32 or null, all contiguous.  Returns
// cudaGetLastError().
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
    case 1: launch<__nv_bfloat16>(q, k, v, o, lse, bh, tq, tk, mk, st); break;
    case 2: launch<__half>(q, k, v, o, lse, bh, tq, tk, mk, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
