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
// (q.k, dO.v, ds.k), 6 * 64 flops each pair; at the training shape
// ([8, 12, 1024, 64] causal) that is ~19 GFLOP against ~38 MB of
// q/k/v/dO/lse/delta/dQ traffic, so at the tensor cores' rate the bytes
// would bound it.  This first kernel runs all three products as plain fp32
// FMAs (67 TFLOP/s), so its own bound is the operations; wgmma is the later
// step.
//
// What the design does about it:
// - one block per (query tile of 64 rows, batch*head), 256 threads, four
//   per query row; the block owns its dQ rows, so no atomics;
// - the query row and its dO row live in registers; each K/V tile of 32
//   keys is staged once in shared memory (fp32, rows padded to 65 floats)
//   and read by all 64 rows;
// - the key loop stops at the causal diagonal of the tile's last row and
//   at kv_length; rows past T read lse = +1e30, so their p is exactly 0;
// - dead rows (lse = +1e30 from the forward) get exact-zero gradients.
#include "flash_common.cuh"

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

// dtype: 0 fp32, 1 bf16, 2 fp16.  q/dout/dq are [bh, tq, 64], k/v
// [bh, tk, 64], lse/delta [bh, tq] fp32, kmask [bh, tk] fp32 or null, all
// contiguous.  Returns cudaGetLastError().
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
    case 1: launch<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, bh, tq, tk, mk, st); break;
    case 2: launch<__half>(q, k, v, dout, lse, delta, dq, bh, tq, tk, mk, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
