// Block-sparse attention backward, dQ, for Hopper (sm_90a), head_dim 64.
//
// Replaces the Pallas TPU kernel
// deepspeed_tpu/ops/pallas/block_sparse_attention.py `_bwd_dq_kernel`
// (launched by `_sparse_bwd` through `pl.pallas_call`): each query row
// walks the active key blocks of its row LUT (`cols`, `nvalid`), recomputes
// the probabilities from the forward's lse and accumulates
//     p  = exp(q.k * scale - lse)
//     ds = p * (dO.v - delta) * scale      (delta = rowsum(dO * O), given)
//     dQ += ds . K
// in fp32, writing dQ once in the input dtype.
//
// What bounds it on the H100: three products per active (query, key) pair,
// 6 * 64 flops a pair (~55 GFLOP at [2, 16, 4096, 64] with the Fixed block-16
// layout) against ~85 MB of q/k/v/dO/lse/delta/dQ: the operations bound
// it at the tensor cores' rate (~0.06 ms).  This first kernel runs the
// products as plain fp32 FMAs (67 TFLOP/s, ~0.8 ms); wgmma comes later.
//
// What the design does about it:
// - the forward's walk (block_sparse_fwd.cu): one CUDA block per
//   (batch*head, query rows of one block row), exactly `nvalid` LUT steps;
//   the block owns its dQ rows, so no atomics;
// - the query row and its dO row live in registers; K and V tiles of
//   min(block, 32) keys are staged once in shared memory per active block;
// - a row with no active block (lse = -1e30 from the forward) reads
//   nothing and writes exact zeros: exp(s - lse) is never formed for it.
#include "block_sparse_common.cuh"

namespace {

using namespace block_sparse;

template <typename T, int BLOCK>
__global__ void __launch_bounds__(Tile<BLOCK>::THREADS)
block_sparse_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const T* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta, T* __restrict__ dq,
                           Lut lut, int t, float scale) {
  using G = Tile<BLOCK>;
  __shared__ float ks[G::KT][D + 1];
  __shared__ float vs[G::KT][D + 1];
  __shared__ float dss[G::ROWS][G::KT + 1];

  const int bh = blockIdx.y;
  const int r = blockIdx.x / G::SUB;
  const int tid = threadIdx.x;
  const int row = tid >> 2;
  const int cg = tid & 3;
  const int qi = blockIdx.x * G::ROWS + row;
  const int plane = lut_plane(bh, lut);
  const int n = lut_count(plane, r, lut);
  const size_t qoff = ((size_t)bh * t + qi) * D;

  float acc[G::OPT];
#pragma unroll
  for (int j = 0; j < G::OPT; ++j) acc[j] = 0.f;

  if (n > 0) {  // uniform over the CUDA block: one block row
    const T* kb = k + (size_t)bh * t * D;
    const T* vb = v + (size_t)bh * t * D;
    float qr[D], dor[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      qr[d] = to_f(q[qoff + d]);
      dor[d] = to_f(dout[qoff + d]);
    }
    const float lse_i = lse[(size_t)bh * t + qi];
    const float delta_i = delta[(size_t)bh * t + qi];

    for (int w = 0; w < n; ++w) {
      const int c = lut_entry(plane, r, w, lut);
      for (int sub = 0; sub < G::NT; ++sub) {
        __syncthreads();  // every warp is done with the previous tile
        stage2<T, G::KT, D + 1, G::THREADS>(ks, vs, kb, vb, c * BLOCK + sub * G::KT);
        __syncthreads();

#pragma unroll
        for (int j = 0; j < G::CPT; ++j) {
          const int col = cg + 4 * j;
          float dot = 0.f, dp = 0.f;
#pragma unroll
          for (int d = 0; d < D; ++d) {
            dot = fmaf(qr[d], ks[col][d], dot);
            dp = fmaf(dor[d], vs[col][d], dp);
          }
          const float p = expf(dot * scale - lse_i);
          dss[row][col] = p * (dp - delta_i) * scale;
        }
        __syncwarp();  // the row's ds values come from the same warp

#pragma unroll 4
        for (int col = 0; col < G::KT; ++col) {
          const float ds = dss[row][col];
#pragma unroll
          for (int j = 0; j < G::OPT; ++j) acc[j] = fmaf(ds, ks[col][cg + 4 * j], acc[j]);
        }
      }
    }
  }

  T* out = dq + qoff;
#pragma unroll
  for (int j = 0; j < G::OPT; ++j) out[cg + 4 * j] = from_f<T>(acc[j]);
}

template <typename T, int BLOCK>
void launch(const void* q, const void* k, const void* v, const void* dout,
            const void* lse, const void* delta, void* dq, const Lut& lut, int bh,
            int t, float scale, cudaStream_t st) {
  using G = Tile<BLOCK>;
  const dim3 grid(lut.nb * G::SUB, bh);
  block_sparse_bwd_dq_kernel<T, BLOCK><<<grid, G::THREADS, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq), lut, t, scale);
}

}  // namespace

// dtype: 0 fp32, 1 bf16, 2 fp16; block: 16, 32, 64 or 128.  q/k/v/dout/dq
// are [bh, t, 64], lse/delta [bh, t] fp32, cols [lut_heads, t / block,
// width] and nvalid [lut_heads, t / block] int32, all contiguous on one
// device.  Returns cudaGetLastError().
extern "C" int block_sparse_bwd_dq(const void* q, const void* k, const void* v,
                                   const void* dout, const void* lse,
                                   const void* delta, void* dq, const void* cols,
                                   const void* nvalid, int bh, int heads,
                                   int lut_heads, int t, int block, int width,
                                   float scale, int dtype, void* stream) {
  const Lut lut{static_cast<const int*>(cols), static_cast<const int*>(nvalid), heads,
                lut_heads, t / block, width};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  BLOCK_SPARSE_DISPATCH(launch, q, k, v, dout, lse, delta, dq, lut, bh, t, scale, st)
  return static_cast<int>(cudaGetLastError());
}
