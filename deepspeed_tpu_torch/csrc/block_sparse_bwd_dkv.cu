// Block-sparse attention backward, dK and dV, for Hopper (sm_90a),
// head_dim 64.
//
// Replaces the Pallas TPU kernel
// deepspeed_tpu/ops/pallas/block_sparse_attention.py `_bwd_dkv_kernel`
// (launched by `_sparse_bwd` through `pl.pallas_call`): each key row walks
// the query blocks that attend to its key block, listed in the transposed
// LUT (`rows_t`, `nvalid_t`), recomputes the probabilities from the
// forward's lse and accumulates
//     p  = exp(q.k * scale - lse)
//     dV += p^T . dO
//     ds = p * (dO.v - delta) * scale
//     dK += ds^T . Q
// in fp32, writing dK and dV once in the input dtype.
//
// What bounds it on the H100: four products per active (query, key) pair,
// 8 * 64 flops a pair (~72 GFLOP at [2, 16, 4096, 64] with the Fixed
// block-16 layout) against ~101 MB: the operations bound it at the tensor
// cores' rate (~0.07 ms).  This first kernel runs the products as plain
// fp32 FMAs (67 TFLOP/s, ~1.1 ms).  The layouts are uneven: with the Fixed
// layout the 64 global key blocks of 256 walk 256 query blocks each while
// the others walk 4, so the longest CUDA blocks set the kernel's time;
// splitting them (with a second reduction pass) is later work.
//
// What the design does about it:
// - no atomics: one CUDA block owns (batch*head, key rows of one key
//   block) and loops over exactly `nvalid_t` query blocks, where the TPU
//   grid ran `width_t` steps for every key block;
// - the key row and its value row live in registers; Q and dO tiles of
//   min(block, 32) queries, with their lse and delta, are staged once in
//   shared memory per attending query block;
// - a query row with no active block never appears in the transposed LUT,
//   so exp(s - lse) with its lse of -1e30 is never formed; a key block no
//   query attends to (nvalid_t = 0) reads nothing and writes exact zeros.
#include "block_sparse_common.cuh"

namespace {

using namespace block_sparse;

template <typename T, int BLOCK>
__global__ void __launch_bounds__(Tile<BLOCK>::THREADS)
block_sparse_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const T* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta, T* __restrict__ dk,
                            T* __restrict__ dv, Lut lut, int t, float scale) {
  using G = Tile<BLOCK>;
  __shared__ float qs[G::KT][D + 1];
  __shared__ float dos[G::KT][D + 1];
  __shared__ float pds[G::ROWS][G::KT + 1];
  __shared__ float dss[G::ROWS][G::KT + 1];
  __shared__ float lses[G::KT];
  __shared__ float deltas[G::KT];

  const int bh = blockIdx.y;
  const int c = blockIdx.x / G::SUB;  // key block
  const int tid = threadIdx.x;
  const int row = tid >> 2;
  const int cg = tid & 3;
  const int kj = blockIdx.x * G::ROWS + row;
  const int plane = lut_plane(bh, lut);
  const int n = lut_count(plane, c, lut);
  const size_t koff = ((size_t)bh * t + kj) * D;

  float dka[G::OPT], dva[G::OPT];
#pragma unroll
  for (int j = 0; j < G::OPT; ++j) {
    dka[j] = 0.f;
    dva[j] = 0.f;
  }

  if (n > 0) {  // uniform over the CUDA block: one key block
    const T* qb = q + (size_t)bh * t * D;
    const T* db = dout + (size_t)bh * t * D;
    const float* lb = lse + (size_t)bh * t;
    const float* eb = delta + (size_t)bh * t;
    float kr[D], vr[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      kr[d] = to_f(k[koff + d]);
      vr[d] = to_f(v[koff + d]);
    }

    for (int w = 0; w < n; ++w) {
      const int rq = lut_entry(plane, c, w, lut);  // an attending query block
      for (int sub = 0; sub < G::NT; ++sub) {
        const int q0 = rq * BLOCK + sub * G::KT;
        __syncthreads();  // every warp is done with the previous tile
        stage2<T, G::KT, D + 1, G::THREADS>(qs, dos, qb, db, q0);
        if (tid < G::KT) {
          lses[tid] = lb[q0 + tid];
          deltas[tid] = eb[q0 + tid];
        }
        __syncthreads();

#pragma unroll
        for (int j = 0; j < G::CPT; ++j) {
          const int col = cg + 4 * j;
          float dot = 0.f, dp = 0.f;
#pragma unroll
          for (int d = 0; d < D; ++d) {
            dot = fmaf(kr[d], qs[col][d], dot);
            dp = fmaf(vr[d], dos[col][d], dp);
          }
          const float p = expf(dot * scale - lses[col]);
          pds[row][col] = p;
          dss[row][col] = p * (dp - deltas[col]) * scale;
        }
        __syncwarp();  // the row's values come from the same warp

#pragma unroll 4
        for (int col = 0; col < G::KT; ++col) {
          const float pd = pds[row][col];
          const float ds = dss[row][col];
#pragma unroll
          for (int j = 0; j < G::OPT; ++j) {
            dva[j] = fmaf(pd, dos[col][cg + 4 * j], dva[j]);
            dka[j] = fmaf(ds, qs[col][cg + 4 * j], dka[j]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < G::OPT; ++j) {
    dk[koff + cg + 4 * j] = from_f<T>(dka[j]);
    dv[koff + cg + 4 * j] = from_f<T>(dva[j]);
  }
}

template <typename T, int BLOCK>
void launch(const void* q, const void* k, const void* v, const void* dout,
            const void* lse, const void* delta, void* dk, void* dv, const Lut& lut,
            int bh, int t, float scale, cudaStream_t st) {
  using G = Tile<BLOCK>;
  const dim3 grid(lut.nb * G::SUB, bh);
  block_sparse_bwd_dkv_kernel<T, BLOCK><<<grid, G::THREADS, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), lut,
      t, scale);
}

}  // namespace

// dtype: 0 fp32, 1 bf16, 2 fp16; block: 16, 32, 64 or 128.  q/k/v/dout/dk/dv
// are [bh, t, 64], lse/delta [bh, t] fp32, rows_t [lut_heads, t / block,
// width] and nvalid_t [lut_heads, t / block] int32 (the transposed LUT),
// all contiguous on one device.  Returns cudaGetLastError().
extern "C" int block_sparse_bwd_dkv(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse,
                                    const void* delta, void* dk, void* dv,
                                    const void* rows_t, const void* nvalid_t, int bh,
                                    int heads, int lut_heads, int t, int block,
                                    int width, float scale, int dtype, void* stream) {
  const Lut lut{static_cast<const int*>(rows_t), static_cast<const int*>(nvalid_t),
                heads, lut_heads, t / block, width};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  BLOCK_SPARSE_DISPATCH(launch, q, k, v, dout, lse, delta, dk, dv, lut, bh, t, scale,
                        st)
  return static_cast<int>(cudaGetLastError());
}
