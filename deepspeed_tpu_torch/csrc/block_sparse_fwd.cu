// Block-sparse attention forward for Hopper (sm_90a), head_dim 64.
//
// Replaces the Pallas TPU kernel
// deepspeed_tpu/ops/pallas/block_sparse_attention.py `_fwd_kernel`
// (launched by `_sparse_fwd` through `pl.pallas_call`): each query block row
// attends to the key blocks its row of the layout marks active, listed in
// the row LUT (`cols`, `nvalid`), with an online softmax in fp32 (running
// max m, normaliser l, output accumulator).  Writes O in the input dtype
// and lse = m + log(l) as fp32 [B*H, T] (no 8-sublane broadcast: that
// layout only served Mosaic's tiling).  A row with no active block writes
// O = 0 and lse = -1e30, as the TPU kernel's finalize step does.
//
// What bounds it on the H100: two products per active (query, key) pair,
// 4 * 64 flops a pair.  At [2, 16, 4096, 64] with the Fixed layout (block
// 16, density 0.262) that is ~36 GFLOP against ~68 MB of q/k/v/o/lse: at
// the tensor cores' 989 TFLOP/s the operations bound it (~0.04 ms).  This
// first kernel runs both products as plain fp32 FMAs out of shared memory
// (67 TFLOP/s), so its own bound is ~0.5 ms; wgmma and TMA come later.
//
// What the design does about it:
// - walk, don't grid: one CUDA block owns (batch*head, query rows of one
//   sparsity block row), reads that row's count once and loops over
//   exactly that many LUT entries, where the TPU grid ran `width` steps for
//   every row and skipped the compute past `nvalid`;
// - templated on the sparsity block (16, 32, 64, 128): a block owns
//   min(block, 64) query rows with four threads each (64-256 threads), so
//   small blocks give many small CUDA blocks resident together on an SM
//   rather than one block idling three quarters of its threads;
// - the query row lives in registers; each active key block is staged in
//   tiles of min(block, 32) keys (fp32, rows padded to 65 floats) read by
//   every row of the CUDA block;
// - the LUT and its counts stay in device memory (uploaded once per
//   sequence length by the wrapper): no table size limit, so the TPU's
//   SMEM guard on the LUT does not apply.
#include "block_sparse_common.cuh"

namespace {

using namespace block_sparse;

template <typename T, int BLOCK>
__global__ void __launch_bounds__(Tile<BLOCK>::THREADS)
block_sparse_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ o,
                        float* __restrict__ lse, Lut lut, int t, float scale) {
  using G = Tile<BLOCK>;
  __shared__ float ks[G::KT][D + 1];
  __shared__ float vs[G::KT][D + 1];
  __shared__ float ps[G::ROWS][G::KT + 1];

  const int bh = blockIdx.y;
  const int r = blockIdx.x / G::SUB;  // query block row
  const int tid = threadIdx.x;
  const int row = tid >> 2;
  const int cg = tid & 3;
  const int qi = blockIdx.x * G::ROWS + row;  // t % BLOCK == 0: always live
  const int plane = lut_plane(bh, lut);
  const int n = lut_count(plane, r, lut);

  const T* kb = k + (size_t)bh * t * D;
  const T* vb = v + (size_t)bh * t * D;
  const size_t qoff = ((size_t)bh * t + qi) * D;

  float qr[D];
#pragma unroll
  for (int d = 0; d < D; ++d) qr[d] = n > 0 ? to_f(q[qoff + d]) : 0.f;

  float acc[G::OPT];
#pragma unroll
  for (int j = 0; j < G::OPT; ++j) acc[j] = 0.f;
  float m = NEG_INF, l = 0.f;

  for (int w = 0; w < n; ++w) {
    const int c = lut_entry(plane, r, w, lut);
    for (int sub = 0; sub < G::NT; ++sub) {
      __syncthreads();  // every warp is done with the previous tile
      stage2<T, G::KT, D + 1, G::THREADS>(ks, vs, kb, vb, c * BLOCK + sub * G::KT);
      __syncthreads();

      float s[G::CPT];
      float mt = NEG_INF;
#pragma unroll
      for (int j = 0; j < G::CPT; ++j) {
        const int col = cg + 4 * j;
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) dot = fmaf(qr[d], ks[col][d], dot);
        s[j] = dot * scale;
        mt = fmaxf(mt, s[j]);
      }
      const float m_new = fmaxf(m, row_max(mt));
      const float alpha = expf(m - m_new);
      float lsum = 0.f;
#pragma unroll
      for (int j = 0; j < G::CPT; ++j) {
        const float p = expf(s[j] - m_new);
        lsum += p;
        ps[row][cg + 4 * j] = p;
      }
      l = alpha * l + row_sum(lsum);
      m = m_new;
      __syncwarp();  // the row's p values come from the same warp

#pragma unroll
      for (int j = 0; j < G::OPT; ++j) acc[j] *= alpha;
#pragma unroll 4
      for (int col = 0; col < G::KT; ++col) {
        const float p = ps[row][col];
#pragma unroll
        for (int j = 0; j < G::OPT; ++j) acc[j] = fmaf(p, vs[col][cg + 4 * j], acc[j]);
      }
    }
  }

  // a row with no active block: acc = 0, l = 0 -> O = 0, lse = -1e30
  const float l_safe = (l == 0.f) ? 1.f : l;
  T* ob = o + qoff;
#pragma unroll
  for (int j = 0; j < G::OPT; ++j) ob[cg + 4 * j] = from_f<T>(acc[j] / l_safe);
  if (cg == 0) lse[(size_t)bh * t + qi] = (l == 0.f) ? NEG_INF : m + logf(l_safe);
}

template <typename T, int BLOCK>
void launch(const void* q, const void* k, const void* v, void* o, void* lse,
            const Lut& lut, int bh, int t, float scale, cudaStream_t st) {
  using G = Tile<BLOCK>;
  const dim3 grid(lut.nb * G::SUB, bh);
  block_sparse_fwd_kernel<T, BLOCK><<<grid, G::THREADS, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), lut, t, scale);
}

}  // namespace

// dtype: 0 fp32, 1 bf16, 2 fp16; block: 16, 32, 64 or 128.  q/k/v/o are
// [bh, t, 64] (t a multiple of block), lse [bh, t] fp32, cols [lut_heads,
// t / block, width] and nvalid [lut_heads, t / block] int32, all
// contiguous on one device.  Returns cudaGetLastError().
extern "C" int block_sparse_fwd(const void* q, const void* k, const void* v, void* o,
                                void* lse, const void* cols, const void* nvalid,
                                int bh, int heads, int lut_heads, int t, int block,
                                int width, float scale, int dtype, void* stream) {
  const Lut lut{static_cast<const int*>(cols), static_cast<const int*>(nvalid), heads,
                lut_heads, t / block, width};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  BLOCK_SPARSE_DISPATCH(launch, q, k, v, o, lse, lut, bh, t, scale, st)
  return static_cast<int>(cudaGetLastError());
}
