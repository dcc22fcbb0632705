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
// 6 * 64 flops a pair.  At [2, 16, 4096, 64] with the Fixed layout (block
// 16, density 0.262) that is ~55 GFLOP against ~85 MB of
// q/k/v/dO/lse/delta/dQ: at the tensor cores' 989 TFLOP/s the operations
// bound it, 0.05456 ms.  At mma.sync's rate (the forward's three products'
// worth ran at ~183 TFLOP/s) that is ~0.3 ms.
//
// What the design does about it (bf16 and fp16, block_sparse_mma.cuh):
// - the forward's walk: one CUDA block of four warps per (batch*head,
//   group), a group being the 64 query rows of 64 / min(block, 64)
//   consecutive block rows (half of a row at block 128), one 16-row m16
//   tile per warp; the block streams the group's union of active key blocks
//   (`build_group_luts`' forward tables) once through the forward's 3-stage
//   cp.async ring (`walk_kv`), and a warp whose member bit is clear skips
//   the entry, so every warp sees exactly its own LUT row;
// - Q and dO of a warp's rows live in registers as A fragments, lse and
//   delta of a thread's two rows as fp32; the block owns its dQ rows, so no
//   atomics;
// - S = Q.K^T and dP = dO.V^T on mma.sync m16n8k16 with fp32 accumulators
//   (K and V through ldmatrix), P = exp2(S * scale * log2 e - lse * log2 e)
//   and dS = P (dP - delta) scale on the C fragments, dS rounded once to the
//   input type (the JAX kernel's `ds.astype(k.dtype)`) and packed into A
//   fragments, then dQ += dS.K with K read a second time from the same ring
//   tile, transposed by ldmatrix: no extra load;
// - a member with no active block never runs a product and writes exact
//   zeros (its lse, -1e30 from the forward, is never used).
//
// The fp32 arm keeps the first kernel below (plain fp32 FMAs out of shared
// memory, one CUDA block per block row of up to 64 rows, four threads a
// row, walking the row LUT): the tensor cores would take fp32 only as TF32,
// and the fp32 arm is held to 1e-4 of the plain version.
#include "block_sparse_mma.cuh"

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

namespace tc {

using namespace block_sparse::mma;

// one 16-key chunk (rows r0.. of the stage's K and V tiles) of a warp's dQ:
// S = Q.K^T, dP = dO.V^T, P, dS rounded once, dQ += dS.K.  lse2: the
// thread's two rows' lse times log2 e; de: their delta.
template <typename T>
__device__ __forceinline__ void dq_chunk(const uint32_t (&qa)[4][4],
                                         const uint32_t (&da)[4][4], uint32_t kt,
                                         uint32_t vt, int r0, const float (&lse2)[2],
                                         const float (&de)[2], float scale,
                                         float scale2, float (&acc)[8][4],
                                         int lane) {
  float s[2][4] = {}, dp[2][4] = {};
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    uint32_t b[4];
    frag_b_rows(b, kt, r0, ks, lane);
    mma16816<T>(s[0], qa[ks], b[0], b[1]);
    mma16816<T>(s[1], qa[ks], b[2], b[3]);
    frag_b_rows(b, vt, r0, ks, lane);
    mma16816<T>(dp[0], da[ks], b[0], b[1]);
    mma16816<T>(dp[1], da[ks], b[2], b[3]);
  }
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float p = ex2(s[n][i] * scale2 - lse2[i >> 1]);
      dp[n][i] = p * (dp[n][i] - de[i >> 1]) * scale;
    }
  uint32_t dsa[4];
  pack_a<T>(dsa, dp);
#pragma unroll
  for (int dn = 0; dn < 4; ++dn) {
    uint32_t b[4];
    frag_b_cols(b, kt, r0, dn, lane);
    mma16816<T>(acc[2 * dn], dsa, b[0], b[1]);
    mma16816<T>(acc[2 * dn + 1], dsa, b[2], b[3]);
  }
}

template <typename T, int BLOCK>
__global__ void __launch_bounds__(THREADS)
block_sparse_dq_mma(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, Groups gr, int t, float scale) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const RowWalk<BLOCK> w(gr, t, warp);

  uint32_t qa[4][4] = {}, da[4][4] = {};
  float lse2[2] = {}, de[2] = {};
  if (w.live) {
    frag_a_global(qa, q + w.row0 * D, lane);
    frag_a_global(da, dout + w.row0 * D, lane);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const size_t row = w.row0 + (lane >> 2) + 8 * h;
      lse2[h] = lse[row] * LOG2E;
      de[h] = delta[row];
    }
  }
  float acc[8][4] = {};
  const float scale2 = scale * LOG2E;

  walk_kv(w, smem_u32(smem), k + (size_t)w.bh * t * D, v + (size_t)w.bh * t * D,
          tid, [&](uint32_t kt) {
#pragma unroll
            for (int kc = 0; kc < Geo<BLOCK>::KT; kc += 16)
              dq_chunk<T>(qa, da, kt, kt + Geo<BLOCK>::TILE_BYTES, kc, lse2, de,
                          scale, scale2, acc, lane);
          });
  if (!w.live) return;

  // a member with no active block ran no product: exact zeros
  const float one[2] = {1.f, 1.f};
  store_rows(dq + w.row0 * D, acc, one, lane);
}

template <typename T, int BLOCK>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dq, const Groups& gr, int bh,
           int t, float scale, cudaStream_t st) {
  using C = Geo<BLOCK>;
  const int bytes = STAGES * 2 * C::TILE_BYTES;
  const int rc = allow_smem(block_sparse_dq_mma<T, BLOCK>, bytes);
  if (rc != 0) return rc;
  // batch*head fastest, as the forward
  const dim3 grid(bh, gr.ng * C::NT);
  block_sparse_dq_mma<T, BLOCK><<<grid, THREADS, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq), gr, t, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

// dtype: 0 fp32 (the FMA kernel over the row LUT), 1 bf16, 2 fp16 (the
// tensor-core kernel over the forward's group tables); block: 16, 32, 64 or
// 128.  q/k/v/dout/dq are [bh, t, 64], lse/delta [bh, t] fp32, cols
// [lut_heads, t / block, width] and nvalid [lut_heads, t / block] int32,
// g_idx/g_mask [lut_heads, ng, g_width] and g_count [lut_heads, ng] int32
// (`build_group_luts`' forward tables), all contiguous on one device.
// Returns a CUDA error code (cudaGetLastError() after the launch).
extern "C" int block_sparse_bwd_dq(const void* q, const void* k, const void* v,
                                   const void* dout, const void* lse,
                                   const void* delta, void* dq, const void* cols,
                                   const void* nvalid, const void* g_idx,
                                   const void* g_mask, const void* g_count, int bh,
                                   int heads, int lut_heads, int t, int block,
                                   int width, int ng, int g_width, float scale,
                                   int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != 0) {
    const block_sparse::mma::Groups gr{
        static_cast<const int*>(g_idx), static_cast<const int*>(g_mask),
        static_cast<const int*>(g_count), nullptr, heads, lut_heads, ng, g_width};
    BLOCK_SPARSE_DISPATCH_TC(tc::launch, q, k, v, dout, lse, delta, dq, gr, bh, t,
                             scale, st)
  }
  const Lut lut{static_cast<const int*>(cols), static_cast<const int*>(nvalid), heads,
                lut_heads, t / block, width};
  BLOCK_SPARSE_DISPATCH_FP32(launch, q, k, v, dout, lse, delta, dq, lut, bh, t, scale,
                             st)
  return static_cast<int>(cudaGetLastError());
}
