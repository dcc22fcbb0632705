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
// the tensor cores' 989 TFLOP/s the operations bound it (~0.04 ms).  P.V
// runs twice (P as hi + lo, below), so the tensor cores do ~54 GFLOP; at
// mma.sync's rate (well under wgmma's) that is ~0.1-0.3 ms.  Without the
// group's shared ring each warp would read a 4 KB K+V tile per 65 kFLOP of
// its own, ~16 FLOP a byte of L2, and L2 would bound it near 0.4 ms.
//
// What the design does about it (bf16 and fp16, block_sparse_mma.cuh):
// - one CUDA block of four warps per (batch*head, group): a group is the
//   64 query rows of 64 / min(block, 64) consecutive block rows (half of a
//   row at block 128), one 16-row m16 tile per warp, Q held in registers
//   as A fragments;
// - the CUDA block walks the group's union of active key blocks
//   (`build_group_luts`), ascending; each union entry's K and V tiles come
//   once through a 3-stage cp.async ring for all four warps, and a warp
//   whose member bit is clear skips the entry's products, so every warp
//   sees exactly its own LUT row in the JAX grid's order;
// - S = Q.K^T and O += P.V run on mma.sync m16n8k16 with fp32
//   accumulators, K and V through ldmatrix (V transposed) from swizzled
//   tiles; the online softmax runs on S's C fragment in registers (exp2,
//   the scale folded into log2 e), and P feeds P.V from registers;
// - P enters P.V as two terms in the input type, hi = round(p) and
//   lo = round(p - hi), as csrc/flash_fwd.cu does: one rounding (the JAX
//   kernel's `p.astype(v.dtype)`) moves the output past one bf16 ulp of
//   the fp32 result (tests/test_torch_block_sparse_rounding.py);
// - a member whose row has no active block never runs a product: l stays
//   0 and it writes O = 0, lse = -1e30.
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

namespace tc {

using namespace block_sparse::mma;

// one 16-key chunk (rows kc*16.. of the stage's K and V tiles) of a warp's
// online softmax: S = Q.K^T, rescale, P = exp2(S - m), O += (P_hi + P_lo).V
template <typename T>
__device__ __forceinline__ void fwd_chunk(const uint32_t (&qa)[4][4], uint32_t kt,
                                          uint32_t vt, int r0, float scale2,
                                          float (&m)[2], float (&l)[2],
                                          float (&acc)[8][4], int lane) {
  float s[2][4] = {};
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    uint32_t b[4];
    frag_b_rows(b, kt, r0, ks, lane);
    mma16816<T>(s[0], qa[ks], b[0], b[1]);
    mma16816<T>(s[1], qa[ks], b[2], b[3]);
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s[n][i] *= scale2;
      mx[i >> 1] = fmaxf(mx[i >> 1], s[n][i]);
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
  float lo[2][4];
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float p = ex2(s[n][i] - m[i >> 1]);
      l[i >> 1] += p;
      s[n][i] = p;
    }
  uint32_t phi[4], plo[4];
  pack_a<T>(phi, s);
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int i = 0; i < 4; i += 2) {
      const float2 hv = unpack2<T>(phi[2 * n + (i >> 1)]);
      lo[n][i] = s[n][i] - hv.x;
      lo[n][i + 1] = s[n][i + 1] - hv.y;
    }
  pack_a<T>(plo, lo);
#pragma unroll
  for (int dt = 0; dt < 8; ++dt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[dt][i] *= alpha[i >> 1];
#pragma unroll
  for (int dn = 0; dn < 4; ++dn) {
    uint32_t b[4];
    frag_b_cols(b, vt, r0, dn, lane);
    mma16816<T>(acc[2 * dn], phi, b[0], b[1]);
    mma16816<T>(acc[2 * dn], plo, b[0], b[1]);
    mma16816<T>(acc[2 * dn + 1], phi, b[2], b[3]);
    mma16816<T>(acc[2 * dn + 1], plo, b[2], b[3]);
  }
}

template <typename T, int BLOCK>
__global__ void __launch_bounds__(THREADS)
block_sparse_fwd_mma(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, Groups gr, int t, float scale) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const RowWalk<BLOCK> w(gr, t, warp);

  uint32_t qa[4][4] = {};
  if (w.live) frag_a_global(qa, q + w.row0 * D, lane);
  float acc[8][4] = {};
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  const float scale2 = scale * LOG2E;

  walk_kv(w, smem_u32(smem), k + (size_t)w.bh * t * D, v + (size_t)w.bh * t * D,
          tid, [&](uint32_t kt) {
#pragma unroll
            for (int kc = 0; kc < Geo<BLOCK>::KT; kc += 16)
              fwd_chunk<T>(qa, kt, kt + Geo<BLOCK>::TILE_BYTES, kc, scale2, m, l,
                           acc, lane);
          });
  if (!w.live) return;

  // the row sums live in the four threads of a row
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    inv[h] = l[h] == 0.f ? 0.f : 1.f / l[h];  // a row with no active block
  }
  store_rows(o + w.row0 * D, acc, inv, lane);
  if ((lane & 3) == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      lse[w.row0 + (lane >> 2) + 8 * h] =
          l[h] == 0.f ? NEG_INF : (m[h] + log2f(l[h])) * LN2;
  }
}

template <typename T, int BLOCK>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           const Groups& gr, int bh, int t, float scale, cudaStream_t st) {
  using C = Geo<BLOCK>;
  const int bytes = STAGES * 2 * C::TILE_BYTES;
  const int rc = allow_smem(block_sparse_fwd_mma<T, BLOCK>, bytes);
  if (rc != 0) return rc;
  // batch*head fastest: the launch order runs over every head's group 0
  // first
  const dim3 grid(bh, gr.ng * C::NT);
  block_sparse_fwd_mma<T, BLOCK><<<grid, THREADS, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), gr, t, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

// dtype: 0 fp32 (the FMA kernel over the row LUT), 1 bf16, 2 fp16 (the
// tensor-core kernel over the group tables); block: 16, 32, 64 or 128.
// q/k/v/o are [bh, t, 64] (t a multiple of block), lse [bh, t] fp32, cols
// [lut_heads, t / block, width] and nvalid [lut_heads, t / block] int32,
// g_idx/g_mask [lut_heads, ng, g_width] and g_count [lut_heads, ng] int32
// (`build_group_luts`'s forward tables), all contiguous on one device.
// Returns a CUDA error code (cudaGetLastError() after the launch).
extern "C" int block_sparse_fwd(const void* q, const void* k, const void* v, void* o,
                                void* lse, const void* cols, const void* nvalid,
                                const void* g_idx, const void* g_mask,
                                const void* g_count, int bh, int heads,
                                int lut_heads, int t, int block, int width, int ng,
                                int g_width, float scale, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != 0) {
    const block_sparse::mma::Groups gr{
        static_cast<const int*>(g_idx), static_cast<const int*>(g_mask),
        static_cast<const int*>(g_count), nullptr, heads, lut_heads, ng, g_width};
    BLOCK_SPARSE_DISPATCH_TC(tc::launch, q, k, v, o, lse, gr, bh, t, scale, st)
  }
  const Lut lut{static_cast<const int*>(cols), static_cast<const int*>(nvalid), heads,
                lut_heads, t / block, width};
  BLOCK_SPARSE_DISPATCH_FP32(launch, q, k, v, o, lse, lut, bh, t, scale, st)
  return static_cast<int>(cudaGetLastError());
}
