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
// cores' rate (~0.07 ms); at mma.sync's rate ~0.2-0.6 ms.  The layouts are
// uneven: with the Fixed layout the 64 global key blocks of 256 walk 256
// query blocks each while the others walk 4, so the heaviest CUDA blocks
// set the kernel's time.
//
// What the design does about it (bf16 and fp16, block_sparse_mma.cuh):
// - key-stationary warps: a CUDA block of four warps owns 64 key rows of
//   one group of 64 / min(block, 64) key blocks (`build_group_luts`: key
//   blocks ordered by their query count, heaviest first, identical columns
//   side by side), each warp 16 keys of one member, its K and V tiles
//   staged once in shared memory and read as A fragments at each entry
//   (held in registers they cost ~45 registers a thread, and at block 16
//   the Fixed layout's heavy groups would then need two waves);
// - the CUDA block walks the union of its members' query blocks; each
//   entry's Q and dO tiles and its lse and delta rows come once through a
//   3-stage cp.async ring for all four warps, and a warp whose member bit
//   is clear skips the entry, so each warp sees exactly its own `rows_t`
//   row; the grid launches the heaviest groups of every head first;
// - per 16 queries, on mma.sync m16n8k16 with fp32 accumulators:
//   S^T = K.Q^T and dP^T = V.dO^T (Q and dO through ldmatrix), then
//   P~^T = exp2(S^T scale log2 e - lse log2 e) and dS^T = P~^T (dP^T -
//   delta) scale on the C fragments, lse and delta read per column, then
//   dV += P~^T.dO and dK += dS^T.Q with P~^T and dS^T as A fragments from
//   registers and dO and Q through ldmatrix.trans;
// - P~ and dS are rounded once to the input type, as the JAX kernel's
//   `p.astype(do.dtype)` and `ds.astype(q.dtype)` do: the gradients are
//   held to 2e-2 of their largest magnitude, which that meets
//   (tests/test_torch_block_sparse_rounding.py);
// - no atomics: each warp writes its own 16 rows of dK and dV once, exact
//   zeros for a key block no query attends to (its bits are all clear);
//   a query row with no active block never appears in a union entry of a
//   member that uses it, so its lse of -1e30 is never read.
//
// The fp32 arm keeps the first kernel below (plain fp32 FMAs, one CUDA
// block per key block of up to 64 rows, walking the transposed LUT): the
// tensor cores would take fp32 only as TF32, and the fp32 arm is held to
// 1e-4 of the plain version.
#include "block_sparse_mma.cuh"

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

namespace tc {

using namespace block_sparse::mma;

// a stage: the Q tile, the dO tile, then KT fp32 lse and KT fp32 delta
template <int BLOCK>
struct Stage {
  static constexpr int KT = Geo<BLOCK>::KT;
  static constexpr int DO = Geo<BLOCK>::TILE_BYTES;
  static constexpr int LSE = 2 * DO;
  static constexpr int DELTA = LSE + KT * 4;
  static constexpr int BYTES = DELTA + KT * 4;  // a multiple of 128
};

// shared memory past the ring: each warp's K and V tiles, 16 rows each
constexpr int KV_BYTES = WARPS * 2 * 16 * ROW_BYTES;

// Four CUDA blocks an SM at block 16, so every head's heavy groups start
// in one wave (at [2, 16, 4096, 64] the Fixed layout's 512 heavy groups
// against 132 x 4 slots; at the ~170 registers of K and V held as
// fragments, two): registers capped at 128, K and V read as fragments from
// shared memory at each entry.
template <int BLOCK>
constexpr int MIN_BLOCKS = BLOCK == 16 ? 4 : 1;

// one 16-query chunk (rows r0.. of the stage's tiles) of a warp's dK/dV
template <typename T>
__device__ __forceinline__ void dkv_chunk(const uint32_t (&ka)[4][4],
                                          const uint32_t (&va)[4][4], uint32_t qt,
                                          uint32_t dot, const float* lse_s,
                                          const float* delta_s, int r0, float scale,
                                          float scale2, float (&dk)[8][4],
                                          float (&dv)[8][4], int lane) {
  float s[2][4] = {}, dp[2][4] = {};
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    uint32_t b[4];
    frag_b_rows(b, qt, r0, ks, lane);
    mma16816<T>(s[0], ka[ks], b[0], b[1]);
    mma16816<T>(s[1], ka[ks], b[2], b[3]);
    frag_b_rows(b, dot, r0, ks, lane);
    mma16816<T>(dp[0], va[ks], b[0], b[1]);
    mma16816<T>(dp[1], va[ks], b[2], b[3]);
  }
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    const int col = r0 + 8 * n + (lane & 3) * 2;  // this thread's queries
    const float2 ls = *reinterpret_cast<const float2*>(lse_s + col);
    const float2 de = *reinterpret_cast<const float2*>(delta_s + col);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float p = ex2(s[n][i] * scale2 - ((i & 1) ? ls.y : ls.x) * LOG2E);
      s[n][i] = p;
      dp[n][i] = p * (dp[n][i] - ((i & 1) ? de.y : de.x)) * scale;
    }
  }
  uint32_t pa[4], dsa[4];
  pack_a<T>(pa, s);
  pack_a<T>(dsa, dp);
#pragma unroll
  for (int dn = 0; dn < 4; ++dn) {
    uint32_t b[4];
    frag_b_cols(b, dot, r0, dn, lane);
    mma16816<T>(dv[2 * dn], pa, b[0], b[1]);
    mma16816<T>(dv[2 * dn + 1], pa, b[2], b[3]);
    frag_b_cols(b, qt, r0, dn, lane);
    mma16816<T>(dk[2 * dn], dsa, b[0], b[1]);
    mma16816<T>(dk[2 * dn + 1], dsa, b[2], b[3]);
  }
}

template <typename T, int BLOCK>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS<BLOCK>)
block_sparse_dkv_mma(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dk, T* __restrict__ dv, Groups gr, int t,
                     float scale) {
  using C = Geo<BLOCK>;
  using S = Stage<BLOCK>;
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t ring = smem_u32(smem);

  const int bh = blockIdx.x;
  const int grp = blockIdx.y / C::NT;
  const int half = blockIdx.y % C::NT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int member = warp / C::WPM;
  const size_t g = group_row(bh, grp, gr);
  const int kblock = gr.keys[g * C::G + member];  // -1: no such member
  const int k0 = kblock * BLOCK + half * 64 + (warp % C::WPM) * 16;
  const int* idx = gr.idx + g * gr.width;
  const int* msk = gr.mask + g * gr.width;
  const int steps = gr.count[g] * C::NT;
  const T* qb = q + (size_t)bh * t * D;
  const T* db = dout + (size_t)bh * t * D;
  const float* lb = lse + (size_t)bh * t;
  const float* eb = delta + (size_t)bh * t;

  auto issue = [&](int s) {
    if (s < steps) {
      const int r0 = idx[s / C::NT] * BLOCK + (s % C::NT) * C::KT;
      const uint32_t st = ring + (s % STAGES) * S::BYTES;
      load_tile<C::KT>(st, qb + (size_t)r0 * D, tid);
      load_tile<C::KT>(st + S::DO, db + (size_t)r0 * D, tid);
      constexpr int CH = C::KT / 4;  // 16-byte chunks of one fp32 row
      if (tid < CH)
        cp_async16(st + S::LSE + 16 * tid, lb + r0 + 4 * tid);
      else if (tid < 2 * CH)
        cp_async16(st + S::DELTA + 16 * (tid - CH), eb + r0 + 4 * (tid - CH));
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };
  // this warp's K and V tiles join the first copy group
  const uint32_t kt = ring + STAGES * S::BYTES + warp * 2 * 16 * ROW_BYTES;
  const uint32_t vt = kt + 16 * ROW_BYTES;
  if (kblock >= 0) {
    const size_t off = ((size_t)bh * t + k0) * D;
    for (int i = lane; i < 16 * 8; i += 32) {
      const int r = i >> 3, c = i & 7;
      cp_async16(kt + swz(r, c), k + off + r * D + c * 8);
      cp_async16(vt + swz(r, c), v + off + r * D + c * 8);
    }
  }
  for (int s = 0; s < STAGES - 1; ++s) issue(s);
  float dka[8][4] = {}, dva[8][4] = {};
  const float scale2 = scale * LOG2E;

  for (int s = 0; s < steps; ++s) {
    const bool mine = kblock >= 0 && ((msk[s / C::NT] >> member) & 1);
    cp_async_wait<STAGES - 2>();  // this thread's copies of stage s landed
    __syncthreads();  // everyone's have, and stage s - 1 is released
    issue(s + STAGES - 1);  // into the slot of stage s - 1
    if (mine) {
      uint32_t ka[4][4], va[4][4];
      frag_a_smem(ka, kt, lane);
      frag_a_smem(va, vt, lane);
      const uint32_t st = ring + (s % STAGES) * S::BYTES;
      const float* stats = reinterpret_cast<const float*>(
          smem + (s % STAGES) * S::BYTES + S::LSE);
#pragma unroll
      for (int qc = 0; qc < C::KT; qc += 16)
        dkv_chunk<T>(ka, va, st, st + S::DO, stats, stats + C::KT, qc, scale,
                     scale2, dka, dva, lane);
    }
  }
  if (kblock < 0) return;

  const float one[2] = {1.f, 1.f};
  const size_t off = ((size_t)bh * t + k0) * D;
  store_rows(dk + off, dka, one, lane);
  store_rows(dv + off, dva, one, lane);
}

template <typename T, int BLOCK>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dk, void* dv, const Groups& gr,
           int bh, int t, float scale, cudaStream_t st) {
  using C = Geo<BLOCK>;
  const int bytes = STAGES * Stage<BLOCK>::BYTES + KV_BYTES;
  const int rc = allow_smem(block_sparse_dkv_mma<T, BLOCK>, bytes);
  if (rc != 0) return rc;
  // batch*head fastest: every head's heaviest groups launch first
  const dim3 grid(bh, gr.ng * C::NT);
  block_sparse_dkv_mma<T, BLOCK><<<grid, THREADS, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), gr,
      t, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

// dtype: 0 fp32 (the FMA kernel over the transposed LUT), 1 bf16, 2 fp16
// (the tensor-core kernel over the group tables); block: 16, 32, 64 or
// 128.  q/k/v/dout/dk/dv are [bh, t, 64], lse/delta [bh, t] fp32, rows_t
// [lut_heads, t / block, width] and nvalid_t [lut_heads, t / block] int32
// (the transposed LUT), g_idx/g_mask [lut_heads, ng, g_width], g_count
// [lut_heads, ng] and g_keys [lut_heads, ng, 64 / min(block, 64)] int32
// (`build_group_luts`'s dK/dV tables), all contiguous on one device.
// Returns a CUDA error code (cudaGetLastError() after the launch).
extern "C" int block_sparse_bwd_dkv(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse,
                                    const void* delta, void* dk, void* dv,
                                    const void* rows_t, const void* nvalid_t,
                                    const void* g_idx, const void* g_mask,
                                    const void* g_count, const void* g_keys, int bh,
                                    int heads, int lut_heads, int t, int block,
                                    int width, int ng, int g_width, float scale,
                                    int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != 0) {
    const block_sparse::mma::Groups gr{
        static_cast<const int*>(g_idx), static_cast<const int*>(g_mask),
        static_cast<const int*>(g_count), static_cast<const int*>(g_keys), heads,
        lut_heads, ng, g_width};
    BLOCK_SPARSE_DISPATCH_TC(tc::launch, q, k, v, dout, lse, delta, dk, dv, gr, bh, t,
                             scale, st)
  }
  const Lut lut{static_cast<const int*>(rows_t), static_cast<const int*>(nvalid_t),
                heads, lut_heads, t / block, width};
  BLOCK_SPARSE_DISPATCH_FP32(launch, q, k, v, dout, lse, delta, dk, dv, lut, bh, t,
                             scale, st)
  return static_cast<int>(cudaGetLastError());
}
