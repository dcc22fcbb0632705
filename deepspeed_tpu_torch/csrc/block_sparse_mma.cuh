// Tensor-core building blocks of the bf16/fp16 block-sparse kernels
// (block_sparse_fwd.cu, block_sparse_bwd_dq.cu and block_sparse_bwd_dkv.cu)
// and of the multi-query decode kernel (decode_multi.cu): the grouped
// lookup tables a CUDA block walks, a cp.async ring of row tiles in shared
// memory (the forward's and dQ's K/V walk, `walk_kv`), and warp-level
// mma.sync m16n8k16 with fp32 accumulators fed by ldmatrix.
//
// Why warp-level mma.sync and not wgmma: a warp owns 16 rows, exactly one
// block-16 row of the layout, so it walks exactly its own LUT row and
// multiplies nothing the layout leaves out, at every block size.  wgmma
// needs 64-row A tiles, which at block 16 span four block rows with four
// different LUT rows.
//
// Why a group of warps shares one ring: a CUDA block of four warps (64 rows:
// four block rows at block 16, two at 32, one at 64, half of one at 128)
// streams the union of its members' LUT rows once, and each warp skips the
// entries its member bit is clear on (the tables are built on the host by
// ops/kernels/block_sparse_attention.py `build_group_luts`).  Where rows
// share their entries, as the Fixed layout's windows do, a tile is read
// once for four warps.
//
// Why cp.async and not TMA: a stage is one 16- to 64-row tile per operand
// (2-8 KB), which 128 threads move with one to four 16-byte copies each;
// the dK/dV ring carries two fp32 rows (lse, delta) beside its tiles, in
// the same copy group; and with one __syncthreads per stage no warp can
// wait on a barrier phase that a warp skipping the entry never arrives at.
//
// Layout rules:
// - a tile row is 64 values of 2 bytes, 128 bytes = eight 16-byte chunks;
//   chunk c of row r sits at chunk c ^ (r % 8) (the 128-byte XOR swizzle),
//   so the eight rows an ldmatrix phase reads hit eight distinct chunks,
//   all 32 banks;
// - the m16n8k16 C fragment of a thread holds rows lane/4 and lane/4 + 8,
//   columns 2*(lane%4) + {0, 1} of an n8 tile; two n8 tiles' C fragments,
//   packed in pairs, are the A fragment of one k16 step (how P, P^T and
//   dS^T feed the next product from registers).
#pragma once

#include "block_sparse_common.cuh"
#include "flash_sm90.cuh"

namespace block_sparse {
namespace mma {

using flash::sm90::allow_smem;
using flash::sm90::ex2;
using flash::sm90::LN2;
using flash::sm90::LOG2E;
using flash::sm90::pack2;
using flash::sm90::smem_u32;
using flash::sm90::unpack2;

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int ROW_BYTES = D * 2;  // one bf16/fp16 row
constexpr int STAGES = 3;         // depth of the ring

// CUDA-block geometry of sparsity block BLOCK:
//   KT   rows of a ring stage, and rows of one member in the CUDA block
//        (min(BLOCK, 64));
//   NT   stages per union entry, and CUDA blocks per group (2 at block
//        128: each owns half of the block's rows);
//   G    members (sparsity blocks) per group;
//   WPM  warps per member.
template <int BLOCK>
struct Geo {
  static_assert(BLOCK == 16 || BLOCK == 32 || BLOCK == 64 || BLOCK == 128,
                "block must be 16, 32, 64 or 128");
  static constexpr int KT = BLOCK < 64 ? BLOCK : 64;
  static constexpr int NT = BLOCK / KT;
  static constexpr int G = 64 / KT;
  static constexpr int WPM = WARPS / G;
  static constexpr int TILE_BYTES = KT * ROW_BYTES;
};

// One group's tables: union entries, member bits, the union's size and
// (dK/dV) the member key blocks, from `build_group_luts` planes
// [lut_heads, ng, width] / [lut_heads, ng] / [lut_heads, ng, G].
struct Groups {
  const int* idx;
  const int* mask;
  const int* count;
  const int* keys;  // nullptr for the forward: its members are rows gG + j
  int heads;
  int lut_heads;
  int ng;
  int width;
};

// the (plane, group) row of batch*head bh's group g
__device__ __forceinline__ size_t group_row(int bh, int g, const Groups& gr) {
  const int plane = gr.lut_heads > 1 ? bh % gr.heads : 0;
  return (size_t)plane * gr.ng + g;
}

// byte offset of chunk c (8 values) of row r in a swizzled tile
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return r * ROW_BYTES + ((c ^ (r & 7)) << 4);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}
// the same copy, of the first `bytes` (0 or 16) bytes; the rest of the 16
// are written as zeros
__device__ __forceinline__ void cp_async16_zfill(uint32_t dst, const void* src,
                                                 int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows [0, ROWS) of a [*, 64] operand (src: its row 0) into a swizzled tile
template <int ROWS, typename T>
__device__ __forceinline__ void load_tile(uint32_t dst, const T* src, int tid) {
  static_assert(ROWS * 8 % THREADS == 0, "whole copies per thread");
#pragma unroll
  for (int i = tid; i < ROWS * 8; i += THREADS) {
    const int r = i >> 3, c = i & 7;
    cp_async16(dst + swz(r, c), src + r * D + c * 8);
  }
}

// rows [0, ROWS) of a [*, 64] operand into a swizzled tile, rows at or
// past `live` as zeros (their source is never read)
template <int ROWS, typename T>
__device__ __forceinline__ void load_tile_live(uint32_t dst, const T* src, int live,
                                               int tid) {
  static_assert(ROWS * 8 % THREADS == 0, "whole copies per thread");
#pragma unroll
  for (int i = tid; i < ROWS * 8; i += THREADS) {
    const int r = i >> 3, c = i & 7;
    const bool in = r < live;
    cp_async16_zfill(dst + swz(r, c), src + (in ? r * D + c * 8 : 0), in ? 16 : 0);
  }
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// B fragments of a product reducing along a tile row (K for Q.K^T, Q for
// K.Q^T, dO for V.dO^T): k16 step ks, rows r0..r0+15 as two n8 tiles,
// (b[0], b[1]) for rows r0..r0+7 and (b[2], b[3]) for rows r0+8..r0+15
__device__ __forceinline__ void frag_b_rows(uint32_t (&b)[4], uint32_t tile, int r0,
                                            int ks, int lane) {
  const int mi = lane >> 3;
  ldsm4(b, tile + swz(r0 + ((mi >> 1) << 3) + (lane & 7), 2 * ks + (mi & 1)));
}

// B fragments of a product reducing down the tile's rows r0..r0+15 (V for
// P.V, dO for P^T.dO, Q for dS^T.Q): columns 16*dn..16*dn+15 as two n8
// tiles, (b[0], b[1]) and (b[2], b[3])
__device__ __forceinline__ void frag_b_cols(uint32_t (&b)[4], uint32_t tile, int r0,
                                            int dn, int lane) {
  const int mi = lane >> 3;
  ldsm4_t(b, tile + swz(r0 + ((mi & 1) << 3) + (lane & 7), 2 * dn + (mi >> 1)));
}

// The A fragments of a [16, 64] swizzled tile in shared memory, one per
// k16 step: dK/dV's K and V
__device__ __forceinline__ void frag_a_smem(uint32_t (&a)[4][4], uint32_t tile,
                                            int lane) {
  const int mi = lane >> 3;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    ldsm4(a[ks], tile + swz(((mi & 1) << 3) + (lane & 7), 2 * ks + (mi >> 1)));
}

// The A fragments of a [16, 64] row-major operand in device memory (src:
// its row 0), one per k16 step: the forward's Q, dQ's Q and dO; rows at or
// past `rows` are zeros and never read (decode_multi's W rows padded to 16).
template <typename T>
__device__ __forceinline__ void frag_a_global(uint32_t (&a)[4][4], const T* src,
                                              int lane, int rows = 16) {
  const int r = lane >> 2, c = (lane & 3) * 2;
  const uint32_t* lo = reinterpret_cast<const uint32_t*>(src + r * D + c);
  const uint32_t* hi = reinterpret_cast<const uint32_t*>(src + (r + 8) * D + c);
  const bool lo_in = r < rows, hi_in = r + 8 < rows;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    a[ks][0] = lo_in ? lo[8 * ks] : 0u;
    a[ks][1] = hi_in ? hi[8 * ks] : 0u;
    a[ks][2] = lo_in ? lo[8 * ks + 4] : 0u;
    a[ks][3] = hi_in ? hi[8 * ks + 4] : 0u;
  }
}

// d += a . b on the tensor cores: m16n8k16, T inputs, fp32 accumulators
template <typename T>
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same<T, __half>::value) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0,%1,%2,%3}, "
        "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
        "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// two n8 C fragments (a 16 x 16 tile) packed into one k16 A fragment
template <typename T>
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&c)[2][4]) {
  a[0] = pack2<T>(c[0][0], c[0][1]);
  a[1] = pack2<T>(c[0][2], c[0][3]);
  a[2] = pack2<T>(c[1][0], c[1][1]);
  a[3] = pack2<T>(c[1][2], c[1][3]);
}

// Store a warp's [16, 64] fp32 accumulator (eight n8 C fragments), times
// the per-row factor mul[0] (row lane/4) / mul[1] (row lane/4 + 8), as T
// rows of dst (its row 0).
template <typename T>
__device__ __forceinline__ void store_rows(T* dst, const float (&acc)[8][4],
                                           const float (&mul)[2], int lane) {
  const int r = lane >> 2, c = (lane & 3) * 2;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    uint32_t* row = reinterpret_cast<uint32_t*>(dst + (r + 8 * h) * D + c);
#pragma unroll
    for (int dt = 0; dt < 8; ++dt)
      row[4 * dt] = pack2<T>(acc[dt][2 * h] * mul[h], acc[dt][2 * h + 1] * mul[h]);
  }
}

// What a warp of the forward's and dQ's CUDA block owns: its member (the
// query block row gG + member of group g) and 16 rows of it, and the group's
// union entries it walks.  blockIdx.x is batch*head, blockIdx.y the group
// (times NT: at block 128 two CUDA blocks own one block row's halves).
template <int BLOCK>
struct RowWalk {
  using C = Geo<BLOCK>;
  int bh;
  int member;
  bool live;      // the member exists (the last group may be short)
  size_t row0;    // the warp's first row in [bh * t, 64]
  const int* idx;
  const int* msk;
  int steps;      // ring stages: union entries times NT

  __device__ __forceinline__ RowWalk(const Groups& gr, int t, int warp) {
    bh = blockIdx.x;
    const int grp = blockIdx.y / C::NT;
    const int half = blockIdx.y % C::NT;
    member = warp / C::WPM;
    const int row_block = grp * C::G + member;
    live = row_block < t / BLOCK;
    row0 = (size_t)bh * t + row_block * BLOCK + half * 64 + (warp % C::WPM) * 16;
    const size_t g = group_row(bh, grp, gr);
    idx = gr.idx + g * gr.width;
    msk = gr.mask + g * gr.width;
    steps = gr.count[g] * C::NT;
  }
};

// The forward's and dQ's walk over a group's union entries: each entry's K
// and V tiles (KT rows each, NT stages an entry) come once through a
// STAGES-deep cp.async ring for all four warps, one __syncthreads a stage;
// `body(k_tile)` (the V tile follows at k_tile + TILE_BYTES) runs on the
// warps whose member bit is set.  kb/vb: the batch*head's [t, 64] K and V.
// Shared memory: STAGES * 2 * TILE_BYTES from `ring`.
template <int BLOCK, typename T, typename Body>
__device__ __forceinline__ void walk_kv(const RowWalk<BLOCK>& w, uint32_t ring,
                                        const T* kb, const T* vb, int tid,
                                        Body&& body) {
  using C = Geo<BLOCK>;
  auto fetch = [&](int s) {
    if (s < w.steps) {
      const int r0 = w.idx[s / C::NT] * BLOCK + (s % C::NT) * C::KT;
      const uint32_t st = ring + (s % STAGES) * 2 * C::TILE_BYTES;
      load_tile<C::KT>(st, kb + (size_t)r0 * D, tid);
      load_tile<C::KT>(st + C::TILE_BYTES, vb + (size_t)r0 * D, tid);
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };
  for (int s = 0; s < STAGES - 1; ++s) fetch(s);
  for (int s = 0; s < w.steps; ++s) {
    const bool mine = w.live && ((w.msk[s / C::NT] >> w.member) & 1);
    cp_async_wait<STAGES - 2>();  // this thread's copies of stage s landed
    __syncthreads();  // everyone's have, and stage s - 1 is released
    fetch(s + STAGES - 1);  // into the slot of stage s - 1
    if (mine) body(ring + (s % STAGES) * 2 * C::TILE_BYTES);
  }
}

}  // namespace mma
}  // namespace block_sparse

// The dtype switches of the bf16/fp16 (tensor-core) arms, templated on
// <T, BLOCK> and returning the launcher's error code, and of the fp32 arms
// (templated on <float, BLOCK>, returning nothing).
#define BLOCK_SPARSE_DISPATCH_TC(LAUNCH, ...)                                \
  switch (dtype * 1000 + block) {                                            \
    case 1016: return LAUNCH<__nv_bfloat16, 16>(__VA_ARGS__);                \
    case 1032: return LAUNCH<__nv_bfloat16, 32>(__VA_ARGS__);                \
    case 1064: return LAUNCH<__nv_bfloat16, 64>(__VA_ARGS__);                \
    case 1128: return LAUNCH<__nv_bfloat16, 128>(__VA_ARGS__);               \
    case 2016: return LAUNCH<__half, 16>(__VA_ARGS__);                       \
    case 2032: return LAUNCH<__half, 32>(__VA_ARGS__);                       \
    case 2064: return LAUNCH<__half, 64>(__VA_ARGS__);                       \
    case 2128: return LAUNCH<__half, 128>(__VA_ARGS__);                      \
    default: return static_cast<int>(cudaErrorInvalidValue);                 \
  }

#define BLOCK_SPARSE_DISPATCH_FP32(LAUNCH, ...)                              \
  switch (block) {                                                           \
    case 16: LAUNCH<float, 16>(__VA_ARGS__); break;                          \
    case 32: LAUNCH<float, 32>(__VA_ARGS__); break;                          \
    case 64: LAUNCH<float, 64>(__VA_ARGS__); break;                          \
    case 128: LAUNCH<float, 128>(__VA_ARGS__); break;                        \
    default: return static_cast<int>(cudaErrorInvalidValue);                 \
  }
