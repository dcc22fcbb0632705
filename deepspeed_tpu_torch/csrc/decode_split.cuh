// The key-split decode-attention kernel shared by csrc/decode_attention.cu,
// csrc/decode_multi.cu, csrc/decode_paged.cu and csrc/decode_paged_multi.cu:
// their bf16/fp16 arms, head_dim 64, on Hopper (sm_90a) tensor cores.
//
// One (slot, head) attends W <= 9 query rows (W = 1 for a decode tick) to
// its cached keys, each row over its own live length read from device
// memory.  Where key j lives is a policy (`Rows`): row j of the slot cache
// [S, H, T, 64] (`SlotRows`), or row j % page_len of page
// table[s, j / page_len] of a flat pool [P, H, page_len, 64] (`PageRows`).
// The int8 pool (QUANT) adds one fp32 scale per stored row, k_scale and
// v_scale [P, H, page_len], through the same map.
//
// What bounds it on the H100: bytes.  Each live key costs 2 x 64 elements
// of K and V (bf16: 256 B; int8: 136 B with the two scales) against
// 4 x 64 x W flops; at the serving shape ([8, 12, 1024, 64], the longest
// rows 0-1024 keys) the live rows read once take 0.002-0.003 ms at
// 3.35 TB/s.  What stands between a kernel and that is latency: one CUDA
// block per (slot, head) is 96 blocks on 132 SMs, and the slot with the
// longest row is walked by one SM alone, each step a round trip to memory.
//
// What the design does about it:
// - the key axis of each (slot, head) is split over N CUDA blocks that form
//   one thread-block cluster, N = ceil(T / 256) clamped to 1..8 (the
//   portable cluster size) and cut where the grid alone already fills the
//   card (`splits`: at 64 slots x 12 heads, N = 1, and then registers are
//   capped so that six blocks fit an SM and the whole grid runs in one
//   wave): 384 blocks at the serving shape, all resident at once.  Block r
//   takes keys [r * chunk, (r + 1) * chunk), chunk = ceil(T / N) rounded
//   up to whole 64-key tiles, and stops at its slot's longest live row,
//   read on the device (no host sync); a block whose range lies wholly
//   past every row loads nothing and reports l = 0;
// - the paged map copies the table entries of its range into shared memory
//   once, before the walk (only the columns below ceil(longest row /
//   page_len): the rest may hold anything and are never read), so no key's
//   address waits on a load of its table entry;
// - keys come in 64-key tiles through a 2-stage cp.async ring, each row of
//   16-byte chunks from wherever the map puts it (a tile may span any
//   number of pages), into 128-byte-swizzled tiles; rows at or past the
//   longest row are zero-filled and never read.  Each of four warps
//   copies, waits for, widens (int8) and reads only its own 16 rows of
//   every tile, so the walk has no block-wide barrier: a warp stalls on
//   its own loads alone;
// - the W rows are padded to one m16 tile, Q held as A fragments;
//   S = Q.K^T and O += P.V run on mma.sync m16n8k16 with fp32
//   accumulators, each warp on its 16 keys of a tile, with one row max and
//   one rescale per warp and tile;
// - keys at or past a row's own length get p = 0 explicitly (a row can be
//   dead in a tile that another row keeps live: exp(-inf - -inf) is never
//   formed); in the fp arm P enters P.V rounded once to the input type, as
//   the JAX kernels' `p.astype(v.dtype)` do;
// - the int8 arm lands each int8 tile (64-byte rows) and its scales in a
//   staging stage.  K's B fragments are built in registers (int8 values
//   are exact in bf16 and fp16): with the dims of each k16 step permuted
//   in Q's A fragments as well, a lane's B values for a key are 16
//   consecutive bytes of its row, one 16-byte load widened to the query's
//   type, with no widened K tile and no ldmatrix.  V is widened in shared
//   memory to a swizzled bf16 tile, so the fp arm's transposing ldmatrix
//   serves it (sm_90 has no 8-bit transposing ldmatrix).  k_scale folds
//   into S per key column, s = (q.k8) * sm_scale * ks, masked by a select, never by
//   a multiply (0 x inf is NaN); v_scale folds into P per
//   key row, pv = p * vs in fp32, which enters P.V unrounded as the JAX
//   kernel's fp32 `pv` does: as hi + lo, two bf16 terms (two mma), ~2^-17
//   relative; l sums p alone.  V is bf16 and not fp16 because p * vs spans
//   more range than fp16 holds (its lo term would flush to zero);
// - the four warps' states merge in shared memory, then the N blocks'
//   (m, l, acc[16, 64]) through distributed shared memory: after
//   cluster.sync() the rank-0 block reads its peers' states with
//   map_shared_rank and writes O, with no second launch and no workspace
//   in device memory (at N = 1 the block writes O itself, launched
//   without a cluster).  A row with no live key anywhere writes exact
//   zeros.
//
// tests/test_torch_decode_multi_split.py and
// tests/test_torch_decode_paged_split.py emulate the arithmetic on the CPU.
#pragma once

#include <type_traits>

#include <cooperative_groups.h>

#include "block_sparse_mma.cuh"

namespace decode_split {

namespace cg = cooperative_groups;
using namespace block_sparse;
using namespace block_sparse::mma;

constexpr int TILE = 64;             // keys a ring stage holds
constexpr int KEYS_PER_SPLIT = 256;  // N = ceil(t_max / 256) ...
constexpr int MAX_SPLITS = 8;        // ... clamped to the portable cluster size
constexpr int RESIDENT = 4;          // ... and to RESIDENT blocks an SM
constexpr int ONE_BLOCK_RESIDENT = 6;  // blocks an SM holds at N = 1
constexpr int RING = 2;              // stages
constexpr int TILE_BYTES = TILE * ROW_BYTES;  // a 16-bit tile
constexpr int I8_TILE_BYTES = TILE * D;       // an int8 tile
constexpr int SMEM_LIMIT = 48 * 1024;         // dynamic bytes without opt-in

// Shared-memory geometry of the ring.  fp: each stage holds the K tile,
// then the V tile.  QUANT: each stage holds the int8 K and V tiles and
// their 64 + 64 scales; one V tile widened to bf16 follows the ring.
template <bool QUANT>
struct Ring {
  static constexpr int STAGE =
      QUANT ? 2 * I8_TILE_BYTES + 2 * TILE * 4 : 2 * TILE_BYTES;
  static constexpr int CONV = RING * STAGE;  // QUANT: the widened V tile
  static constexpr int BYTES = QUANT ? CONV + TILE_BYTES : RING * STAGE;
};

// keys a split takes: ceil(t_max / n) in whole tiles
inline int split_keys(int t_max, int n) {
  const int c = (t_max + n - 1) / n;
  return (c + TILE - 1) / TILE * TILE;
}

// The split count at cache length t_max (the slot cache's T, or
// max_pages * page_len) over `pairs` (slot, head) pairs: ceil(t_max / 256)
// clamped to 1..8, and to what keeps at most RESIDENT blocks an SM.  A
// grid of many short slots (64 slots x 12 heads) already fills the card
// with one block a pair; splitting it would only add blocks that see no key.
inline int splits(int t_max, long long pairs) {
  int n = (t_max + KEYS_PER_SPLIT - 1) / KEYS_PER_SPLIT;
  n = n < 1 ? 1 : n > MAX_SPLITS ? MAX_SPLITS : n;
  static const int sms = [] {  // read once, not on every launch
    int n = 132, dev = 0;
    if (cudaGetDevice(&dev) == cudaSuccess)
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }();
  const long long cap = RESIDENT * static_cast<long long>(sms) /
                        (pairs > 0 ? pairs : 1);
  return cap < 1 ? 1 : n < cap ? n : static_cast<int>(cap);
}

struct Args {
  const void* q;         // [S, H, W, 64]
  const void* k;         // [S, H, T, 64], or a pool [P, H, page_len, 64]
  const void* v;
  const float* k_scale;  // QUANT: [P, H, page_len]
  const float* v_scale;
  const int* table;      // paged: [S, max_pages]
  const int* lengths;    // [S, W]
  void* o;               // [S, H, W, 64]
  int heads, w;
  int t_max;             // T, or max_pages * page_len
  int page_len, max_pages;
  int n, chunk;          // splits, and keys a split
  float sm_scale;
};

// Key j of slot cache row sh is row sh * T + j.
struct SlotRows {
  static constexpr bool TABLE = false;
  size_t base;
  __device__ __forceinline__ size_t operator()(int j) const { return base + j; }
  static __device__ __forceinline__ SlotRows make(const Args& a, int sh, int, int,
                                                  int*, int) {
    return {(size_t)sh * a.t_max};
  }
  static int table_ints(const Args&) { return 0; }
};

// Key j of (slot s, head h) is row j % page_len of page table[s, j /
// page_len]: the pool's row (page * H + h) * page_len + j % page_len.
// `make` copies the table columns of keys [k0, k1) into shared memory
// (made visible by the caller's __syncthreads).
struct PageRows {
  static constexpr bool TABLE = true;
  const int* cols;  // shared: the entries of columns col0..
  int col0, page_len, heads, h;
  __device__ __forceinline__ size_t operator()(int j) const {
    const int c = j / page_len;
    return ((size_t)cols[c - col0] * heads + h) * page_len + (j - c * page_len);
  }
  static __device__ __forceinline__ PageRows make(const Args& a, int sh, int k0,
                                                  int k1, int* stab, int tid) {
    const int s = sh / a.heads;
    const int c0 = k0 / a.page_len;
    const int cols = k1 > k0 ? (k1 - 1) / a.page_len + 1 - c0 : 0;
    const int* row = a.table + (size_t)s * a.max_pages + c0;
    for (int i = tid; i < cols; i += THREADS) stab[i] = row[i];
    return {stab, c0, a.page_len, a.heads, sh - s * a.heads};
  }
  // the most columns a split's keys span
  static int table_ints(const Args& a) { return (a.chunk + a.page_len - 1) / a.page_len + 1; }
};

// the 4-byte copy of cp_async16_zfill (bytes 0 or 4): a scale
__device__ __forceinline__ void cp_async4_zfill(uint32_t dst, const void* src,
                                                int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes));
}

// A warp's 16 rows r0..r0+15 of a 64-key tile (keys k0 + r0.., k0: the
// tile's first key) into ring stage `st`; rows at or past `live` are
// zero-filled, their source never read.  Each warp copies, waits for and
// reads only its own rows, so the walk needs no block-wide barrier.
template <typename T, typename Rows>
__device__ __forceinline__ void load_fp(uint32_t st, const T* k, const T* v,
                                        const Rows& rows, int k0, int r0, int live,
                                        int lane) {
#pragma unroll
  for (int i = lane; i < 16 * 8; i += 32) {
    const int r = r0 + (i >> 3), c = i & 7;
    const bool in = k0 + r < live;
    const size_t off = in ? rows(k0 + r) * D + c * 8 : 0;
    cp_async16_zfill(st + swz(r, c), k + off, in ? 16 : 0);
    cp_async16_zfill(st + TILE_BYTES + swz(r, c), v + off, in ? 16 : 0);
  }
}

// The int8 twin: row-major int8 tiles (64-byte rows), then the K scales
// and the V scales of the same rows (4-byte copies: at page_len 7 a page's
// scale row is not 16-byte aligned).
template <typename Rows>
__device__ __forceinline__ void load_int8(uint32_t st, const int8_t* k,
                                          const int8_t* v, const float* ks,
                                          const float* vs, const Rows& rows, int k0,
                                          int r0, int live, int lane) {
#pragma unroll
  for (int i = lane; i < 16 * 4; i += 32) {
    const int r = r0 + (i >> 2), c = i & 3;
    const bool in = k0 + r < live;
    const size_t off = in ? rows(k0 + r) * D + c * 16 : 0;
    cp_async16_zfill(st + r * D + c * 16, k + off, in ? 16 : 0);
    cp_async16_zfill(st + I8_TILE_BYTES + r * D + c * 16, v + off, in ? 16 : 0);
  }
  const int r = r0 + (lane & 15);  // lanes 0-15: k_scale, 16-31: v_scale
  const bool in = k0 + r < live;
  const size_t row = in ? rows(k0 + r) : 0;
  cp_async4_zfill(st + 2 * I8_TILE_BYTES + (lane >> 4) * TILE * 4 + r * 4,
                  (lane < 16 ? ks : vs) + row, in ? 4 : 0);
}

// four int8 values (one 32-bit word) as two pairs of T (exact: |x| <=
// 128): bytes 0, 1 in lo and 2, 3 in hi.  Byte b + 128 (b ^ 0x80) becomes
// the low mantissa byte of 2^23, so float(2^23 + b + 128) - (2^23 + 128)
// = b with one permute and one add, no integer-to-float conversion.
template <typename T>
__device__ __forceinline__ void widen4(uint32_t x, uint32_t& lo, uint32_t& hi) {
  x ^= 0x80808080u;
  float f[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    f[k] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7540u + k)) - 8388736.f;
  lo = pack2<T>(f[0], f[1]);
  hi = pack2<T>(f[2], f[3]);
}

// sixteen int8 values as two 16-byte chunks of T
template <typename T>
__device__ __forceinline__ void widen16(const int4 x, uint4& a, uint4& b) {
  widen4<T>(x.x, a.x, a.y);
  widen4<T>(x.y, a.z, a.w);
  widen4<T>(x.z, b.x, b.y);
  widen4<T>(x.w, b.z, b.w);
}

// frag_a_global's fragments with the dims of each k16 step permuted: lane
// (g, t)'s k = 2t, 2t+1 of step ks are dims 16t + 4ks + {0, 1} and its
// k = 2t+8, 2t+9 dims 16t + 4ks + {2, 3}, so that its B values over the
// four steps are bytes 16t..16t+15 of an int8 K row (`scores_int8`).
template <typename T>
__device__ __forceinline__ void frag_a_global_k8(uint32_t (&a)[4][4], const T* src,
                                                 int lane, int rows) {
  const int r = lane >> 2, c = 16 * (lane & 3);
  const uint32_t* lo = reinterpret_cast<const uint32_t*>(src + r * D + c);
  const uint32_t* hi = reinterpret_cast<const uint32_t*>(src + (r + 8) * D + c);
  const bool lo_in = r < rows, hi_in = r + 8 < rows;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    a[ks][0] = lo_in ? lo[2 * ks] : 0u;
    a[ks][1] = hi_in ? hi[2 * ks] : 0u;
    a[ks][2] = lo_in ? lo[2 * ks + 1] : 0u;
    a[ks][3] = hi_in ? hi[2 * ks + 1] : 0u;
  }
}

// A warp's V rows r0..r0+15 of a staged int8 stage `st` widened to bf16
// into the swizzled tile `cv`.  Rows at or past `live` were zero-filled by
// the copy: they are stored as zeros, not widened.
__device__ __forceinline__ void widen_v(const uint8_t* st, uint8_t* cv, int r0, int live,
                                        int lane) {
#pragma unroll
  for (int i = lane; i < 16 * 4; i += 32) {
    const int r = r0 + (i >> 2), c = i & 3;
    uint4 a = make_uint4(0, 0, 0, 0), b = a;
    if (r < live)
      widen16<__nv_bfloat16>(
          *reinterpret_cast<const int4*>(st + I8_TILE_BYTES + r * D + c * 16), a, b);
    *reinterpret_cast<uint4*>(cv + swz(r, 2 * c)) = a;
    *reinterpret_cast<uint4*>(cv + swz(r, 2 * c + 1)) = b;
  }
}

// S = Q.K^T of a warp's 16 keys from a 16-bit tile (rows r0.. of kt)
template <typename T>
__device__ __forceinline__ void scores_tile(float (&s)[2][4], const uint32_t (&qa)[4][4],
                                            uint32_t kt, int r0, int lane) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    uint32_t b[4];
    frag_b_rows(b, kt, r0, ks, lane);
    mma16816<T>(s[0], qa[ks], b[0], b[1]);
    mma16816<T>(s[1], qa[ks], b[2], b[3]);
  }
}

// The same from a staged int8 K tile (64-byte rows), its B fragments
// built in registers: lane (g, t) loads bytes 16t..16t+15 of rows r0 + g
// and r0 + 8 + g and widens each step's four bytes to one (b0, b1) pair of
// T, in the dims of `frag_a_global_k8`'s qa; no widened K tile and no
// ldmatrix.
template <typename T>
__device__ __forceinline__ void scores_int8(float (&s)[2][4], const uint32_t (&qa)[4][4],
                                            const uint8_t* kt, int r0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  int4 x[2];
#pragma unroll
  for (int n = 0; n < 2; ++n)
    x[n] = *reinterpret_cast<const int4*>(kt + (r0 + 8 * n + g) * D + 16 * t);
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    const uint32_t w[4] = {static_cast<uint32_t>(x[n].x), static_cast<uint32_t>(x[n].y),
                           static_cast<uint32_t>(x[n].z), static_cast<uint32_t>(x[n].w)};
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      uint32_t b0, b1;
      widen4<T>(w[ks], b0, b1);
      mma16816<T>(s[n], qa[ks], b0, b1);
    }
  }
}

// The states that merge after the walk, in the ring's shared memory: each
// warp's partial (m, l, acc) of the 16 padded rows, then the block's.
struct Merge {
  float acc[WARPS][16][D];
  float m[WARPS][16];
  float l[WARPS][16];
  float bacc[16][D];  // the block's state, read by the cluster's rank 0
  float bm[16];
  float bl[16];
};
static_assert(sizeof(Merge) <= Ring<false>::BYTES, "the merge fits the ring");
static_assert(sizeof(Merge) <= Ring<true>::BYTES, "the merge fits the ring");

// One warp's 16 keys (rows r0.. of the V tile vt, global key j0 = the
// first) of the online softmax, from their scores s = Q.K^T: one row max
// and rescale, P with the rows' own lengths masked to 0, O += P.V.  fp: P
// rounded once to T.  QUANT (ksc / vsc: the stage's 64 K and V scales,
// row 0 first): S scaled by the key's k_scale, P by its v_scale into pv,
// which enters P.V as bf16 hi + lo.
template <typename T, bool QUANT>
__device__ __forceinline__ void split_chunk(float (&s)[2][4], uint32_t vt,
                                            const float* ksc, const float* vsc,
                                            int r0, int j0,
                                            const int (&len)[2], float scale2,
                                            float (&m)[2], float (&l)[2],
                                            float (&acc)[8][4], int lane) {
  bool live[2][4];
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = 8 * n + 2 * (lane & 3) + (i & 1);
      live[n][i] = j0 + c < len[i >> 1];
      const float f = QUANT ? scale2 * ksc[r0 + c] : scale2;
      s[n][i] = live[n][i] ? s[n][i] * f : NEG_INF;
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
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float p = live[n][i] ? ex2(s[n][i] - m[i >> 1]) : 0.f;
      l[i >> 1] += p;
      s[n][i] = QUANT ? p * vsc[r0 + 8 * n + 2 * (lane & 3) + (i & 1)] : p;
    }
#pragma unroll
  for (int dt = 0; dt < 8; ++dt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[dt][i] *= alpha[i >> 1];
  if constexpr (QUANT) {
    using B = __nv_bfloat16;
    uint32_t hi[4], lo[4];
    float rest[2][4];
    pack_a<B>(hi, s);
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int i = 0; i < 4; i += 2) {
        const float2 hv = unpack2<B>(hi[2 * n + (i >> 1)]);
        rest[n][i] = s[n][i] - hv.x;
        rest[n][i + 1] = s[n][i + 1] - hv.y;
      }
    pack_a<B>(lo, rest);
#pragma unroll
    for (int dn = 0; dn < 4; ++dn) {
      uint32_t b[4];
      frag_b_cols(b, vt, r0, dn, lane);
      mma16816<B>(acc[2 * dn], hi, b[0], b[1]);
      mma16816<B>(acc[2 * dn], lo, b[0], b[1]);
      mma16816<B>(acc[2 * dn + 1], hi, b[2], b[3]);
      mma16816<B>(acc[2 * dn + 1], lo, b[2], b[3]);
    }
  } else {
    uint32_t pa[4];
    pack_a<T>(pa, s);
#pragma unroll
    for (int dn = 0; dn < 4; ++dn) {
      uint32_t b[4];
      frag_b_cols(b, vt, r0, dn, lane);
      mma16816<T>(acc[2 * dn], pa, b[0], b[1]);
      mma16816<T>(acc[2 * dn + 1], pa, b[2], b[3]);
    }
  }
}

// Eight output columns acc / l as T; no live key anywhere (length 0):
// l == 0 -> exact zeros.
template <typename T>
__device__ __forceinline__ void store8(T* dst, const float (&acc)[8], float l) {
  const float inv = l > 0.f ? 1.f / l : 0.f;
  uint32_t packed[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) packed[i] = pack2<T>(acc[2 * i] * inv, acc[2 * i + 1] * inv);
  *reinterpret_cast<uint4*>(dst) = make_uint4(packed[0], packed[1], packed[2], packed[3]);
}

// Grid: N blocks per (slot, head), consecutive, one cluster of N each.
// Dynamic shared memory: the ring (Ring<QUANT>::BYTES), then the paged
// map's table columns.  MIN_BLOCKS: the blocks an SM must hold at once
// (registers capped to fit): ONE_BLOCK_RESIDENT where a block a pair
// fills the card (N = 1), RESIDENT where the keys split.
template <typename T, typename Rows, bool QUANT, int MIN_BLOCKS>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) decode_split_kernel(const Args a) {
  using KV = std::conditional_t<QUANT, int8_t, T>;
  using R = Ring<QUANT>;
  extern __shared__ __align__(128) uint8_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int sh = blockIdx.x / a.n;  // slot * heads + head
  const int s = sh / a.heads;
  const int w = a.w;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // the slot's longest row, and this thread's two rows' lengths (rows at
  // or past w: 0)
  int maxlen = 0, len[2] = {0, 0};
  for (int r = 0; r < w; ++r) {
    const int x = min(max(a.lengths[s * w + r], 0), a.t_max);
    maxlen = max(maxlen, x);
    if (r == (lane >> 2)) len[0] = x;
    if (r == (lane >> 2) + 8) len[1] = x;
  }
  const int k0 = rank * a.chunk;
  const int k1 = min(k0 + a.chunk, maxlen);
  const int tiles = k1 > k0 ? (k1 - k0 + TILE - 1) / TILE : 0;

  uint32_t qa[4][4];
  if constexpr (QUANT)
    frag_a_global_k8(qa, static_cast<const T*>(a.q) + (size_t)sh * w * D, lane, w);
  else
    frag_a_global(qa, static_cast<const T*>(a.q) + (size_t)sh * w * D, lane, w);
  const Rows rows =
      Rows::make(a, sh, k0, k1, reinterpret_cast<int*>(smem + R::BYTES), tid);
  if constexpr (Rows::TABLE) __syncthreads();  // the table columns are in

  const KV* kb = static_cast<const KV*>(a.k);
  const KV* vb = static_cast<const KV*>(a.v);
  const uint32_t ring = smem_u32(smem);
  const int r0 = 16 * warp;  // this warp's rows of every tile
  auto fetch = [&](int i) {
    if (i < tiles) {
      const uint32_t st = ring + (i % RING) * R::STAGE;
      if constexpr (QUANT)
        load_int8(st, kb, vb, a.k_scale, a.v_scale, rows, k0 + i * TILE, r0, maxlen,
                  lane);
      else
        load_fp(st, kb, vb, rows, k0 + i * TILE, r0, maxlen, lane);
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };
  for (int i = 0; i < RING; ++i) fetch(i);

  float acc[8][4] = {};
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  const float scale2 = a.sm_scale * LOG2E;

  for (int i = 0; i < tiles; ++i) {
    cp_async_wait<RING - 1>();  // this lane's copies of tile i landed
    __syncwarp();               // the warp's have
    const int j0 = k0 + i * TILE + r0;
    if (j0 < maxlen) {
      float s[2][4] = {};
      if constexpr (QUANT) {
        const uint8_t* sp = smem + (i % RING) * R::STAGE;
        const float* sc = reinterpret_cast<const float*>(sp + 2 * I8_TILE_BYTES);
        widen_v(sp, smem + R::CONV, r0, maxlen - (k0 + i * TILE), lane);
        __syncwarp();  // the warp's V rows are widened
        scores_int8<T>(s, qa, sp, r0, lane);
        split_chunk<T, true>(s, ring + R::CONV, sc, sc + TILE, r0, j0, len, scale2, m,
                             l, acc, lane);
      } else {
        const uint32_t st = ring + (i % RING) * R::STAGE;
        scores_tile<T>(s, qa, st, r0, lane);
        split_chunk<T, false>(s, st + TILE_BYTES, nullptr, nullptr, r0, j0, len,
                              scale2, m, l, acc, lane);
      }
    }
    __syncwarp();  // the warp is done with its rows of tile i's stage
    fetch(i + RING);
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free for the merge

  // the four warps' states, then the block's: thread tid merges row
  // tid / 8, columns 8 * (tid % 8) ..+8
  Merge& mg = *reinterpret_cast<Merge*>(smem);
  const int qr = lane >> 2, qc = 2 * (lane & 3);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
#pragma unroll
    for (int dt = 0; dt < 8; ++dt)
      *reinterpret_cast<float2*>(&mg.acc[warp][qr + 8 * h][8 * dt + qc]) =
          make_float2(acc[dt][2 * h], acc[dt][2 * h + 1]);
    if ((lane & 3) == 0) {
      mg.m[warp][qr + 8 * h] = m[h];
      mg.l[warp][qr + 8 * h] = l[h];
    }
  }
  __syncthreads();
  const int row = tid >> 3, c0 = 8 * (tid & 7);
  T* out = static_cast<T*>(a.o) + ((size_t)sh * w + row) * D + c0;
  {
    float mb = NEG_INF;
#pragma unroll
    for (int wp = 0; wp < WARPS; ++wp)
      if (mg.l[wp][row] > 0.f) mb = fmaxf(mb, mg.m[wp][row]);
    float lb = 0.f, ab[8] = {};
#pragma unroll
    for (int wp = 0; wp < WARPS; ++wp) {
      const float f = mg.l[wp][row] > 0.f ? ex2(mg.m[wp][row] - mb) : 0.f;
      lb = fmaf(mg.l[wp][row], f, lb);
#pragma unroll
      for (int i = 0; i < 8; ++i) ab[i] = fmaf(mg.acc[wp][row][c0 + i], f, ab[i]);
    }
    if (a.n == 1) {  // no peers: this block's state is the row's
      if (row < w) store8(out, ab, lb);
      return;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) mg.bacc[row][c0 + i] = ab[i];
    if ((tid & 7) == 0) {
      mg.bm[row] = mb;
      mg.bl[row] = lb;
    }
  }
  cluster.sync();  // every block's state is written and visible

  if (rank == 0 && row < w) {
    // every peer's (m, l) first, then its acc: two rounds of loads in
    // flight across the cluster, not two a peer
    float pm[MAX_SPLITS], pl[MAX_SPLITS];
    float mt = NEG_INF;
#pragma unroll
    for (int p = 0; p < MAX_SPLITS; ++p) {
      pl[p] = 0.f;
      if (p < a.n) {
        const Merge* peer = cluster.map_shared_rank(&mg, p);
        pm[p] = peer->bm[row];
        pl[p] = peer->bl[row];
      }
    }
#pragma unroll
    for (int p = 0; p < MAX_SPLITS; ++p)
      if (pl[p] > 0.f) mt = fmaxf(mt, pm[p]);  // a split that saw no key adds nothing
    float lt = 0.f, at[8] = {};
#pragma unroll
    for (int p = 0; p < MAX_SPLITS; ++p) {
      if (pl[p] > 0.f) {
        const Merge* peer = cluster.map_shared_rank(&mg, p);
        const float4 a0 = *reinterpret_cast<const float4*>(&peer->bacc[row][c0]);
        const float4 a1 = *reinterpret_cast<const float4*>(&peer->bacc[row][c0 + 4]);
        const float f = ex2(pm[p] - mt);
        lt = fmaf(pl[p], f, lt);
        at[0] = fmaf(a0.x, f, at[0]);
        at[1] = fmaf(a0.y, f, at[1]);
        at[2] = fmaf(a0.z, f, at[2]);
        at[3] = fmaf(a0.w, f, at[3]);
        at[4] = fmaf(a1.x, f, at[4]);
        at[5] = fmaf(a1.y, f, at[5]);
        at[6] = fmaf(a1.z, f, at[6]);
        at[7] = fmaf(a1.w, f, at[7]);
      }
    }
    store8(out, at, lt);
  }
  cluster.sync();  // the peers' shared memory outlives rank 0's reads
}

// Launch over `slots` x a.heads pairs, a.n blocks each in clusters of
// a.n (the caller fills every field but n and chunk).  Returns a CUDA
// error code.
template <typename T, typename Rows, bool QUANT>
int launch(Args a, int slots, cudaStream_t st) {
  a.n = splits(a.t_max, static_cast<long long>(slots) * a.heads);
  a.chunk = split_keys(a.t_max, a.n);
  const int smem = Ring<QUANT>::BYTES + 4 * Rows::table_ints(a);
  auto kernel = a.n == 1 ? decode_split_kernel<T, Rows, QUANT, ONE_BLOCK_RESIDENT>
                         : decode_split_kernel<T, Rows, QUANT, RESIDENT>;
  if (smem > SMEM_LIMIT) {
    const int rc = allow_smem(kernel, smem);
    if (rc != 0) return rc;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.n * slots * a.heads);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.n;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = a.n > 1 ? 1 : 0;  // N = 1: a plain launch, no peers
  const cudaError_t rc = cudaLaunchKernelEx(&cfg, kernel, a);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}

// The dtype switch of the bf16/fp16 arms (dtype 1 bf16, 2 fp16)
template <typename Rows, bool QUANT>
int launch_typed(int dtype, const Args& a, int slots, cudaStream_t st) {
  switch (dtype) {
    case 1:
      return launch<__nv_bfloat16, Rows, QUANT>(a, slots, st);
    case 2:
      return launch<__half, Rows, QUANT>(a, slots, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace decode_split
