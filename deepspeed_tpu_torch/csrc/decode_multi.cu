// Multi-query decode attention over the slot KV cache for Hopper (sm_90a),
// head_dim 64: the speculative verify pass.
//
// Replaces the Pallas TPU kernel deepspeed_tpu/ops/pallas/decode_attention.py
// `_decode_multi_kernel` (launched by `_decode_multi_pallas` through
// `pl.pallas_call`; API `decode_attention_multi`): W = k+1 <= 9 queries per
// (slot, head) against k/v [S, H, T, 64], query w over its own live length
// lengths[s, w] read from device memory; a length-0 row outputs exact zeros.
// The TPU kernel padded the W rows to a multiple of 8 sublanes and broadcast
// the lengths into [S, Wp, 128] tiles for Mosaic; here the lengths stay
// [S, W] int32.
//
// What bounds it on the H100: bytes.  Each live key costs 2 * 64 elements
// of K and V read once against 4 * 64 * W flops; at the serving shape
// ([8, 12, 1024, 64], W = 5, the longest rows 0-1024 keys) the live rows
// read once take 0.00239 ms at 3.35 TB/s.  What stands between a kernel
// and that is latency: one CUDA block per (slot, head) is 96 blocks on 132
// SMs, and the slot with the longest row is walked by one SM alone.
//
// What the design does about it (bf16 and fp16):
// - the key axis of each (slot, head) is split over N CUDA blocks that form
//   one thread-block cluster, N = ceil(t_max / 256) clamped to 1..8 (the
//   portable cluster size): 384 blocks at the serving shape, all resident
//   at once.  At 128 keys a split (768 blocks) not every cluster of 8
//   fits the card at once, and the kernel ran slower.  Block r takes
//   keys [r * chunk, (r + 1) * chunk), chunk = ceil(t_max / N) rounded up to
//   whole 64-key tiles, and stops at its slot's longest live row, read on
//   the device (no host sync); a block whose range lies wholly past every
//   row loads nothing and reports l = 0;
// - keys come in 64-key tiles through a 2-stage cp.async ring into swizzled
//   tiles (block_sparse_mma.cuh's `swz`/`load_tile_live`; rows past the
//   longest row are zero-filled, never read); each of four warps takes 16
//   keys of a tile;
// - the W rows are padded to one m16 tile, Q held as A fragments;
//   S = Q.K^T and O += P.V run on mma.sync m16n8k16 with fp32 accumulators,
//   and the row max and the rescale happen once per warp and tile, not once
//   per key;
// - keys at or past a row's own length get p = 0 explicitly (a row can be
//   dead in a tile that another row keeps live: exp(-inf - -inf) is never
//   formed); P enters P.V rounded once to the input type, as the JAX
//   kernel's `p.astype(v.dtype)` does (tests/test_torch_decode_multi_split.py
//   emulates the arithmetic);
// - the four warps' states merge in shared memory, then the N blocks'
//   (m, l, acc[16, 64]) through distributed shared memory: after
//   cluster.sync() the rank-0 block reads its peers' states with
//   map_shared_rank and writes O, with no second launch and no workspace
//   in device memory.  A row with no live key anywhere writes exact zeros.
//
// The fp32 arm keeps decode_common.cuh's `rows_kernel` (one block per
// (slot, head), fp32 FMAs): the tensor cores would take fp32 only as TF32,
// and the fp32 arm is held to 1e-4 of the plain version.
#include <cooperative_groups.h>

#include "block_sparse_mma.cuh"
#include "decode_common.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace block_sparse;
using namespace block_sparse::mma;

constexpr int TILE = 64;             // keys a ring stage holds
constexpr int KEYS_PER_SPLIT = 256;  // N = ceil(t_max / 256) ...
constexpr int MAX_SPLITS = 8;        // ... clamped to the portable cluster size
constexpr int RING = 2;              // stages
constexpr int TILE_BYTES = TILE * ROW_BYTES;
constexpr int STAGE_BYTES = 2 * TILE_BYTES;  // the K tile, then the V tile
constexpr int SMEM_BYTES = RING * STAGE_BYTES;

int splits(int t_max) {
  const int n = (t_max + KEYS_PER_SPLIT - 1) / KEYS_PER_SPLIT;
  return n < 1 ? 1 : n > MAX_SPLITS ? MAX_SPLITS : n;
}

// keys a split takes: ceil(t_max / n) in whole tiles
int split_keys(int t_max, int n) {
  const int c = (t_max + n - 1) / n;
  return (c + TILE - 1) / TILE * TILE;
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
static_assert(sizeof(Merge) <= SMEM_BYTES, "the merge fits the ring");

// one warp's 16 keys (rows r0.. of the stage's tiles, global key j0 = the
// first) of the online softmax: S = Q.K^T, one row max and rescale, P with
// the rows' own lengths masked to 0, O += P.V with P rounded once
template <typename T>
__device__ __forceinline__ void split_chunk(const uint32_t (&qa)[4][4], uint32_t kt,
                                            uint32_t vt, int r0, int j0,
                                            const int (&len)[2], float scale2,
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
  bool live[2][4];
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = j0 + 8 * n + 2 * (lane & 3) + (i & 1);
      live[n][i] = j < len[i >> 1];
      s[n][i] = live[n][i] ? s[n][i] * scale2 : NEG_INF;
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
      s[n][i] = p;
    }
  uint32_t pa[4];
  pack_a<T>(pa, s);
#pragma unroll
  for (int dt = 0; dt < 8; ++dt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[dt][i] *= alpha[i >> 1];
#pragma unroll
  for (int dn = 0; dn < 4; ++dn) {
    uint32_t b[4];
    frag_b_cols(b, vt, r0, dn, lane);
    mma16816<T>(acc[2 * dn], pa, b[0], b[1]);
    mma16816<T>(acc[2 * dn + 1], pa, b[2], b[3]);
  }
}

// Grid: N blocks per (slot, head), consecutive, one cluster of N each.
template <typename T>
__global__ void __launch_bounds__(THREADS)
decode_multi_split(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const int* __restrict__ lengths,
                   T* __restrict__ o, int heads, int w, int t_max, int n, int chunk,
                   float sm_scale) {
  extern __shared__ __align__(128) uint8_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int sh = blockIdx.x / n;  // slot * heads + head
  const int s = sh / heads;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // the slot's longest row, and this thread's two rows' lengths (rows at
  // or past w: 0)
  int maxlen = 0, len[2] = {0, 0};
  for (int r = 0; r < w; ++r) {
    const int x = min(max(lengths[s * w + r], 0), t_max);
    maxlen = max(maxlen, x);
    if (r == (lane >> 2)) len[0] = x;
    if (r == (lane >> 2) + 8) len[1] = x;
  }
  const int k0 = rank * chunk;
  const int k1 = min(k0 + chunk, maxlen);
  const int tiles = k1 > k0 ? (k1 - k0 + TILE - 1) / TILE : 0;
  const T* kb = k + (size_t)sh * t_max * D;
  const T* vb = v + (size_t)sh * t_max * D;
  const uint32_t ring = smem_u32(smem);

  auto fetch = [&](int i) {
    if (i < tiles) {
      const int r0 = k0 + i * TILE;
      const uint32_t st = ring + (i % RING) * STAGE_BYTES;
      load_tile_live<TILE>(st, kb + (size_t)r0 * D, maxlen - r0, tid);
      load_tile_live<TILE>(st + TILE_BYTES, vb + (size_t)r0 * D, maxlen - r0, tid);
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };
  for (int i = 0; i < RING; ++i) fetch(i);

  uint32_t qa[4][4];
  frag_a_global(qa, q + (size_t)sh * w * D, lane, w);
  float acc[8][4] = {};
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  const float scale2 = sm_scale * LOG2E;

  for (int i = 0; i < tiles; ++i) {
    cp_async_wait<RING - 1>();  // this thread's copies of tile i landed
    __syncthreads();            // everyone's have
    const int j0 = k0 + i * TILE + 16 * warp;
    if (j0 < maxlen) {
      const uint32_t st = ring + (i % RING) * STAGE_BYTES;
      split_chunk<T>(qa, st, st + TILE_BYTES, 16 * warp, j0, len, scale2, m, l, acc,
                     lane);
    }
    __syncthreads();  // every warp is done with tile i's slot
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
      if (p < n) {
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
    // no live key anywhere (length 0): lt == 0 -> exact zeros
    const float inv = lt > 0.f ? 1.f / lt : 0.f;
    uint32_t packed[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) packed[i] = pack2<T>(at[2 * i] * inv, at[2 * i + 1] * inv);
    *reinterpret_cast<uint4*>(o + ((size_t)sh * w + row) * D + c0) =
        make_uint4(packed[0], packed[1], packed[2], packed[3]);
  }
  cluster.sync();  // the peers' shared memory outlives rank 0's reads
}

template <typename T>
int launch_split(const void* q, const void* k, const void* v, const int* lengths,
                 void* o, int slots, int heads, int w, int t_max, float sm_scale,
                 cudaStream_t st) {
  const int n = splits(t_max);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n * slots * heads);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = SMEM_BYTES;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t rc = cudaLaunchKernelEx(
      &cfg, decode_multi_split<T>, static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(o), heads, w, t_max, n,
      split_keys(t_max, n), sm_scale);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q/o [slots, heads, w, 64], k/v [slots, heads, t_max, 64], lengths
// [slots, w] int32, all contiguous on the device (q, o, k, v 16-byte
// aligned).  dtype: 0 fp32 (decode_common.cuh's rows_kernel), 1 bf16,
// 2 fp16 (the key-split cluster kernel).  Returns a CUDA error code.
extern "C" int decode_multi(const void* q, const void* k, const void* v,
                            const void* lengths, void* o, int slots,
                            int heads, int w, int t_max, float sm_scale,
                            int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* lens = static_cast<const int*>(lengths);
  if (w < 1 || w > 9) return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case 1:
      return launch_split<__nv_bfloat16>(q, k, v, lens, o, slots, heads, w, t_max,
                                         sm_scale, st);
    case 2:
      return launch_split<__half>(q, k, v, lens, o, slots, heads, w, t_max, sm_scale,
                                  st);
    default: {
      decode::Args a{q, k, v, nullptr, lens, o, heads, w, t_max, 0, 0, sm_scale};
      return decode::launch<false, true>(dtype, a, slots, stream);
    }
  }
}

// The bf16/fp16 kernel's split count at cache length t_max: the CUDA
// blocks (and the cluster size) per (slot, head).
extern "C" int decode_multi_splits(int t_max) { return splits(t_max); }
