// Shared code of the three block-sparse attention kernels
// (block_sparse_fwd.cu, block_sparse_bwd_dq.cu, block_sparse_bwd_dkv.cu):
// the lookup-table walk and the tile geometry of each sparsity block size.
//
// Counterpart of deepspeed_tpu/ops/pallas/block_sparse_attention.py's LUT
// plumbing (`build_kernel_luts` arrays read through scalar prefetch in the
// BlockSpec index maps).  Here the tables live in device memory: a CUDA
// block reads its own row's count once and then exactly that many entries,
// so the TPU grid's `width` steps per row (most of them skipped padding)
// become a loop of `count` steps.  The dtype conversions come from
// flash_common.cuh.
#pragma once

#include "flash_common.cuh"

namespace block_sparse {

using flash::D;
using flash::from_f;
using flash::to_f;

// the output of a query row with no active key block (and its lse), as in
// the TPU kernel's finalize step
constexpr float NEG_INF = -1e30f;

// A lookup table [lut_heads, nb, width] int32 with its counts [lut_heads,
// nb]: the row LUT (`cols`/`nvalid`) for the forward and dQ passes, the
// transposed one (`rows_t`/`nvalid_t`) for dK/dV.  Head-uniform layouts
// are deduplicated to one plane on the host (lut_heads = 1); otherwise
// lut_heads = heads and batch*head row bh reads plane bh % heads.
struct Lut {
  const int* idx;
  const int* count;
  int heads;
  int lut_heads;
  int nb;
  int width;
};

__device__ __forceinline__ int lut_plane(int bh, const Lut& L) {
  return L.lut_heads > 1 ? bh % L.heads : 0;
}

__device__ __forceinline__ int lut_count(int plane, int r, const Lut& L) {
  return L.count[(size_t)plane * L.nb + r];
}

__device__ __forceinline__ int lut_entry(int plane, int r, int w, const Lut& L) {
  return L.idx[((size_t)plane * L.nb + r) * L.width + w];
}

// Tile geometry of sparsity block size BLOCK (16, 32, 64 or 128).
//   ROWS     rows (query rows, or key rows for dK/dV) one CUDA block owns:
//            the whole sparsity block up to 64, half of a 128-block;
//   SUB      CUDA blocks per sparsity block row;
//   KT       keys (queries for dK/dV) staged per shared-memory tile;
//   NT       tiles per active sparsity block;
//   THREADS  four per owned row, each holding a quarter of the tile's
//            columns and a quarter of the output columns.
template <int BLOCK>
struct Tile {
  static_assert(BLOCK == 16 || BLOCK == 32 || BLOCK == 64 || BLOCK == 128,
                "block must be 16, 32, 64 or 128");
  static constexpr int ROWS = BLOCK < 64 ? BLOCK : 64;
  static constexpr int SUB = BLOCK / ROWS;
  static constexpr int KT = BLOCK < 32 ? BLOCK : 32;
  static constexpr int NT = BLOCK / KT;
  static constexpr int THREADS = 4 * ROWS;
  static constexpr int CPT = KT / 4;  // tile columns per thread
  static constexpr int OPT = D / 4;   // output columns per thread
};

// the four threads of one row are adjacent lanes of one warp
__device__ __forceinline__ float row_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Stage rows [r0, r0 + KT) of two [t, 64] operands in shared memory as
// fp32 (rows padded to PITCH floats so a warp's four column groups hit
// distinct banks).
template <typename T, int KT, int PITCH, int THREADS>
__device__ __forceinline__ void stage2(float (*a)[PITCH], float (*b)[PITCH],
                                       const T* __restrict__ ga,
                                       const T* __restrict__ gb, int r0) {
  for (int i = threadIdx.x; i < KT * D; i += THREADS) {
    const int r = i / D, c = i % D;
    const size_t off = (size_t)(r0 + r) * D + c;
    a[r][c] = to_f(ga[off]);
    b[r][c] = to_f(gb[off]);
  }
}

}  // namespace block_sparse
