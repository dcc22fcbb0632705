// Hopper building blocks of the three tensor-core flash kernels
// (flash_fwd.cu, flash_bwd_dq.cu and flash_bwd_dkv.cu for bf16 and fp16):
// TMA tensor maps over [B*H, T, 64]; the mbarrier ring that carries row
// tiles from a producer warp to the consumer warpgroups (K/V tiles past
// stationary query tiles, or Q/dO tiles past stationary key tiles);
// shared-memory descriptors of 128-byte-swizzled tiles; and
// wgmma.mma_async m64n64k16 with fp32 accumulators.
//
// Layout rules every kernel here relies on:
// - a tile is 64 rows of 64 values of 2 bytes: each row is exactly one
//   128-byte swizzle row, 8 rows one 1024-byte swizzle atom; tiles sit on
//   1024-byte boundaries, so TMA's SWIZZLE_128B placement and the wgmma
//   descriptor's B128 layout agree (descriptor base offset 0);
// - B "K-major" is the natural [row][d] layout, the reduction running
//   along a row (K for Q.K^T, V for dO.V^T, Q for K.Q^T, dO for V.dO^T):
//   a k16 step moves the descriptor by 32 bytes;
// - B "MN-major" (the transpose bit) reduces down the rows (V for P.V, K
//   for dS.K, dO for P^T.dO, Q for dS^T.Q): a k16 step moves 16 rows =
//   2048 bytes;
// - in both, the stride between 8-row groups (SBO) is 1024 bytes;
// - a thread's accumulator element i of an m64n64 fragment sits at row
//   16*warp + lane/4 + 8*((i/2)%2) and column 8*(i/4) + 2*(lane%4) + i%2
//   of the warpgroup's 64 x 64 tile; elements 8kk..8kk+7, packed in pairs,
//   are exactly the A fragment of the k16 step kk of a product whose A is
//   that tile (how P, dS, P^T and dS^T feed the next product from
//   registers).
#pragma once

#include <type_traits>

#include <cuda.h>  // CUtensorMap and its enums only: the driver entry is
                   // fetched at run time, so no -lcuda is needed

#include "flash_common.cuh"

namespace flash {
namespace sm90 {

constexpr int TILE = 64;                  // rows of a tile; keys per step
constexpr int TILE_BYTES = TILE * D * 2;  // 8 KiB of bf16/fp16
constexpr int STAGES = 3;                 // depth of the K/V ring
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// ---------------------------------------------------------------------------
// host: tensor maps
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A [bh, rows, 64] tensor of 2-byte values as a 3-D map with 64 x 64 boxes,
// 128-byte swizzle, zero fill past the end of rows (a ragged last tile never
// reads the next head's rows).  Returns a CUDA error code, 0 on success.
inline int make_map(CUtensorMap* map, const void* base, int bh, int rows,
                    bool fp16) {
  if (reinterpret_cast<uintptr_t>(base) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const EncodeTiled fn = encode_fn();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(rows) * D * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(D), TILE, 1};
  const cuuint32_t estride[3] = {1, 1, 1};
  const CUresult r = fn(
      map, fp16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      3, const_cast<void*>(base), dims, strides, box, estride,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// Raise the kernel's dynamic shared-memory cap (an attribute of the current
// device) before a launch; a refusal is returned, never hidden.
template <typename K>
inline int allow_smem(K kernel, int bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

// Two consumer warpgroups a block (128 rows of the block's own axis:
// queries for the forward and dQ, keys for dK/dV) unless that leaves SMs
// idle: a grid of fewer 128-row blocks than SMs (the serving prefill,
// [1, 12, 512]: 48 blocks) takes 64-row blocks instead.
inline bool two_warpgroups(int bh, int rows) {
  int sms = 132, dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return static_cast<long long>(bh) * ((rows + 2 * TILE - 1) / (2 * TILE)) >= sms;
}

// ---------------------------------------------------------------------------
// device: shared memory, mbarriers, TMA
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the dynamic shared window rounded up to the 1024-byte swizzle atom (the
// launch asks for 1 KiB more than the layout needs)
__device__ __forceinline__ uint8_t* align_1k(uint8_t* p) {
  const uint32_t a = smem_u32(p);
  return p + ((1024u - (a & 1023u)) & 1023u);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// one arrival that also announces the bytes the TMA copies will bring
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// wait for the completion of the barrier's phase of this parity
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// one 64 x 64 box of a map at (row, head) into shared memory
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int row, int head) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(0), "r"(row),
      "r"(head)
      : "memory");
}

// Move registers between warpgroups (sm_90a): the producer gives up what
// the consumers' accumulators take.  Each must run in a branch its
// warpgroup never leaves.
template <int N>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------------
// device: wgmma
// ---------------------------------------------------------------------------

// descriptor of a 1024-byte-aligned, 128-byte-swizzled tile: SBO 1024 bytes,
// LBO 1 (unused: one k16 step and N = 64 both fit in one swizzle row)
__device__ __forceinline__ uint64_t desc(const void* tile) {
  return static_cast<uint64_t>((smem_u32(tile) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) | (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}
// descriptor steps (16-byte units) of one k16 step
constexpr uint64_t K_MAJOR_STEP = 32 >> 4;
constexpr uint64_t MN_MAJOR_STEP = (16 * 128) >> 4;

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving accumulator reads or writes across the
// asynchronous product
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
// the same for packed A fragments: used after the wait of a product that
// reads them from registers, it keeps them live (and their registers
// unreused) while the product runs
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define FLASH_D32                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "   \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, " \
  "%31}"
#define FLASH_OUT32(d)                                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),     \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),            \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),        \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),        \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),        \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),        \
      "+f"(d[31])
#define FLASH_SS(TY)                                                          \
  asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"                 \
               " wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "   \
               FLASH_D32 ", %32, %33, p, 1, 1, 0, %35;\n}\n"                  \
               : FLASH_OUT32(d)                                               \
               : "l"(da), "l"(db), "r"(acc), "n"(TRANS_B))
#define FLASH_RS(TY)                                                          \
  asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"                 \
               " wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "   \
               FLASH_D32 ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"    \
               : FLASH_OUT32(d)                                               \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),         \
                 "r"(acc), "n"(TRANS_B))

// d (+)= A . B, A and B in shared memory; acc = 0 overwrites d
template <typename T, int TRANS_B>
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                       int acc) {
  if constexpr (std::is_same<T, __half>::value) {
    FLASH_SS("f16");
  } else {
    FLASH_SS("bf16");
  }
}

// d += A . B, A from registers (4 packed pairs), B in shared memory
template <typename T, int TRANS_B>
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t* a,
                                       uint64_t db, int acc) {
  if constexpr (std::is_same<T, __half>::value) {
    FLASH_RS("f16");
  } else {
    FLASH_RS("bf16");
  }
}

#undef FLASH_SS
#undef FLASH_RS
#undef FLASH_OUT32
#undef FLASH_D32

// two fp32 values as one packed pair of T (the first in the low half)
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
// the fp32 values of a packed pair
template <typename T>
__device__ __forceinline__ float2 unpack2(uint32_t v);
template <>
__device__ __forceinline__ float2 unpack2<__nv_bfloat16>(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}
template <>
__device__ __forceinline__ float2 unpack2<__half>(uint32_t v) {
  return __half22float2(*reinterpret_cast<__half2*>(&v));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// accumulator element i's row (within the warpgroup's 64) and column
__device__ __forceinline__ int acc_row(int i, int warp, int lane) {
  return 16 * warp + (lane >> 2) + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int i, int lane) {
  return 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
}

// ---------------------------------------------------------------------------
// shared-memory plan of one block: NS stationary tensors of NWG row tiles
// each (Q, and dO for dQ; K and V for dK/dV), the ring of two tensors'
// tiles (K/V; Q/dO) with NR fp32 rows of 64 per stage (the key mask; lse
// and delta), the barriers
// ---------------------------------------------------------------------------

template <int NWG, int NS, int NR>
struct Plan {
  static constexpr int STAT = 0;                               // stationary
  static constexpr int RING0 = STAT + NS * NWG * TILE_BYTES;   // ring: 1st
  static constexpr int RING1 = RING0 + STAGES * TILE_BYTES;    // ring: 2nd
  static constexpr int ROWS = RING1 + STAGES * TILE_BYTES;     // fp32 rows
  static constexpr int BAR = ROWS + STAGES * NR * TILE * 4;
  static constexpr int BYTES = BAR + (1 + 2 * STAGES) * 8;
  static constexpr int LAUNCH_BYTES = BYTES + 1024;  // + alignment slack
};

// The producer warp: the NS stationary tensors' NWG tiles once (rows s0,
// s0 + 64, ...; s_b unused when NS is 1), then ring tile t of r_a and r_b
// (rows r0 + 64 t) into stage t % STAGES by TMA (lane 0) and its NR fp32
// rows by all 32 lanes (`rows(stage_rows, first_row, lane)`), waiting for
// the consumers to free a stage before refilling it.
template <int NWG, int NS, int NR, typename Rows>
__device__ __forceinline__ void produce(uint8_t* sm, const CUtensorMap* s_a,
                                        const CUtensorMap* s_b,
                                        const CUtensorMap* r_a,
                                        const CUtensorMap* r_b, int bh, int s0,
                                        int r0, int ntiles, Rows rows) {
  using P = Plan<NWG, NS, NR>;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + P::BAR);
  uint64_t* sbar = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + STAGES;
  float* rws = reinterpret_cast<float*>(sm + P::ROWS);
  const int lane = threadIdx.x & 31;
  if (lane == 0) {
    mbar_expect_tx(sbar, NS * NWG * TILE_BYTES);
    for (int w = 0; w < NWG; ++w) {
      tma_load(sm + P::STAT + w * TILE_BYTES, s_a, sbar, s0 + TILE * w, bh);
      if (NS == 2)
        tma_load(sm + P::STAT + (NWG + w) * TILE_BYTES, s_b, sbar, s0 + TILE * w, bh);
    }
  }
  for (int t = 0; t < ntiles; ++t) {
    const int s = t % STAGES;
    if (t >= STAGES) mbar_wait(&empty[s], ((t / STAGES) - 1) & 1);
    const int row0 = r0 + t * TILE;
    rows(rws + s * NR * TILE, row0, lane);
    if (lane == 0) {
      mbar_expect_tx(&full[s], 2 * TILE_BYTES);
      tma_load(sm + P::RING0 + s * TILE_BYTES, r_a, &full[s], row0, bh);
      tma_load(sm + P::RING1 + s * TILE_BYTES, r_b, &full[s], row0, bh);
    } else {
      mbar_arrive(&full[s]);
    }
  }
}

// The forward's and dQ's stage rows: the key-mask values of the stage's 64
// keys (nothing without a mask).
struct KeyMaskRows {
  int bh, tk;
  Mask mk;
  __device__ __forceinline__ void operator()(float* dst, int k0, int lane) const {
    if (mk.kmask != nullptr) {
      dst[lane] = key_mask(bh, k0 + lane, tk, mk);
      dst[32 + lane] = key_mask(bh, k0 + 32 + lane, tk, mk);
    }
  }
};

// barriers: the stationary tiles (one arrival + bytes), each stage's
// "full" (the producer warp's 32 lanes + bytes) and "empty" (one arrival
// per consumer warp)
template <int NWG, int NS, int NR>
__device__ __forceinline__ void init_barriers(uint8_t* sm) {
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + Plan<NWG, NS, NR>::BAR);
  if (threadIdx.x == 0) {
    mbar_init(&bars[0], 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&bars[1 + s], 32);
      mbar_init(&bars[1 + STAGES + s], 4 * NWG);
    }
    mbar_init_fence();
  }
  __syncthreads();
}

// the keys a block of query rows [q0, q0 + rows) walks: below kv_length and
// tk, and (causal) at or below its last row's diagonal
__device__ __forceinline__ int key_end(int q0, int rows, int tk, const Mask& mk) {
  int kend = min(tk, mk.seq_len);
  if (mk.causal) kend = min(kend, q0 + rows);
  return max(kend, 0);
}

}  // namespace sm90
}  // namespace flash
