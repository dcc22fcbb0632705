// The fp32 decode-attention core: the fp32 arms of csrc/decode_paged.cu,
// csrc/decode_paged_multi.cu (both with their int8 pool arms under fp32
// queries), csrc/decode_multi.cu and csrc/decode_attention.cu (Hopper,
// sm_90a, head_dim 64).  Their bf16/fp16 arms run decode_split.cuh's
// key-split tensor-core kernel; the tensor cores would take fp32 only as
// TF32, and the fp32 arms are held to 1e-4 of their plain versions, so
// fp32 stays on FMAs here.
//
// One thread block per (slot, head) attends W query rows (W = 1 for a
// decode tick, W = k+1 <= 9 for a speculative verify pass) against the
// slot's cached keys, each row over its own live length read from device
// memory.  The keys come from a slot cache [S, H, T, 64] or, PAGED, from a
// flat pool [P, H, page_len, 64] through the slot's page table: position p
// is row p % page_len of page table[s, p / page_len].
//
// What bounds it on the H100: bytes.  Each live key costs 2*64 elements of
// K and V read once against 4*64*W flops, a few flops per byte, so the
// kernel is a stream over the live cache at 3.35 TB/s.
//
// The design:
// - the block reads its row lengths on the device and walks only the keys
//   below the longest one: a short slot costs what it holds, and a paged
//   slot never reads a table column at or past ceil(len / page_len) (those
//   entries are the scratch page 0, or garbage);
// - a warp takes four keys at a time, one per group of eight lanes, each
//   lane holding eight of the 64 dims: two 16-byte loads per lane read a
//   whole 256-byte fp32 key row per group, and a dot product needs only
//   three shuffles; a key step may cross a page boundary, since every key
//   finds its own page;
// - every (group, row) keeps its own fp32 online-softmax state; the four
//   groups of a warp merge with shuffles, the eight warps in shared memory;
// - a row that is masked for a key another row still attends gets p = 0
//   explicitly (never exp(-inf - -inf)); a length-0 row outputs exact zeros;
// - no host sync: lengths and tables stay on the device, the launch is
//   asynchronous.
//
// The int8 arm (QUANT, paged only: serving.quantization.kv='int8') reads
// int8 K/V rows plus one fp32 scale per (page, head, row) from k_scale /
// v_scale [P, H, page_len], through the same table indirection as the
// rows.  The scales fold into the score and the probability as the TPU
// kernel folds them (decode_attention.py:336-359): s = (q.k8) * sm_scale
// * ks, acc += (p * vs) * v8, while l sums p alone; the page is never
// dequantized into memory.  A lane reads its eight int8 dims with one
// 8-byte load, so a group of eight lanes reads the 64-byte row.
#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace decode {

constexpr int D = 64;          // head_dim
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int GROUPS = 4;      // keys a warp takes per step (8 lanes each)
constexpr int STEP = WARPS * GROUPS;
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

// eight consecutive elements (16-byte aligned) as floats
__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
// eight consecutive int8 values (8-byte aligned) as floats
__device__ __forceinline__ void load8(const int8_t* p, float (&x)[8]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const int8_t* b = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] = static_cast<float>(b[i]);
}

struct Args {
  const void* q;        // [S, H, W, 64]
  const void* k;        // [S, H, T, 64] or PAGED [P, H, page_len, 64]
  const void* v;
  const int* table;     // PAGED: [S, max_pages]
  const int* lengths;   // [S, W]
  void* o;              // [S, H, W, 64]
  int heads, w;
  int t_max;            // unpaged: the cache stride T
  int page_len, max_pages;
  float sm_scale;
  const float* k_scale;  // QUANT: [P, H, page_len]
  const float* v_scale;
};

// fp32 queries and output; TKV: the K/V type, float or (QUANT) int8_t.
// WT: W rounded up to a compiled row count; rows w >= a.w have length 0
template <typename TKV, int WT, bool PAGED>
__global__ void __launch_bounds__(THREADS) rows_kernel(Args a) {
  constexpr bool QUANT = std::is_same<TKV, int8_t>::value;
  static_assert(!QUANT || PAGED, "the int8 pool is paged only");
  __shared__ float sq[WT][D];
  __shared__ int slen[WT];
  __shared__ float sm[WT][WARPS], sl[WT][WARPS];
  __shared__ float sacc[WT][WARPS][D];

  const int sh = blockIdx.x;  // slot * heads + head
  const int s = sh / a.heads;
  const int h = sh - s * a.heads;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 3, sub = lane & 7;
  const int cap = PAGED ? a.page_len * a.max_pages : a.t_max;

  const float* q = static_cast<const float*>(a.q);
  for (int i = tid; i < WT * D; i += THREADS) {
    const int w = i / D;
    sq[w][i % D] = w < a.w ? q[((size_t)sh * a.w + w) * D + i % D]
                           : 0.f;
  }
  if (tid < WT)
    slen[tid] = tid < a.w ? min(max(a.lengths[s * a.w + tid], 0), cap) : 0;
  __syncthreads();

  int len[WT];
  int maxlen = 0;
#pragma unroll
  for (int w = 0; w < WT; ++w) {
    len[w] = slen[w];
    maxlen = max(maxlen, len[w]);
  }
  float m[WT], l[WT], acc[WT][8];
#pragma unroll
  for (int w = 0; w < WT; ++w) {
    m[w] = NEG_INF;
    l[w] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[w][i] = 0.f;
  }

  const TKV* kb = static_cast<const TKV*>(a.k);
  const TKV* vb = static_cast<const TKV*>(a.v);
  for (int base = warp * GROUPS; base < maxlen; base += STEP) {
    const int j = base + grp;  // this group's key
    float kk[8], vv[8];
    float ks = 1.f, vs = 1.f;  // the row's scales (QUANT)
    if (j < maxlen) {
      size_t row;
      if (PAGED) {
        const int page = a.table[(size_t)s * a.max_pages + j / a.page_len];
        row = ((size_t)page * a.heads + h) * a.page_len + j % a.page_len;
      } else {
        row = (size_t)sh * a.t_max + j;
      }
      load8(kb + row * D + sub * 8, kk);
      load8(vb + row * D + sub * 8, vv);
      if (QUANT) {  // one scale per row: no Dh factor in the index
        ks = a.k_scale[row];
        vs = a.v_scale[row];
      }
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) kk[i] = vv[i] = 0.f;
    }
#pragma unroll
    for (int w = 0; w < WT; ++w) {
      const float* qw = &sq[w][sub * 8];
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) part = fmaf(qw[i], kk[i], part);
      part += __shfl_xor_sync(FULL, part, 1);
      part += __shfl_xor_sync(FULL, part, 2);
      part += __shfl_xor_sync(FULL, part, 4);
      const bool valid = j < len[w];
      float sc = part * a.sm_scale;
      if (QUANT) sc *= ks;
      sc = valid ? sc : NEG_INF;
      const float mt = fmaxf(m[w], sc);
      const float alpha = expf(m[w] - mt);
      // masked explicitly: a row with no live key yet has mt == NEG_INF
      const float p = valid ? expf(sc - mt) : 0.f;
      l[w] = fmaf(l[w], alpha, p);
      const float pv = QUANT ? p * vs : p;
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[w][i] = fmaf(acc[w][i], alpha, pv * vv[i]);
      m[w] = mt;
    }
  }

  // merge the four groups of the warp (a state with l == 0 saw no key)
#pragma unroll
  for (int off = 8; off < 32; off <<= 1) {
#pragma unroll
    for (int w = 0; w < WT; ++w) {
      const float m2 = __shfl_xor_sync(FULL, m[w], off);
      const float l2 = __shfl_xor_sync(FULL, l[w], off);
      const float mx = fmaxf(m[w], m2);
      const float f1 = l[w] > 0.f ? expf(m[w] - mx) : 0.f;
      const float f2 = l2 > 0.f ? expf(m2 - mx) : 0.f;
      l[w] = l[w] * f1 + l2 * f2;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float a2 = __shfl_xor_sync(FULL, acc[w][i], off);
        acc[w][i] = acc[w][i] * f1 + a2 * f2;
      }
      m[w] = mx;
    }
  }
  if (grp == 0) {
#pragma unroll
    for (int w = 0; w < WT; ++w) {
#pragma unroll
      for (int i = 0; i < 8; ++i) sacc[w][warp][sub * 8 + i] = acc[w][i];
      if (sub == 0) {
        sm[w][warp] = m[w];
        sl[w][warp] = l[w];
      }
    }
  }
  __syncthreads();

  // merge the eight warps: warp r finishes rows r, r + 8
  float* o = static_cast<float*>(a.o);
  for (int w = warp; w < a.w; w += WARPS) {
    float mx = NEG_INF;
#pragma unroll
    for (int i = 0; i < WARPS; ++i) mx = fmaxf(mx, sm[w][i]);
    float lt = 0.f, o0 = 0.f, o1 = 0.f;
#pragma unroll
    for (int i = 0; i < WARPS; ++i) {
      const float f = sl[w][i] > 0.f ? expf(sm[w][i] - mx) : 0.f;
      lt = fmaf(sl[w][i], f, lt);
      o0 = fmaf(sacc[w][i][2 * lane], f, o0);
      o1 = fmaf(sacc[w][i][2 * lane + 1], f, o1);
    }
    // length 0: no key seen, lt == 0 -> exact zeros
    *reinterpret_cast<float2*>(o + ((size_t)sh * a.w + w) * D + 2 * lane) =
        make_float2(lt > 0.f ? o0 / lt : 0.f, lt > 0.f ? o1 / lt : 0.f);
  }
}

// The fp32 arms: q/o fp32, K/V fp32 or (QUANT) int8.  Returns
// cudaGetLastError().
template <bool PAGED, bool MULTI, bool QUANT = false>
int launch(const Args& a, int slots, void* stream) {
  using TKV = std::conditional_t<QUANT, int8_t, float>;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(slots * a.heads);
  if (a.w == 1) {
    rows_kernel<TKV, 1, PAGED><<<grid, THREADS, 0, st>>>(a);
  } else if (!MULTI) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else if constexpr (MULTI) {
    if (a.w <= 2)
      rows_kernel<TKV, 2, PAGED><<<grid, THREADS, 0, st>>>(a);
    else if (a.w <= 3)
      rows_kernel<TKV, 3, PAGED><<<grid, THREADS, 0, st>>>(a);
    else if (a.w <= 5)
      rows_kernel<TKV, 5, PAGED><<<grid, THREADS, 0, st>>>(a);
    else if (a.w <= 9)
      rows_kernel<TKV, 9, PAGED><<<grid, THREADS, 0, st>>>(a);
    else
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace decode
