// Single-query decode attention over the slot KV cache for Hopper (sm_90a),
// head_dim 64.
//
// Replaces the Pallas TPU kernel deepspeed_tpu/ops/pallas/decode_attention.py
// `_decode_kernel` (launched by `_decode_pallas` through `pl.pallas_call`):
// one new query per (slot, head) against that slot's cached keys
// k/v [S, H, T, 64], with a per-slot live length read from device memory.
// Keys at or past the length are never attended, and a length-0 slot (a
// free slot riding along in the static batch) outputs exact zeros.
//
// What bounds it on the H100: bytes.  Each live key costs 2*64 elements of
// K and V read once against 4*64 flops, about one flop per byte in bf16, so
// the kernel is a stream over the live cache at 3.35 TB/s.
//
// What the design does about it:
// - each block reads lengths[s] itself and walks only the keys [0, length):
//   the TPU kernel streamed the whole max_seq_len stride of every slot
//   (its block index maps could not read a traced length); this one reads
//   only the live rows, so a short slot costs what it holds;
// - one block per (slot, head), eight warps; a warp takes four keys at a
//   time, each lane holding two of the 64 dims, so one key row is one
//   coalesced 128-byte (bf16) read, and the four loads are issued before
//   the shuffle reductions that need them;
// - each warp keeps its own fp32 online-softmax state (m, l, 64-wide
//   accumulator); the eight states merge once in shared memory at the end;
// - no host sync: lengths stay on the device, the launch is asynchronous.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int D = 64;   // head_dim: two dims per lane
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int KPW = 4;  // keys a warp takes per step
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load2(const __half* p) {
  return __half22float2(*reinterpret_cast<const __half2*>(p));
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(__half* p, float a, float b) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ lengths,
              T* __restrict__ o, int heads, int t_max, float sm_scale) {
  __shared__ float sm[WARPS], sl[WARPS];
  __shared__ float sacc[WARPS][D];

  const int sh = blockIdx.x;  // slot * heads + head
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int len = min(max(lengths[sh / heads], 0), t_max);

  const float2 qv = load2(q + (size_t)sh * D + 2 * lane);
  const T* kb = k + (size_t)sh * t_max * D + 2 * lane;
  const T* vb = v + (size_t)sh * t_max * D + 2 * lane;

  float m = NEG_INF, l = 0.f, a0 = 0.f, a1 = 0.f;
  for (int base = warp * KPW; base < len; base += WARPS * KPW) {
    float s[KPW];
    float2 vv[KPW];
#pragma unroll
    for (int i = 0; i < KPW; ++i) {
      const int j = base + i;
      if (j < len) {
        const float2 kk = load2(kb + (size_t)j * D);
        vv[i] = load2(vb + (size_t)j * D);
        s[i] = fmaf(qv.x, kk.x, qv.y * kk.y);
      } else {
        vv[i] = make_float2(0.f, 0.f);
        s[i] = 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < KPW; ++i) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s[i] += __shfl_xor_sync(0xffffffffu, s[i], off);
    }
    // key `base` is live (loop condition), so mt is a real score and the
    // masked keys' exp underflows to exactly 0
    float mt = m;
#pragma unroll
    for (int i = 0; i < KPW; ++i) {
      s[i] = (base + i < len) ? s[i] * sm_scale : NEG_INF;
      mt = fmaxf(mt, s[i]);
    }
    const float alpha = expf(m - mt);
    l *= alpha;
    a0 *= alpha;
    a1 *= alpha;
#pragma unroll
    for (int i = 0; i < KPW; ++i) {
      const float p = expf(s[i] - mt);
      l += p;
      a0 = fmaf(p, vv[i].x, a0);
      a1 = fmaf(p, vv[i].y, a1);
    }
    m = mt;
  }

  if (lane == 0) {
    sm[warp] = m;
    sl[warp] = l;
  }
  sacc[warp][2 * lane] = a0;
  sacc[warp][2 * lane + 1] = a1;
  __syncthreads();
  if (warp != 0) return;

  float mx = NEG_INF;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, sm[w]);
  float lt = 0.f, o0 = 0.f, o1 = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    // a warp that saw no key has l == 0 and contributes nothing
    const float f = sl[w] > 0.f ? expf(sm[w] - mx) : 0.f;
    lt = fmaf(sl[w], f, lt);
    o0 = fmaf(sacc[w][2 * lane], f, o0);
    o1 = fmaf(sacc[w][2 * lane + 1], f, o1);
  }
  // length 0: no warp saw a key, lt == 0 -> exact zeros
  const float r0 = lt > 0.f ? o0 / lt : 0.f;
  const float r1 = lt > 0.f ? o1 / lt : 0.f;
  store2(o + (size_t)sh * D + 2 * lane, r0, r1);
}

}  // namespace

// dtype: 0 fp32, 1 bf16, 2 fp16.  q/o are [slots*heads, 64], k/v
// [slots*heads, t_max, 64], lengths [slots] int32, all contiguous on the
// device.  Returns cudaGetLastError().
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* lengths, void* o, int slots,
                                int heads, int t_max, float sm_scale,
                                int dtype, void* stream) {
  const dim3 grid(slots * heads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  switch (dtype) {
    case 0:
      decode_kernel<float><<<grid, THREADS, 0, st>>>(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), len, static_cast<float*>(o), heads,
          t_max, sm_scale);
      break;
    case 1:
      decode_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
          static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
          static_cast<const __nv_bfloat16*>(v), len,
          static_cast<__nv_bfloat16*>(o), heads, t_max, sm_scale);
      break;
    case 2:
      decode_kernel<__half><<<grid, THREADS, 0, st>>>(
          static_cast<const __half*>(q), static_cast<const __half*>(k),
          static_cast<const __half*>(v), len, static_cast<__half*>(o), heads,
          t_max, sm_scale);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
