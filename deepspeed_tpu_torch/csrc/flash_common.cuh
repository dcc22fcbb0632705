// Shared math of the three flash-attention kernels (flash_fwd.cu,
// flash_bwd_dq.cu, flash_bwd_dkv.cu): the dtype conversions, the dropout
// hash, the batch*head id map and the masked score.
//
// This is the counterpart of the single-source helpers of
// deepspeed_tpu/ops/pallas/flash_attention.py (`_fmix32`,
// `dropout_keep_mask`, `_grid_bh`, `_masked_scores`): the forward and both
// backward kernels must see bit-identical masks, or the gradients come out
// silently wrong.  Every kernel includes this header and nothing else
// defines that math.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr int D = 64;  // head_dim, the only one the kernels take
constexpr float NEG_INF = -1e30f;
// a row whose max score never rose above this had no valid key: forward
// output hard-zeroed, lse = +DEAD_LSE, so the backward's p underflows to 0
constexpr float DEAD_ROW_THRESH = -1e9f * 0.5f;
constexpr float DEAD_LSE = 1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) { return __float2half(x); }

// The masking and dropout arguments every kernel takes, by value.
struct Mask {
  const float* kmask;  // additive fp32 key mask [bh, tk], or nullptr
  int seq_len;         // keys at or past it are invalid (kv_length)
  int causal;
  float sm_scale;
  int dropout;         // 0: no dropout
  uint32_t seed;
  uint32_t thresh;     // keep iff hash >= thresh (computed on the host)
  float keep_div;      // 1 - rate: kept probabilities are divided by it
  uint32_t bh_base;    // hash batch*head id: base + (g / period) * stride
  int bh_period;       //                        + g % period
  uint32_t bh_stride;
};

inline Mask make_mask(const void* kmask, int kv_len, float sm_scale, int causal,
                      int dropout, unsigned seed, unsigned thresh, float keep_div,
                      unsigned bh_base, int bh_period, unsigned bh_stride) {
  Mask m;
  m.kmask = static_cast<const float*>(kmask);
  m.seq_len = kv_len;
  m.causal = causal;
  m.sm_scale = sm_scale;
  m.dropout = dropout;
  m.seed = seed;
  m.thresh = thresh;
  m.keep_div = keep_div;
  m.bh_base = bh_base;
  m.bh_period = bh_period;
  m.bh_stride = bh_stride;
  return m;
}

// murmur3 finalizer (`_fmix32`); uint32 products wrap as in the JAX hash
__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// `dropout_keep_mask` split by what varies: a row's term (qi * golden), a
// grid row's salt (bh * c1 ^ seed) and the key; x ^ a ^ b == x ^ (a ^ b), so
// keep_at(row_term(qi), kj, salt(bh)) equals the JAX hash bit for bit
constexpr uint32_t GOLDEN = 0x9E3779B9u;  // row_term's multiplier
__device__ __forceinline__ uint32_t row_term(int qi) {
  return static_cast<uint32_t>(qi) * GOLDEN;
}
__device__ __forceinline__ uint32_t salt(uint32_t bh, const Mask& m) {
  return (bh * 0x85EBCA6Bu) ^ m.seed;
}
__device__ __forceinline__ bool keep_at(uint32_t row, int kj, uint32_t salt,
                                        uint32_t thresh) {
  return fmix32((row + static_cast<uint32_t>(kj)) ^ salt) >= thresh;
}

// `dropout_keep_mask` for one (query, key) pair of global positions
__device__ __forceinline__ bool keep(int qi, int kj, uint32_t bh, const Mask& m) {
  return keep_at(row_term(qi), kj, salt(bh, m), m.thresh);
}

// `_grid_bh`: the hash's batch*head id of grid row g
__device__ __forceinline__ uint32_t bh_id(int g, const Mask& m) {
  return m.bh_base + static_cast<uint32_t>(g / m.bh_period) * m.bh_stride +
         static_cast<uint32_t>(g % m.bh_period);
}

// `_masked_scores` for one pair: scale, additive key mask (km = 0 without
// one), then the validity floor (kv_length, causal)
__device__ __forceinline__ float masked_score(float dot, float km, int qi, int kj,
                                              const Mask& m) {
  const float s = dot * m.sm_scale + km;
  const bool valid = kj < m.seq_len && (!m.causal || kj <= qi);
  return valid ? s : NEG_INF;
}

// the key-mask value of key kj of grid row bh (0 without a mask)
__device__ __forceinline__ float key_mask(int bh, int kj, int tk, const Mask& m) {
  return (m.kmask != nullptr && kj < tk) ? m.kmask[(size_t)bh * tk + kj] : 0.f;
}

}  // namespace flash
