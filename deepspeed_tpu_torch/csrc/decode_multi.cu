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
// What the design does about it (bf16 and fp16): decode_split.cuh's
// kernel with the slot map (`SlotRows`: key j of (slot, head) sh is row
// sh * T + j).  The key axis of each (slot, head) is split over N CUDA
// blocks of one thread-block cluster, N = ceil(T / 256) clamped to 1..8
// (4 at the serving shape, 384 blocks); 64-key tiles come through a
// cp.async ring and run on mma.sync with Q held as A fragments, P rounded
// once to the input type, as the JAX kernel's `p.astype(v.dtype)` does;
// the N blocks' states merge in distributed shared memory.  The paged
// kernels (decode_paged.cu, decode_paged_multi.cu) are the same kernel
// with the page-table map, and the single-query decode_attention.cu the
// same map at W = 1.
//
// The fp32 arm keeps decode_common.cuh's `rows_kernel` (one block per
// (slot, head), fp32 FMAs): the tensor cores would take fp32 only as TF32,
// and the fp32 arm is held to 1e-4 of the plain version.
#include "decode_common.cuh"
#include "decode_split.cuh"

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
  if (dtype == 0) {
    decode::Args a{q, k, v, nullptr, lens, o, heads, w, t_max, 0, 0, sm_scale};
    return decode::launch<false, true>(a, slots, stream);
  }
  decode_split::Args a{q, k, v, nullptr, nullptr, nullptr, lens, o, heads, w, t_max,
                       0, 0, 0, 0, sm_scale};
  return decode_split::launch_typed<decode_split::SlotRows, false>(dtype, a, slots, st);
}

// The split count of decode_split.cuh's kernel, the bf16/fp16 arms of this
// file, decode_attention.cu, decode_paged.cu and decode_paged_multi.cu, at
// cache length t_max (T, or max_pages * page_len) over `pairs` (slot, head)
// pairs: the CUDA blocks (and the cluster size) per pair.
extern "C" int decode_splits(int t_max, int pairs) {
  return decode_split::splits(t_max, pairs);
}
