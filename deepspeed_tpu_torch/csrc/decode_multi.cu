// Multi-query decode attention over the slot KV cache for Hopper (sm_90a),
// head_dim 64: the speculative verify pass.
//
// Replaces the Pallas TPU kernel deepspeed_tpu/ops/pallas/decode_attention.py
// `_decode_multi_kernel` (launched by `_decode_multi_pallas` through
// `pl.pallas_call`; API `decode_attention_multi`): W = k+1 <= 9 queries per
// (slot, head) against k/v [S, H, T, 64], query w over its own live length
// lengths[s, w] read from device memory; a length-0 row outputs exact zeros.
//
// The TPU kernel padded the W rows to a multiple of 8 sublanes and broadcast
// the lengths into [S, Wp, 128] tiles for Mosaic; here the lengths stay
// [S, W] int32, the block walks the keys below its longest row once and
// masks each row's probabilities to 0 past its own length.  The body, its
// bound and its design are in decode_common.cuh.
#include "decode_common.cuh"

// q/o [slots, heads, w, 64], k/v [slots, heads, t_max, 64], lengths
// [slots, w] int32, all contiguous on the device.  dtype: 0 fp32, 1 bf16,
// 2 fp16.  Returns cudaGetLastError().
extern "C" int decode_multi(const void* q, const void* k, const void* v,
                            const void* lengths, void* o, int slots,
                            int heads, int w, int t_max, float sm_scale,
                            int dtype, void* stream) {
  decode::Args a{q, k, v, nullptr, static_cast<const int*>(lengths), o,
                 heads, w, t_max, 0, 0, sm_scale};
  return decode::launch<false, true>(dtype, a, slots, stream);
}
