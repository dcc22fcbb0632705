// Single-query decode attention over the paged KV pool for Hopper (sm_90a),
// head_dim 64.
//
// Replaces the Pallas TPU kernel deepspeed_tpu/ops/pallas/decode_attention.py
// `_decode_paged_kernel` (launched by `_decode_paged_pallas` through
// `pl.pallas_call`; API `decode_attention_paged`), both arms: one new query
// per (slot, head) against the slot's K/V rows in a flat pool
// [P, H, page_len, 64], found through the slot's page table, masked to a
// per-slot live length read from device memory.  A length-0 slot outputs
// exact zeros.  `decode_paged` is the fp arm; `decode_paged_int8` the int8
// pool arm (`:313-359`), whose per-row fp32 scales fold into the scores
// and probabilities.
//
// The TPU kernel streamed one page per grid step through a scalar-prefetched
// table and an (8, 128)-tiled query broadcast; here each block reads its own
// table entries and length on the device and walks only the live keys, any
// page_len from 1 to 128, a key step crossing pages freely.  The body,
// its bound and its design are in decode_common.cuh.
#include "decode_common.cuh"

// q/o [slots, heads, 64], pools [pages, heads, page_len, 64], table
// [slots, max_pages] int32, lengths [slots] int32, all contiguous on the
// device.  dtype: 0 fp32, 1 bf16, 2 fp16.  Returns cudaGetLastError().
extern "C" int decode_paged(const void* q, const void* k_pages,
                            const void* v_pages, const void* table,
                            const void* lengths, void* o, int slots,
                            int heads, int pages, int page_len, int max_pages,
                            float sm_scale, int dtype, void* stream) {
  (void)pages;
  decode::Args a{q, k_pages, v_pages, static_cast<const int*>(table),
                 static_cast<const int*>(lengths), o, heads, 1, 0, page_len,
                 max_pages, sm_scale};
  return decode::launch<true, false>(dtype, a, slots, stream);
}

// The int8 pool arm: pools int8 [pages, heads, page_len, 64] with fp32
// k_scale / v_scale [pages, heads, page_len]; q/o fp32, bf16 or fp16
// (dtype as above), the other operands as in decode_paged.
extern "C" int decode_paged_int8(const void* q, const void* k_pages,
                                 const void* v_pages, const void* k_scale,
                                 const void* v_scale, const void* table,
                                 const void* lengths, void* o, int slots,
                                 int heads, int pages, int page_len,
                                 int max_pages, float sm_scale, int dtype,
                                 void* stream) {
  (void)pages;
  decode::Args a{q, k_pages, v_pages, static_cast<const int*>(table),
                 static_cast<const int*>(lengths), o, heads, 1, 0, page_len,
                 max_pages, sm_scale, static_cast<const float*>(k_scale),
                 static_cast<const float*>(v_scale)};
  return decode::launch<true, false, true>(dtype, a, slots, stream);
}
