// Multi-query decode attention over the paged KV pool for Hopper (sm_90a),
// head_dim 64: the speculative verify pass of the paged engine.
//
// Replaces the Pallas TPU kernel deepspeed_tpu/ops/pallas/decode_attention.py
// `_decode_paged_multi_kernel` (launched by `_decode_paged_multi_pallas`
// through `pl.pallas_call`; API `decode_attention_paged_multi`), both arms:
// W = k+1 <= 9 queries per (slot, head) against the slot's K/V rows in a
// flat pool [P, H, page_len, 64] through its page table, query w over its
// own live length lengths[s, w]; a length-0 row outputs exact zeros.
// `decode_paged_multi` is the fp arm; `decode_paged_multi_int8` the int8
// pool arm (`:670-711`), the speculative verify pass on an int8 pool.
//
// No TPU layout tricks carried over: no 8-row query padding, no [S, Wp, 128]
// length tiles, no scalar-prefetch grid; each block reads its lengths and
// table entries on the device and walks only the keys below its longest
// row, a key step crossing pages freely.  The body, its bound and its
// design are in decode_common.cuh.
#include "decode_common.cuh"

// q/o [slots, heads, w, 64], pools [pages, heads, page_len, 64], table
// [slots, max_pages] int32, lengths [slots, w] int32, all contiguous on the
// device.  dtype: 0 fp32, 1 bf16, 2 fp16.  Returns cudaGetLastError().
extern "C" int decode_paged_multi(const void* q, const void* k_pages,
                                  const void* v_pages, const void* table,
                                  const void* lengths, void* o, int slots,
                                  int heads, int w, int pages, int page_len,
                                  int max_pages, float sm_scale, int dtype,
                                  void* stream) {
  (void)pages;
  decode::Args a{q, k_pages, v_pages, static_cast<const int*>(table),
                 static_cast<const int*>(lengths), o, heads, w, 0, page_len,
                 max_pages, sm_scale};
  return decode::launch<true, true>(dtype, a, slots, stream);
}

// The int8 pool arm: pools int8 [pages, heads, page_len, 64] with fp32
// k_scale / v_scale [pages, heads, page_len]; q/o fp32, bf16 or fp16
// (dtype as above), the other operands as in decode_paged_multi.
extern "C" int decode_paged_multi_int8(const void* q, const void* k_pages,
                                       const void* v_pages,
                                       const void* k_scale,
                                       const void* v_scale, const void* table,
                                       const void* lengths, void* o,
                                       int slots, int heads, int w,
                                       int pages, int page_len,
                                       int max_pages, float sm_scale,
                                       int dtype, void* stream) {
  (void)pages;
  decode::Args a{q, k_pages, v_pages, static_cast<const int*>(table),
                 static_cast<const int*>(lengths), o, heads, w, 0, page_len,
                 max_pages, sm_scale, static_cast<const float*>(k_scale),
                 static_cast<const float*>(v_scale)};
  return decode::launch<true, true, true>(dtype, a, slots, stream);
}
