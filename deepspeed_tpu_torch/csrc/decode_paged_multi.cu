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
// No TPU layout tricks carried over: no 8-row query padding in memory, no
// [S, Wp, 128] length tiles, no scalar-prefetch grid.
//
// What bounds it on the H100: bytes, as decode_paged.cu: at the verify
// shape ([8, 12, 1024, 64], W = 5, page_len 16) the live rows read once
// take 0.00239 ms (int8: 0.00128 ms) at 3.35 TB/s; the W rows add flops,
// not bytes.
//
// What held the first kernel (decode_common.cuh's `rows_kernel`) back:
// the latency decode_paged.cu describes, and FMAs for every product: the
// score and P.V loops ran W times over the same K/V registers, so W = 5
// took 2.2x the single-query kernel for the same bytes.
//
// What the design does about it (bf16 and fp16): decode_split.cuh's
// kernel with the page-table map (`PageRows`), as decode_paged.cu, the W
// rows padded to one m16 tile: the W products of a key cost one mma.sync,
// not W FMA loops.
//
// The fp32 arms keep `rows_kernel` (fp32 FMAs): the tensor cores would
// take fp32 only as TF32, and the fp32 arms are held to 1e-4 of the plain
// versions.
#include "decode_common.cuh"
#include "decode_split.cuh"

namespace {

// Both arms: rows_kernel for fp32, the split kernel for bf16 and fp16.
template <bool QUANT>
int launch_paged_multi(const void* q, const void* k, const void* v, const float* ks,
                       const float* vs, const int* table, const int* lengths, void* o,
                       int slots, int heads, int w, int page_len, int max_pages,
                       float sm_scale, int dtype, void* stream) {
  if (w < 1 || w > 9) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) {
    decode::Args a{q, k, v, table, lengths, o, heads, w, 0, page_len,
                   max_pages, sm_scale, ks, vs};
    return decode::launch<true, true, QUANT>(a, slots, stream);
  }
  decode_split::Args a{q, k, v, ks, vs, table, lengths, o, heads, w,
                       page_len * max_pages, page_len, max_pages, 0, 0, sm_scale};
  return decode_split::launch_typed<decode_split::PageRows, QUANT>(
      dtype, a, slots, static_cast<cudaStream_t>(stream));
}

}  // namespace

// q/o [slots, heads, w, 64], pools [pages, heads, page_len, 64], table
// [slots, max_pages] int32, lengths [slots, w] int32, all contiguous on the
// device.  dtype: 0 fp32, 1 bf16, 2 fp16.  Returns a CUDA error code.
extern "C" int decode_paged_multi(const void* q, const void* k_pages,
                                  const void* v_pages, const void* table,
                                  const void* lengths, void* o, int slots,
                                  int heads, int w, int pages, int page_len,
                                  int max_pages, float sm_scale, int dtype,
                                  void* stream) {
  (void)pages;
  return launch_paged_multi<false>(q, k_pages, v_pages, nullptr, nullptr,
                                   static_cast<const int*>(table),
                                   static_cast<const int*>(lengths), o, slots,
                                   heads, w, page_len, max_pages, sm_scale, dtype,
                                   stream);
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
  return launch_paged_multi<true>(q, k_pages, v_pages,
                                  static_cast<const float*>(k_scale),
                                  static_cast<const float*>(v_scale),
                                  static_cast<const int*>(table),
                                  static_cast<const int*>(lengths), o, slots,
                                  heads, w, page_len, max_pages, sm_scale, dtype,
                                  stream);
}
