// Single-query decode attention over the paged KV pool for Hopper (sm_90a),
// head_dim 64: the decode tick of the paged engine.
//
// Replaces the Pallas TPU kernel deepspeed_tpu/ops/pallas/decode_attention.py
// `_decode_paged_kernel` (launched by `_decode_paged_pallas` through
// `pl.pallas_call`; API `decode_attention_paged`), both arms: one new query
// per (slot, head) against the slot's K/V rows in a flat pool
// [P, H, page_len, 64], found through the slot's page table, masked to a
// per-slot live length read from device memory.  A length-0 slot outputs
// exact zeros.  `decode_paged` is the fp arm; `decode_paged_int8` the int8
// pool arm (`:313-359`), whose per-row fp32 scales fold into the scores
// and probabilities.  The TPU kernel streamed one page per grid step
// through a scalar-prefetched table; here a block reads its own lengths
// and table entries on the device, any page_len from 1 to 128.
//
// What bounds it on the H100: bytes.  A live key costs 256 B of bf16 K and
// V (136 B from the int8 pool: 2 x 64 int8 and two fp32 scales) against
// 4 x 64 flops; at the serving shape ([8, 12, 1024, 64], page_len 16,
// lengths up to 1024) the live rows read once take 0.00327 ms (int8:
// 0.00174 ms) at 3.35 TB/s.
//
// What held the first kernel (decode_common.cuh's `rows_kernel`) back:
// latency.  One block per (slot, head) walked the longest slot on one SM,
// each 32-key step a load of its table entries and then of its K and V
// rows: two dependent round trips to memory a step, 32 steps for 1024
// keys, one row of FMAs at a time.
//
// What the design does about it (bf16 and fp16): decode_split.cuh's
// kernel with the page-table map (`PageRows`), W = 1 padded to one m16
// tile: each (slot, head)'s keys split over a thread-block cluster of
// N = ceil(T / 256) <= 8 CUDA blocks (T = max_pages * page_len; N = 1
// where the slots alone fill the card), each copying its range's live
// table entries into shared memory once, then streaming 64-key tiles
// through a cp.async ring, row by row from their pages, into mma.sync;
// the int8 arm widens each staged int8 K row in registers into the
// products' fragments and V to bf16 in shared memory, and folds the
// scales in per key; the blocks merge in distributed shared memory.
//
// The fp32 arms keep `rows_kernel` (fp32 FMAs): the tensor cores would
// take fp32 only as TF32, and the fp32 arms are held to 1e-4 of the plain
// versions.
#include "decode_common.cuh"
#include "decode_split.cuh"

namespace {

// Both arms: rows_kernel for fp32, the split kernel for bf16 and fp16.
template <bool QUANT>
int launch_paged(const void* q, const void* k, const void* v, const float* ks,
                 const float* vs, const int* table, const int* lengths, void* o,
                 int slots, int heads, int page_len, int max_pages, float sm_scale,
                 int dtype, void* stream) {
  if (dtype == 0) {
    decode::Args a{q, k, v, table, lengths, o, heads, 1, 0, page_len,
                   max_pages, sm_scale, ks, vs};
    return decode::launch<true, false, QUANT>(a, slots, stream);
  }
  decode_split::Args a{q, k, v, ks, vs, table, lengths, o, heads, 1,
                       page_len * max_pages, page_len, max_pages, 0, 0, sm_scale};
  return decode_split::launch_typed<decode_split::PageRows, QUANT>(
      dtype, a, slots, static_cast<cudaStream_t>(stream));
}

}  // namespace

// q/o [slots, heads, 64], pools [pages, heads, page_len, 64], table
// [slots, max_pages] int32, lengths [slots] int32, all contiguous on the
// device.  dtype: 0 fp32, 1 bf16, 2 fp16.  Returns a CUDA error code.
extern "C" int decode_paged(const void* q, const void* k_pages,
                            const void* v_pages, const void* table,
                            const void* lengths, void* o, int slots,
                            int heads, int pages, int page_len, int max_pages,
                            float sm_scale, int dtype, void* stream) {
  (void)pages;
  return launch_paged<false>(q, k_pages, v_pages, nullptr, nullptr,
                             static_cast<const int*>(table),
                             static_cast<const int*>(lengths), o, slots, heads,
                             page_len, max_pages, sm_scale, dtype, stream);
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
  return launch_paged<true>(q, k_pages, v_pages, static_cast<const float*>(k_scale),
                            static_cast<const float*>(v_scale),
                            static_cast<const int*>(table),
                            static_cast<const int*>(lengths), o, slots, heads,
                            page_len, max_pages, sm_scale, dtype, stream);
}
