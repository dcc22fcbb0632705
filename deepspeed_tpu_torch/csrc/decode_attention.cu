// Single-query decode attention over the slot KV cache for Hopper (sm_90a),
// head_dim 64: the decode tick of the slot-cache engine, and the
// speculative draft's.
//
// Replaces the Pallas TPU kernel deepspeed_tpu/ops/pallas/decode_attention.py
// `_decode_kernel` (launched by `_decode_pallas` through `pl.pallas_call`):
// one new query per (slot, head) against that slot's cached keys
// k/v [S, H, T, 64], with a per-slot live length read from device memory.
// Keys at or past the length are never attended (their rows may hold
// anything), and a length-0 slot (a free slot riding along in the static
// batch) outputs exact zeros.  The TPU kernel streamed the whole T stride
// of every slot (its block index maps could not read a traced length);
// this one reads only the live rows.
//
// What bounds it on the H100: bytes.  Each live key costs 2 x 64 elements
// of K and V read once against 4 x 64 flops; at the serving shape
// ([8, 12, 1024, 64], lengths {0, 1, 513, 1024, 77, 300, 640, 1000}) the
// live rows read once take 0.00327 ms at 3.35 TB/s.  What stands between a
// kernel and that is latency: one CUDA block per (slot, head) is 96 blocks
// on 132 SMs, and the 1024-key slot is walked by one SM alone, each step a
// round trip to memory.
//
// What runs (bf16 and fp16): decode_split.cuh's kernel with the slot map
// (`SlotRows`: key j of (slot, head) sh is row sh * T + j) at W = 1, the
// kernel decode_multi.cu runs for W <= 9; the lengths [S] are the [S, 1]
// it reads.  Each (slot, head)'s keys split over a thread-block cluster
// of N = ceil(T / 256) <= 8 CUDA blocks (`splits`: 4 at the serving
// shape, 384 blocks; 1 where the slots alone fill the card); 64-key tiles
// come through a cp.async ring into mma.sync, the query padded to one m16
// tile; P enters P.V rounded once to the input type, as the JAX kernel's
// `p.astype(v.dtype)` does, while l sums the unrounded p; the N blocks'
// states merge in distributed shared memory.
//
// The fp32 arm runs decode_common.cuh's `rows_kernel` at W = 1 (one block
// per (slot, head), fp32 FMAs), as decode_multi.cu's fp32 arm does: the
// tensor cores would take fp32 only as TF32, and fp32 is held to 1e-4 of
// the plain version.
#include "decode_common.cuh"
#include "decode_split.cuh"

// dtype: 0 fp32, 1 bf16, 2 fp16.  q/o are [slots*heads, 64], k/v
// [slots*heads, t_max, 64], lengths [slots] int32, all contiguous on the
// device (q, o, k, v 16-byte aligned).  Returns a CUDA error code.
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* lengths, void* o, int slots,
                                int heads, int t_max, float sm_scale,
                                int dtype, void* stream) {
  const int* lens = static_cast<const int*>(lengths);
  if (dtype == 0) {
    decode::Args a{q, k, v, nullptr, lens, o, heads, 1, t_max, 0, 0, sm_scale};
    return decode::launch<false, false>(a, slots, stream);
  }
  decode_split::Args a{q, k, v, nullptr, nullptr, nullptr, lens, o, heads, 1, t_max,
                       0, 0, 0, 0, sm_scale};
  return decode_split::launch_typed<decode_split::SlotRows, false>(
      dtype, a, slots, static_cast<cudaStream_t>(stream));
}
