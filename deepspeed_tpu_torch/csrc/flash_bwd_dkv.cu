// Flash-attention backward, dK and dV, for Hopper (sm_90a), head_dim 64.
//
// Replaces the Pallas TPU kernel deepspeed_tpu/ops/pallas/flash_attention.py
// `_bwd_dkv_kernel` (launched by `_bwd` through `pl.pallas_call`): for each
// key row, walk the query tiles that can see it, recompute the
// probabilities from the saved lse, and accumulate
//     p  = exp(s - lse)                   (s: flash_common.cuh masked_score)
//     r  = keep / (1 - rate) under dropout, else 1
//     dV += (p * r)^T . dO
//     ds = p * (dO . V^T * r - delta) * sm_scale
//     dK += ds^T . Q
// in fp32, writing dK and dV once in the input dtype.  The dropout keep
// mask is regenerated from the forward's position hash, bit for bit.
//
// What bounds it on the H100: four products per live (query, key) pair
// (q.k, dO.v, p.dO, ds.q), 8 * 64 flops each pair; at the training shape
// ([8, 12, 1024, 64] causal) that is ~26 GFLOP against ~50 MB of traffic,
// so at the tensor cores' rate the bytes would bound it.  This first kernel
// runs the products as plain fp32 FMAs (67 TFLOP/s), so its own bound is
// the operations; wgmma is the later step.
//
// What the design does about it:
// - one block per (key tile of 64 rows, batch*head), 256 threads, four per
//   key row; the block owns its dK/dV rows, so it needs no atomics (the
//   TPU kernel's sequential q axis becomes a loop inside the block);
// - the key row and its value row live in registers; each tile of 32
//   queries (Q, dO, lse, delta) is staged once in shared memory (fp32,
//   rows padded to 65 floats) and read by all 64 key rows;
// - under the causal mask the query loop starts at the tile's first key
//   (queries before it see none of its keys); a tile at or past kv_length
//   writes zeros without reading anything; query rows past T read
//   lse = +1e30, so their p is exactly 0;
// - dead rows (lse = +1e30 from the forward) contribute exact zeros.
#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int BKR = 64;       // key rows per block
constexpr int BQT = 32;       // queries per shared-memory tile
constexpr int THREADS = 256;  // 4 threads per key row
constexpr int CPT = BQT / 4;  // query columns per thread per tile
constexpr int OPT = D / 4;    // dK/dV columns per thread

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dk, T* __restrict__ dv, int tq, int tk, Mask mk) {
  __shared__ float qs[BQT][D + 1];
  __shared__ float dos[BQT][D + 1];
  __shared__ float pds[BKR][BQT + 1];
  __shared__ float dss[BKR][BQT + 1];
  __shared__ float lses[BQT];
  __shared__ float deltas[BQT];

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * BKR;
  const int tid = threadIdx.x;
  const int row = tid >> 2;  // key row within the tile
  const int cg = tid & 3;
  const int kj = k0 + row;
  const bool row_live = kj < tk;
  const uint32_t hid = bh_id(bh, mk);

  const T* qb = q + (size_t)bh * tq * D;
  const T* db = dout + (size_t)bh * tq * D;
  const size_t koff = ((size_t)bh * tk + kj) * D;

  float kr[D], vr[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    kr[d] = row_live ? to_f(k[koff + d]) : 0.f;
    vr[d] = row_live ? to_f(v[koff + d]) : 0.f;
  }
  const float km = key_mask(bh, kj, tk, mk);

  float dka[OPT], dva[OPT];
#pragma unroll
  for (int j = 0; j < OPT; ++j) {
    dka[j] = 0.f;
    dva[j] = 0.f;
  }

  // queries that can see a key of this tile: all of them, or (causal) those
  // at or after its first key; none when the tile starts past kv_length
  const int qstart = mk.causal ? k0 : 0;
  const bool any = k0 < min(tk, mk.seq_len) && qstart < tq;
  const int ntiles = any ? (tq - qstart + BQT - 1) / BQT : 0;

  for (int t = 0; t < ntiles; ++t) {
    const int qt0 = qstart + t * BQT;
    __syncthreads();  // every warp is done with the previous tile
    for (int i = tid; i < BQT * D; i += THREADS) {
      const int r = i / D, c = i % D;
      const int qi = qt0 + r;
      float qv = 0.f, dv_ = 0.f;
      if (qi < tq) {
        qv = to_f(qb[(size_t)qi * D + c]);
        dv_ = to_f(db[(size_t)qi * D + c]);
      }
      qs[r][c] = qv;
      dos[r][c] = dv_;
    }
    if (tid < BQT) {
      const int qi = qt0 + tid;
      lses[tid] = qi < tq ? lse[(size_t)bh * tq + qi] : DEAD_LSE;
      deltas[tid] = qi < tq ? delta[(size_t)bh * tq + qi] : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = cg + 4 * j;
      const int qi = qt0 + c;
      float dot = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        dot = fmaf(kr[d], qs[c][d], dot);
        dp = fmaf(vr[d], dos[c][d], dp);
      }
      const float p = expf(masked_score(dot, km, qi, kj, mk) - lses[c]);
      float r = 1.f;
      if (mk.dropout) r = keep(qi, kj, hid, mk) ? 1.f / mk.keep_div : 0.f;
      pds[row][c] = p * r;
      dss[row][c] = p * (dp * r - deltas[c]) * mk.sm_scale;
    }
    __syncwarp();  // the row's values come from the same warp

#pragma unroll 4
    for (int c = 0; c < BQT; ++c) {
      const float pd = pds[row][c];
      const float ds = dss[row][c];
#pragma unroll
      for (int j = 0; j < OPT; ++j) {
        dva[j] = fmaf(pd, dos[c][cg + 4 * j], dva[j]);
        dka[j] = fmaf(ds, qs[c][cg + 4 * j], dka[j]);
      }
    }
  }

  if (!row_live) return;
#pragma unroll
  for (int j = 0; j < OPT; ++j) {
    dk[koff + cg + 4 * j] = from_f<T>(dka[j]);
    dv[koff + cg + 4 * j] = from_f<T>(dva[j]);
  }
}

template <typename T>
void launch(const void* q, const void* k, const void* v, const void* dout,
            const void* lse, const void* delta, void* dk, void* dv, int bh, int tq,
            int tk, const Mask& mk, cudaStream_t st) {
  const dim3 grid(bh, (tk + BKR - 1) / BKR);
  flash_bwd_dkv_kernel<T><<<grid, THREADS, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv),
      tq, tk, mk);
}

}  // namespace

// dtype: 0 fp32, 1 bf16, 2 fp16.  q/dout are [bh, tq, 64], k/v/dk/dv
// [bh, tk, 64], lse/delta [bh, tq] fp32, kmask [bh, tk] fp32 or null, all
// contiguous.  Returns cudaGetLastError().
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse, const void* delta,
                             void* dk, void* dv, const void* kmask, int bh, int tq,
                             int tk, int kv_len, float sm_scale, int causal,
                             int dropout, unsigned seed, unsigned thresh,
                             float keep_div, unsigned bh_base, int bh_period,
                             unsigned bh_stride, int dtype, void* stream) {
  const Mask mk = make_mask(kmask, kv_len, sm_scale, causal, dropout, seed, thresh,
                            keep_div, bh_base, bh_period, bh_stride);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: launch<float>(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk, mk, st); break;
    case 1:
      launch<__nv_bfloat16>(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk, mk, st);
      break;
    case 2: launch<__half>(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk, mk, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
