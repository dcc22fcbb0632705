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
// (k.q, v.dO, p.dO, ds.q), 8 * 64 flops a pair; at the training shape
// ([8, 12, 1024, 64] causal, bf16) that is ~25.8 GFLOP (26.1 us at the
// tensor cores' 989 TFLOP/s) against ~63.7 MB of q/k/v/dO/dK/dV/lse/delta
// traffic (19.0 us at 3.35 TB/s): bounded by operations.  Beside the
// products, every live pair pays one ex2, the masks and under dropout the
// position hash: the work the tensor cores cannot do.
//
// What the design does about it (bf16 and fp16), on flash_sm90.cuh like the
// forward and dQ, with the roles of queries and keys swapped:
// - one block per (key tile of 128 rows, batch*head), 64 rows where 128
//   would leave SMs idle: a consumer warpgroup per 64 keys and a producer
//   warpgroup whose first warp works; the block owns its dK/dV rows, so it
//   needs no atomics (the TPU kernel's sequential q axis becomes a loop
//   inside the block); causal grids launch key tile 0, which sees every
//   query, first;
// - K and V come in once by TMA and stay resident; the producer streams
//   each 64-row Q and dO tile by TMA into a 3-stage mbarrier ring, with the
//   tile's 64 lse (on the log2 scale) and delta values beside them (rows
//   past T: lse = +1e30, delta = 0); each key's mask value is read once;
// - the scores are computed already transposed, keys as rows and queries
//   as columns: S^T = K.Q^T and dP^T = V.dO^T are issued back to back on
//   the tensor cores (wgmma m64n64k16, fp32 accumulators, Q and dO
//   K-major); p is recomputed from S^T while dP^T is in flight, with lse
//   and delta per column; P~^T (p times the keep scale) is rounded to the
//   input type once (the JAX kernel's `pd.astype(do.dtype)`) and feeds
//   dV += P~^T.dO from registers (dO read down its rows, MN-major) while
//   dS^T = p (dP^T r - delta) scale is formed and rounded once
//   (`ds.astype(q.dtype)`) for dK += dS^T.Q (Q MN-major): nothing is
//   transposed through shared memory;
// - the masks (kv_length, the causal diagonal) run on diagonal and edge
//   tiles only; a warpgroup skips query tiles wholly before its first key;
//   a block whose keys all sit at or past kv_length writes zeros without
//   loading anything; padded keys (additive mask -1e9), dead query rows
//   and rows past T get p = 0 exactly, so their dK/dV are exact zeros;
// - the consumers hold four m64n64 fp32 accumulators (S^T, dP^T, dK, dV:
//   128 registers a thread) plus the packed P~^T and dS^T fragments;
//   under two of them setmaxnreg moves registers from the producer
//   warpgroup to them (its 128 threads free exactly what the consumers'
//   256 take: setmaxnreg.inc draws only on what the block's own
//   setmaxnreg.dec released, so a lone producer warp would leave the
//   consumers waiting for ever).
//
// The fp32 arm keeps the first kernel below (plain fp32 FMAs, four threads
// a key row, each 32-query tile staged once in shared memory as fp32): it
// is the parity path that holds the fp32 kernel-path losses within 1e-4 of
// the dense path's, which TF32 wgmma would not.
#include "flash_sm90.cuh"

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

namespace sm90k {

using namespace flash;
using namespace flash::sm90;

// The producer's stage rows: the query tile's lse on the log2 scale and its
// delta, two rows of 64 (rows past T: +1e30 and 0).
struct LseDeltaRows {
  const float* lse;
  const float* delta;
  int bh, tq;
  __device__ __forceinline__ void operator()(float* dst, int q0, int lane) const {
    for (int j = lane; j < TILE; j += 32) {
      const int qi = q0 + j;
      const bool live = qi < tq;
      dst[j] = (live ? lse[(size_t)bh * tq + qi] : DEAD_LSE) * LOG2E;
      dst[TILE + j] = live ? delta[(size_t)bh * tq + qi] : 0.f;
    }
  }
};

// One consumer warpgroup: dK and dV of the 64 keys starting at kw, over
// the block's query tiles q0, q0 + 64, ...
template <typename T, int NWG>
__device__ __forceinline__ void consume(uint8_t* sm, T* __restrict__ dk,
                                        T* __restrict__ dv, int bh, int kw, int q0,
                                        int ntiles, int tk, const Mask& mk) {
  using P = Plan<NWG, 2, 2>;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + P::BAR);
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + STAGES;
  const float* rows = reinterpret_cast<const float*>(sm + P::ROWS);
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int wg = threadIdx.x >> 7;
  const int r0 = kw + acc_row(0, warp, lane);  // this thread's keys r0, r0 + 8
  const int kvalid = min(tk, mk.seq_len);
  const bool live = kw < kvalid;  // some key of this warpgroup is valid
  const float scale2 = mk.sm_scale * LOG2E;
  const float inv_keep = 1.f / mk.keep_div;
  const uint32_t slt = salt(bh_id(bh, mk), mk);
  const float km2[2] = {key_mask(bh, r0, tk, mk) * LOG2E,
                        key_mask(bh, r0 + 8, tk, mk) * LOG2E};

  float dka[32], dva[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dka[i] = dva[i] = 0.f;

  const uint64_t kd = desc(sm + P::STAT + wg * TILE_BYTES);
  const uint64_t vd = desc(sm + P::STAT + (NWG + wg) * TILE_BYTES);
  mbar_wait(bars, 0);
  for (int t = 0; t < ntiles; ++t) {
    const int s = t % STAGES;
    const int qt = q0 + t * TILE;
    mbar_wait(&full[s], (t / STAGES) & 1);
    if (live && !(mk.causal && kw > qt + TILE - 1)) {  // some pair can be live
      const uint64_t qd = desc(sm + P::RING0 + s * TILE_BYTES);
      const uint64_t dod = desc(sm + P::RING1 + s * TILE_BYTES);
      const float* lse2 = rows + s * 2 * TILE;
      const float* dlt = lse2 + TILE;
      float sc[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
      fence_regs(sc);
      fence_regs(dp);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_ss<T, 0>(sc, kd + kk * K_MAJOR_STEP, qd + kk * K_MAJOR_STEP, kk > 0);
      wg_commit();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_ss<T, 0>(dp, vd + kk * K_MAJOR_STEP, dod + kk * K_MAJOR_STEP, kk > 0);
      wg_commit();
      wg_wait<1>();  // S^T is in; dP^T may still be running
      fence_regs(sc);

      // p = exp(s - lse) on the log2 scale, keys as rows, queries as
      // columns; the keep bits of the thread's 32 pairs, and P~^T packed
      const bool edge = kw + TILE > kvalid || (mk.causal && kw + TILE - 1 > qt);
      const int cq = qt + 2 * (lane & 3);  // the query of column acc_col(0)
      const uint32_t rtq = row_term(cq);
      uint32_t keep = 0xFFFFFFFFu;
      uint32_t pd[16];
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int h = (i >> 1) & 1;
        const int c = acc_col(i, lane);
        const int kj = r0 + 8 * h;
        const float2 l2 = *reinterpret_cast<const float2*>(lse2 + c);
        float x0 = sc[i] * scale2, x1 = sc[i + 1] * scale2;
        if (mk.kmask != nullptr) {
          x0 += km2[h];
          x1 += km2[h];
        }
        if (edge) {
          const int qi = cq + 8 * (i >> 2);
          const bool kv = kj < kvalid;
          x0 = kv && (!mk.causal || kj <= qi) ? x0 : NEG_INF;
          x1 = kv && (!mk.causal || kj <= qi + 1) ? x1 : NEG_INF;
        }
        const float p0 = ex2(x0 - l2.x), p1 = ex2(x1 - l2.y);
        sc[i] = p0;
        sc[i + 1] = p1;
        float pd0 = p0, pd1 = p1;
        if (mk.dropout) {
          // row_term(cq + 8 (i/4) + e) = rtq + (8 (i/4) + e) * GOLDEN, mod 2^32
          const uint32_t rt = rtq + static_cast<uint32_t>(8 * (i >> 2)) * GOLDEN;
          const bool kp0 = keep_at(rt, kj, slt, mk.thresh);
          const bool kp1 = keep_at(rt + GOLDEN, kj, slt, mk.thresh);
          keep &= ~((static_cast<uint32_t>(!kp0) << i) |
                    (static_cast<uint32_t>(!kp1) << (i + 1)));
          pd0 = kp0 ? p0 * inv_keep : 0.f;
          pd1 = kp1 ? p1 * inv_keep : 0.f;
        }
        pd[i >> 1] = pack2<T>(pd0, pd1);
      }
      fence_regs(dva);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_rs<T, 1>(dva, &pd[4 * kk], dod + kk * MN_MAJOR_STEP, 1);
      wg_commit();
      wg_wait<1>();  // dP^T is in; dV may still be running
      fence_regs(dp);

      // dS^T = p (dp' - delta) scale, dp' = dp keep / (1 - rate)
      uint32_t ds[16];
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const float2 d2 = *reinterpret_cast<const float2*>(dlt + acc_col(i, lane));
        float d0 = dp[i], d1 = dp[i + 1];
        if (mk.dropout) {
          d0 = ((keep >> i) & 1u) ? d0 * inv_keep : 0.f;
          d1 = ((keep >> (i + 1)) & 1u) ? d1 * inv_keep : 0.f;
        }
        ds[i >> 1] = pack2<T>(sc[i] * (d0 - d2.x) * mk.sm_scale,
                              sc[i + 1] * (d1 - d2.y) * mk.sm_scale);
      }
      fence_regs(dka);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_rs<T, 1>(dka, &ds[4 * kk], qd + kk * MN_MAJOR_STEP, 1);
      wg_commit();
      wg_wait<0>();
      fence_regs(dka);
      fence_regs(dva);
      fence_regs(pd);
      fence_regs(ds);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kj = r0 + 8 * h;
    if (kj >= tk) continue;
    T* ok = dk + ((size_t)bh * tk + kj) * D;
    T* ov = dv + ((size_t)bh * tk + kj) * D;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i = 4 * j + 2 * h;
      *reinterpret_cast<uint32_t*>(ok + acc_col(i, lane)) = pack2<T>(dka[i], dka[i + 1]);
      *reinterpret_cast<uint32_t*>(ov + acc_col(i, lane)) = pack2<T>(dva[i], dva[i + 1]);
    }
  }
}

// Registers a thread under two consumer warpgroups: 168 at launch (384
// threads, one block an SM), then 232 a consumer and 40 a producer thread:
// 128 x (168 - 40) = 256 x (232 - 168).
constexpr int CONSUMER_REGS = 232;
constexpr int PRODUCER_REGS = 40;

template <typename T, int NWG>
__global__ void __launch_bounds__((NWG + 1) * 128, 1)
flash_bwd_dkv_sm90(const __grid_constant__ CUtensorMap tmq,
                   const __grid_constant__ CUtensorMap tmk,
                   const __grid_constant__ CUtensorMap tmv,
                   const __grid_constant__ CUtensorMap tmdo,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   T* __restrict__ dk, T* __restrict__ dv, int tq, int tk, Mask mk) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align_1k(smem_raw);
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * (NWG * TILE);  // key tile 0 sees every query
  const int q0 = mk.causal ? k0 : 0;         // no earlier query sees a key here
  const int ntiles =
      k0 < min(tk, mk.seq_len) && q0 < tq ? (tq - q0 + TILE - 1) / TILE : 0;
  if (ntiles == 0) {  // no live pair: zeros, nothing loaded
    const int nrow = min(NWG * TILE, tk - k0);
    uint32_t* zk = reinterpret_cast<uint32_t*>(dk + ((size_t)bh * tk + k0) * D);
    uint32_t* zv = reinterpret_cast<uint32_t*>(dv + ((size_t)bh * tk + k0) * D);
    for (int i = threadIdx.x; i < nrow * D / 2; i += blockDim.x) zk[i] = zv[i] = 0u;
    return;
  }
  init_barriers<NWG, 2, 2>(sm);
  if ((threadIdx.x >> 7) == NWG) {  // the producer warpgroup
    if constexpr (NWG == 2) reg_dealloc<PRODUCER_REGS>();
    if ((threadIdx.x & 127) < 32)    // its first warp
      produce<NWG, 2, 2>(sm, &tmk, &tmv, &tmq, &tmdo, bh, k0, q0, ntiles,
                         LseDeltaRows{lse, delta, bh, tq});
  } else {
    if constexpr (NWG == 2) reg_alloc<CONSUMER_REGS>();
    consume<T, NWG>(sm, dk, dv, bh, k0 + TILE * (threadIdx.x >> 7), q0, ntiles, tk,
                    mk);
  }
}

template <typename T, int NWG>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dk, void* dv, int bh, int tq,
           int tk, const Mask& mk, bool fp16, cudaStream_t st) {
  CUtensorMap mq, mkk, mv, mdo;
  int rc = make_map(&mq, q, bh, tq, fp16);
  if (rc == 0) rc = make_map(&mkk, k, bh, tk, fp16);
  if (rc == 0) rc = make_map(&mv, v, bh, tk, fp16);
  if (rc == 0) rc = make_map(&mdo, dout, bh, tq, fp16);
  if (rc != 0) return rc;
  const int bytes = Plan<NWG, 2, 2>::LAUNCH_BYTES;
  const int smem_rc = allow_smem(flash_bwd_dkv_sm90<T, NWG>, bytes);
  if (smem_rc != 0) return smem_rc;
  const dim3 grid(bh, (tk + NWG * TILE - 1) / (NWG * TILE));
  flash_bwd_dkv_sm90<T, NWG><<<grid, (NWG + 1) * 128, bytes, st>>>(
      mq, mkk, mv, mdo, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv),
      tq, tk, mk);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_tc(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dk, void* dv, int bh, int tq,
              int tk, const Mask& mk, bool fp16, cudaStream_t st) {
  if (two_warpgroups(bh, tk))
    return launch<T, 2>(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk, mk, fp16, st);
  return launch<T, 1>(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk, mk, fp16, st);
}

}  // namespace sm90k


// dtype: 0 fp32 (the FMA kernel), 1 bf16, 2 fp16 (the tensor-core kernel).
// q/dout are [bh, tq, 64], k/v/dk/dv [bh, tk, 64], lse/delta [bh, tq] fp32,
// kmask [bh, tk] fp32 or null, all contiguous; bf16/fp16 bases 16-byte
// aligned.  Returns a CUDA error code (cudaGetLastError() after the
// launch), 0 on success.
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
      return sm90k::launch_tc<__nv_bfloat16>(q, k, v, dout, lse, delta, dk, dv, bh,
                                             tq, tk, mk, false, st);
    case 2:
      return sm90k::launch_tc<__half>(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk,
                                      mk, true, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
