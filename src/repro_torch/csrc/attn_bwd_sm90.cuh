// The tensor-core attention backward (bf16), shared by ring_flash.cu
// (ring_flash_bwd_tc: one ring step at offsets read on the device) and
// flash_bwd.cu (flash_bwd_tc: queries aligned to the end of the kv stream,
// q_start = skv - sq and k_start = 0 passed as ints). Both compute, at
// absolute positions q_start + i and k_start + j under the causal, window
// and prefix masks (the JAX _mask_block, kernel.py:145),
//   p = exp(s - lse) (0 where masked and on rows with lse = -inf)
//   dv = p^T do, ds = p (do v^T - delta) sm_scale, dk = ds^T q, dq = ds k
// with dk and dv summed over each kv head's query-head group in a fixed
// order (no atomics).
//
// The FA2 split on the tensor cores (attn_sm90.cuh): bf16 operands in
// 128-byte-swizzled shared memory, copied with cp.async from the strided
// inputs, f32 accumulators, one warpgroup a block and several blocks an
// SM, head dims 32, 64 and 128. A tile of keys (or queries) that no pair of
// the block can see is skipped whole (the TPU kernel's run predicate,
// kernel.py:620-626, :730-736); tiles whose pairs are all visible skip the
// per-element masks.
//  - dq (dq_tc_kernel): Q and dO of 64 query rows resident; K and V stream
//    in two stages of 64 keys. S = Q K^T and dP = dO V^T on wgmma,
//    p = exp(s - lse) and ds = p (dp - delta) sm_scale on their fragments,
//    dQ += dS K with dS as the register A operand, one bf16 plane (dq is
//    rounded to bf16 anyway).
//  - dk/dv (dkv_tc_kernel): K and V of 64 keys resident; Q, dO, lse and
//    delta of 64 query rows stream in two stages, over every query head of
//    the group. S^T = K Q^T and dP^T = V dO^T, then dV += P^T dO and
//    dK += dS^T Q with P^T and dS^T in registers as two bf16 planes each,
//    hi = bf16(x) and lo = bf16(x - hi): one plane rounds each term by up to
//    2^-9, which over these sums reaches the 1e-3 limit of dk/dv; two keep
//    2^-16. The tensor cores add each k16 step into their f32 accumulator
//    with truncation, so every FOLD query tiles the accumulators are added
//    into the f32 outputs (round to nearest) and restarted: a partial drifts
//    over at most FOLD x 4 x 2 steps.
// Where the offsets come from is a template parameter (DeviceOffsets,
// ValueOffsets, attn_sm90.cuh), so the flash backward allocates no device
// tensor for them.
// Block order (both callers): the tile index is the slowest axis of the
// launch (the grid's linear index divided by heads x batches), walked from
// the tile that sees the most pairs under a causal mask with q_start >=
// k_start (dq: the last query tile; dk/dv: the first key tile), so the
// longest blocks start first and the short ones fill the tail.
#pragma once

#include "attn_sm90.cuh"

namespace repro {
namespace attn {

namespace bwd {

constexpr int BT = 64;     // rows of every tile: a block's own, a stage's
constexpr int FOLD = 16;   // dk/dv: query tiles between folds

template <int D>
struct Smem {
  using T = Tile<BT, D>;
  static constexpr int DP = T::DP;
  // two resident tiles (Q, dO or K, V) and two stages of two streamed ones,
  // then the dk/dv kernel's lse and delta for each stage
  static constexpr int BYTES = 6 * T::BYTES + 2 * 2 * BT * 4 + 1024;
};

// (tile, head, batch) of this block, the tile index slowest (block order
// above)
struct BlockIds {
  int tile, head, batch;
};
__device__ __forceinline__ BlockIds block_ids() {
  const int rest = gridDim.y * gridDim.z;
  const int lin = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
  const int r = lin % rest;
  return {lin / rest, static_cast<int>(r % gridDim.y), static_cast<int>(r / gridDim.y)};
}

template <int D, class Off>
__global__ void __launch_bounds__(NT, 1) dq_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, Off off,
    __nv_bfloat16* __restrict__ dq, int h, int hk, int sq, int skv, Masks mk,
    float sm_scale, Strides st) {
  using T = typename Smem<D>::T;
  constexpr int DP = T::DP;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sO = sQ + T::BYTES, sKV = sO + T::BYTES;  // stage s: K, V at + 2s

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const BlockIds id = block_ids();
  const int qt = gridDim.x - 1 - id.tile, hh = id.head, bi = id.batch;
  const int kh = hh / (h / hk);
  const int q0 = off.q_start(), k0 = off.k_start();
  const int i0 = qt * BT;
  const int nk = (skv + BT - 1) / BT;
  auto next = [&](int j) {  // the first key tile from j on that the block sees
    while (j < nk && !tile_runs(mk, q0 + i0, BT, k0 + j * BT, BT)) ++j;
    return j;
  };
  const __nv_bfloat16* kb = k + bi * st.kb + kh * st.kh;
  const __nv_bfloat16* vb = v + bi * st.vb + kh * st.vh;
  auto load_kv = [&](int j, int stage) {
    const int j0 = j * BT;
    const uint32_t s = sKV + stage * 2 * T::BYTES;
    load_tile<BT, D, NT>(s, kb + j0 * st.ks, st.ks, skv - j0, tid);
    load_tile<BT, D, NT>(s + T::BYTES, vb + j0 * st.vs, st.vs, skv - j0, tid);
  };
  load_tile<BT, D, NT>(sQ, q + bi * st.qb + hh * st.qh + i0 * st.qs, st.qs, sq - i0, tid);
  load_tile<BT, D, NT>(sO, dout + bi * st.ob + hh * st.oh + i0 * st.os, st.os, sq - i0, tid);
  int j = next(0);
  if (j < nk) load_kv(j, 0);
  cp_commit();

  const int wrow = warp * 16 + lane / 4;  // this thread's rows: wrow, wrow + 8
  const long long rowb = ((long long)bi * h + hh) * sq;
  float lse2[2], dl[2];
  bool live[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = i0 + wrow + 8 * r;
    const float L = qi < sq ? lse[rowb + qi] : -CUDART_INF_F;
    live[r] = L != -CUDART_INF_F;  // exp's argument stays finite
    lse2[r] = live[r] ? L * LOG2E : 0.f;
    dl[r] = qi < sq ? delta[rowb + qi] : 0.f;
  }
  const float sl2 = sm_scale * LOG2E;
  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;

  for (int stage = 0; j < nk; stage ^= 1) {
    const int jn = next(j + 1);
    if (jn < nk) load_kv(jn, stage ^ 1);
    cp_commit();
    cp_wait<1>();
    fence_async_smem();
    __syncthreads();
    const int j0 = j * BT;
    const uint32_t sK = sKV + stage * 2 * T::BYTES, sV = sK + T::BYTES;
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(s, kmajor<BT, D>(sQ, 0, kk), kmajor<BT, D>(sK, 0, kk));
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(dp, kmajor<BT, D>(sO, 0, kk), kmajor<BT, D>(sV, 0, kk));
    wgmma_commit();
    wgmma_wait<0>();
    hold(s);
    hold(dp);
    const bool full = j0 + BT <= skv && tile_full(mk, q0 + i0, BT, k0 + j0, BT);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = frag_row(i), kj = j0 + frag_col(i, lane);
      const bool ok =
          live[r] && (full || (kj < skv && visible(mk, q0 + i0 + wrow + 8 * r, k0 + kj)));
      const float p = ok ? ex2(s[i] * sl2 - lse2[r]) : 0.f;
      s[i] = p * (dp[i] - dl[r]) * sm_scale;
    }
    uint32_t da[4][4];
    to_frags<BT>(s, da);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk) wgmma_rs<DP>(acc, da[kk], mnmajor<BT, D>(sK, kk));
    wgmma_commit();
    wgmma_wait<0>();
    hold(acc);
    hold(da);
    __syncthreads();  // the stage is free for the tile after next
    j = jn;
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = i0 + wrow + 8 * r;
    if (qi >= sq) continue;
    __nv_bfloat16* out = dq + (rowb + qi) * D;
#pragma unroll
    for (int i = 2 * r; i < DP / 2; i += 4) {
      const int c = frag_col(i, lane);
      if (c < D)
        *reinterpret_cast<__nv_bfloat162*>(out + c) = __floats2bfloat162_rn(acc[i], acc[i + 1]);
    }
  }
}

template <int D, class Off>
__global__ void __launch_bounds__(NT, 1) dkv_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, Off off,
    float* __restrict__ dk, float* __restrict__ dv, int h, int hk, int sq, int skv,
    Masks mk, float sm_scale, Strides st) {
  using T = typename Smem<D>::T;
  constexpr int DP = T::DP;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sK = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sV = sK + T::BYTES, sT = sV + T::BYTES;  // stage s: Q, dO at + 2s
  const uint32_t sL = sT + 4 * T::BYTES;  // stage s: lse[BT], delta[BT] at + 2s BT
  const float* lsm = reinterpret_cast<const float*>(smem_raw + (sL - smem_u32(smem_raw)));

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const BlockIds id = block_ids();
  const int kt = id.tile, kh = id.head, bi = id.batch;
  const int g = h / hk;
  const int q0 = off.q_start(), k0 = off.k_start();
  const int kbase = kt * BT;
  const int nqt = (sq + BT - 1) / BT, total = g * nqt;
  auto next = [&](int u) {  // the first (head, query tile) from u on that runs
    while (u < total && !tile_runs(mk, q0 + (u % nqt) * BT, BT, k0 + kbase, BT)) ++u;
    return u;
  };
  auto load_q = [&](int u, int stage) {
    const int hh = kh * g + u / nqt, i0 = (u % nqt) * BT;
    const uint32_t s = sT + stage * 2 * T::BYTES;
    load_tile<BT, D, NT>(s, q + bi * st.qb + hh * st.qh + i0 * st.qs, st.qs, sq - i0, tid);
    load_tile<BT, D, NT>(s + T::BYTES, dout + bi * st.ob + hh * st.oh + i0 * st.os, st.os,
                         sq - i0, tid);
    const int qi = i0 + tid % BT;  // threads 0-63 copy lse, 64-127 delta
    const float* src = (tid < BT ? lse : delta) + ((long long)bi * h + hh) * sq;
    cp4(sL + (stage * 2 * BT + tid) * 4, qi < sq ? src + qi : src, qi < sq);
  };
  load_tile<BT, D, NT>(sK, k + bi * st.kb + kh * st.kh + kbase * st.ks, st.ks, skv - kbase,
                       tid);
  load_tile<BT, D, NT>(sV, v + bi * st.vb + kh * st.vh + kbase * st.vs, st.vs, skv - kbase,
                       tid);
  int u = next(0);
  if (u < total) load_q(u, 0);
  cp_commit();

  const int krow = kbase + warp * 16 + lane / 4;  // this thread's keys: krow, krow + 8
  const float sl2 = sm_scale * LOG2E;
  float dka[DP / 2], dva[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dka[i] = dva[i] = 0.f;
  bool first = true;
  int since = 0;
  // add the accumulators into dk, dv (store them, the first time); restart
  auto fold = [&]() {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int kj = krow + 8 * r;
      if (kj >= skv) continue;
      const long long o = (((long long)bi * hk + kh) * skv + kj) * D;
#pragma unroll
      for (int i = 2 * r; i < DP / 2; i += 4) {
        const int c = frag_col(i, lane);
        if (c >= D) continue;
        float2* pk = reinterpret_cast<float2*>(dk + o + c);
        float2* pv = reinterpret_cast<float2*>(dv + o + c);
        const float2 ok = first ? make_float2(0.f, 0.f) : *pk;
        const float2 ov = first ? make_float2(0.f, 0.f) : *pv;
        *pk = make_float2(ok.x + dka[i], ok.y + dka[i + 1]);
        *pv = make_float2(ov.x + dva[i], ov.y + dva[i + 1]);
      }
    }
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dka[i] = dva[i] = 0.f;
    first = false;
    since = 0;
  };

  for (int stage = 0; u < total; stage ^= 1) {
    const int un = next(u + 1);
    if (un < total) load_q(un, stage ^ 1);
    cp_commit();
    cp_wait<1>();
    fence_async_smem();
    __syncthreads();
    const int i0 = (u % nqt) * BT;
    const uint32_t sQ = sT + stage * 2 * T::BYTES, sO = sQ + T::BYTES;
    const float* ls = lsm + stage * 2 * BT;
    const float* dls = ls + BT;
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(s, kmajor<BT, D>(sK, 0, kk), kmajor<BT, D>(sQ, 0, kk));
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(dp, kmajor<BT, D>(sV, 0, kk), kmajor<BT, D>(sO, 0, kk));
    wgmma_commit();
    wgmma_wait<0>();
    hold(s);
    hold(dp);
    // s = S^T, dp = dP^T: rows are keys, columns queries
    const bool full = kbase + BT <= skv && i0 + BT <= sq &&
                      tile_full(mk, q0 + i0, BT, k0 + kbase, BT);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = frag_col(i, lane), qi = i0 + c, kj = krow + 8 * frag_row(i);
      const float L = ls[c];
      const bool ok = L != -CUDART_INF_F &&
                      (full || (kj < skv && qi < sq && visible(mk, q0 + qi, k0 + kj)));
      const float p = ok ? ex2(s[i] * sl2 - L * LOG2E) : 0.f;
      dp[i] = p * (dp[i] - dls[c]) * sm_scale;
      s[i] = p;
    }
    uint32_t ph[4][4], pl[4][4], dh[4][4], dlo[4][4];
    to_frags_hi_lo<BT>(s, ph, pl);
    to_frags_hi_lo<BT>(dp, dh, dlo);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk) {
      const uint64_t bo = mnmajor<BT, D>(sO, kk), bq = mnmajor<BT, D>(sQ, kk);
      wgmma_rs<DP>(dva, ph[kk], bo);
      wgmma_rs<DP>(dva, pl[kk], bo);
      wgmma_rs<DP>(dka, dh[kk], bq);
      wgmma_rs<DP>(dka, dlo[kk], bq);
    }
    wgmma_commit();
    wgmma_wait<0>();
    hold(dva);
    hold(dka);
    hold(ph);
    hold(pl);
    hold(dh);
    hold(dlo);
    if (++since == FOLD) fold();
    __syncthreads();  // the stage is free for the tile after next
    u = un;
  }
  fold();  // the last partial; zeros where the block saw no query
}

// Both kernels on stream s: dq (b, h, sq, d) bf16 contiguous; dk, dv
// (b, hk, skv, d) f32 contiguous.
template <int D, class Off>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* delta, Off off, void* dq, float* dk, float* dv,
                   int b, int h, int hk, int sq, int skv, Masks mk, float sm_scale,
                   const Strides& st, cudaStream_t s) {
  const auto* qt = static_cast<const __nv_bfloat16*>(q);
  const auto* kt = static_cast<const __nv_bfloat16*>(k);
  const auto* vt = static_cast<const __nv_bfloat16*>(v);
  const auto* ot = static_cast<const __nv_bfloat16*>(dout);
  auto kdq = dq_tc_kernel<D, Off>;
  auto kdkv = dkv_tc_kernel<D, Off>;
  const int smem = Smem<D>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(kdq, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kdkv, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kdq<<<dim3((sq + BT - 1) / BT, h, b), NT, smem, s>>>(
      qt, kt, vt, ot, lse, delta, off, static_cast<__nv_bfloat16*>(dq), h, hk, sq, skv, mk,
      sm_scale, st);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  kdkv<<<dim3((skv + BT - 1) / BT, hk, b), NT, smem, s>>>(
      qt, kt, vt, ot, lse, delta, off, dk, dv, h, hk, sq, skv, mk, sm_scale, st);
  return cudaGetLastError();
}

}  // namespace bwd
}  // namespace attn
}  // namespace repro
