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
// inputs, f32 accumulators, one warpgroup a block. Head dims: DQK for q
// and k, DV for v and do; equal in {32, 64, 112, 128, 256}, or MLA's
// (192, 128). A tile of keys (or queries) that no pair of the block can
// see is skipped whole (the TPU kernel's run predicate, kernel.py:620-626,
// :730-736, with the prefix: tile_runs); tiles whose pairs are all visible
// skip the per-element masks.
//  - dq (dq_tc_kernel): Q and dO of 64 query rows resident; K and V stream
//    in two stages of BS keys. S = Q K^T (DQK deep) and dP = dO V^T (DV
//    deep) on wgmma, p = exp(s - lse) and ds = p (dp - delta) sm_scale on
//    their fragments, dQ += dS K with dS as the register A operand, one
//    bf16 plane (dq is rounded to bf16 anyway), DQK wide.
//  - dk/dv (dkv_tc_kernel): K and V of 64 keys resident; Q, dO, lse and
//    delta of BS query rows stream in two stages, over every query head of
//    the group. S^T = K Q^T and dP^T = V dO^T, then dV += P^T dO (DV wide)
//    and dK += dS^T Q (DQK wide) with P^T and dS^T in registers as two bf16
//    planes each, hi = bf16(x) and lo = bf16(x - hi): one plane rounds each
//    term by up to 2^-9, which over these sums reaches the 1e-3 limit of
//    dk/dv; two keep 2^-16. The tensor cores add each k16 step into their
//    f32 accumulator with truncation, so every FOLD streamed tiles the
//    accumulators are added into the f32 outputs (round to nearest) and
//    restarted: a partial drifts over at most FOLD x 4 x 2 steps.
// Products wider than 128 columns (dQ and dK at DQK 192 and 256, dV at
// 256) run as an m64n128k16 on the first two 64-column boxes of the B tile
// and an m64n64k16 (192) or a second m64n128k16 (256) two boxes in, on the
// two parts of one accumulator, whose fragment columns then run on as one
// (wgmma_rs_wide). At DQK = 112 rows are two boxes padded with zeros
// (attn_sm90.cuh), S takes 7 k16 steps and dQ, dK and dV run at N = 128
// into columns nobody stores past 112.
// Registers are what DQK >= 192 costs: dk/dv's two accumulators alone are
// DQK / 2 + DV / 2 f32 a thread (160 at (192, 128), 256 at 256), past the
// 255 a thread may hold once S^T, dP^T and their planes are added (the
// d = 128 kernel already reads 255 registers and spills 40 bytes on an
// H100 build). There (Cfg::SPLIT) the dk/dv grid has two blocks a key
// tile: one accumulates dK (S^T, dP^T, dS^T Q), the other dV (S^T, P^T
// dO, without V, dP^T or delta), each recomputing S^T: five products a
// visible pair where one block does four, and the dV block the lighter.
// And both kernels stream 32 rows a stage there (BS; 64 below), so S, dP
// and their fragments take half the registers: at 256 the dq kernel holds
// dQ's 128 f32 a thread beside 16 each of S and dP, as the forward holds O
// (attn_fwd_sm90.cuh). Shared memory: two resident 64-row tiles and two
// stages of two BS-row ones, 97.5 KB at d = 128 (as before), 130 KB at
// 256, 82 KB at (192, 128).
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

constexpr int BT = 64;     // rows of a block's own (resident) tiles
constexpr int FOLD = 16;   // dk/dv: streamed tiles between folds

template <int DQK, int DV>
struct Cfg {
  static constexpr bool SPLIT = DQK >= 192;    // dk/dv: a block for each
  static constexpr int BS = SPLIT ? 32 : 64;   // rows of a streamed tile
  using RA = Tile<BT, DQK>;  // resident: Q (dq) or K (dk/dv)
  using RB = Tile<BT, DV>;   // resident: dO (dq) or V (dk/dv)
  using SA = Tile<BS, DQK>;  // streamed: K (dq) or Q (dk/dv)
  using SB = Tile<BS, DV>;   // streamed: V (dq) or dO (dk/dv)
  static constexpr int DQP = RA::DP, DVP = RB::DP;  // accumulator columns
  static constexpr int STAGE = SA::BYTES + SB::BYTES;
  // the resident tiles, two stages, then the dk/dv kernel's lse and delta
  // for each stage, and the alignment
  static constexpr int BYTES = RA::BYTES + RB::BYTES + 2 * STAGE + 2 * 2 * BS * 4 + 1024;
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

// d (64 x N) += A (64 x 16, registers) . B (16 x N), B the k16 step kk of
// the ROWS x D tile at s read MN-major; N = the tile's padded width, in
// products of at most 128 columns (the second one two boxes in)
template <int N, int ROWS, int D>
__device__ __forceinline__ void wgmma_rs_wide(float (&d)[N / 2], const uint32_t (&a)[4],
                                              uint32_t s, int kk) {
  if constexpr (N <= 128) {
    wgmma_rs<N>(d, a, mnmajor<ROWS, D>(s, kk));
  } else {
    auto& lo = *reinterpret_cast<float(*)[64]>(d);
    auto& hi = *reinterpret_cast<float(*)[N / 2 - 64]>(d + 64);
    wgmma_rs<128>(lo, a, mnmajor<ROWS, D>(s, kk));
    wgmma_rs<N - 128>(hi, a, mnmajor<ROWS, D>(s + 2 * Tile<ROWS, D>::BOX, kk));
  }
}

// acc (64 x NP) += X (64 x BS, f32 in accumulator layout) . B (BS x NP),
// B the BS x D tile at s read MN-major, X as its hi and lo bf16 planes
template <int NP, int BS, int D>
__device__ __forceinline__ void accumulate_planes(float (&acc)[NP / 2], const float (&x)[BS / 2],
                                                  uint32_t s) {
  uint32_t hi[BS / 16][4], lo[BS / 16][4];
  to_frags_hi_lo<BS>(x, hi, lo);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BS / 16; ++kk) {
    wgmma_rs_wide<NP, BS, D>(acc, hi[kk], s, kk);
    wgmma_rs_wide<NP, BS, D>(acc, lo[kk], s, kk);
  }
  wgmma_commit();
  wgmma_wait<0>();
  hold(acc);
  hold(hi);
  hold(lo);
}

template <int DQK, int DV, class Off>
__global__ void __launch_bounds__(NT, 1) dq_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, Off off,
    __nv_bfloat16* __restrict__ dq, int h, int hk, int sq, int skv, Masks mk,
    float sm_scale, Strides st) {
  using C = Cfg<DQK, DV>;
  constexpr int BS = C::BS, DQP = C::DQP;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sO = sQ + C::RA::BYTES, sKV = sO + C::RB::BYTES;  // stage s: K, V at + s STAGE

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const BlockIds id = block_ids();
  const int qt = gridDim.x - 1 - id.tile, hh = id.head, bi = id.batch;
  const int kh = hh / (h / hk);
  const int q0 = off.q_start(), k0 = off.k_start();
  const int i0 = qt * BT;
  const int nk = (skv + BS - 1) / BS;
  auto next = [&](int j) {  // the first key tile from j on that the block sees
    while (j < nk && !tile_runs(mk, q0 + i0, BT, k0 + j * BS, BS)) ++j;
    return j;
  };
  const __nv_bfloat16* kb = k + bi * st.kb + kh * st.kh;
  const __nv_bfloat16* vb = v + bi * st.vb + kh * st.vh;
  auto load_kv = [&](int j, int stage) {
    const int j0 = j * BS;
    const uint32_t s = sKV + stage * C::STAGE;
    load_tile<BS, DQK, NT>(s, kb + j0 * st.ks, st.ks, skv - j0, tid);
    load_tile<BS, DV, NT>(s + C::SA::BYTES, vb + j0 * st.vs, st.vs, skv - j0, tid);
  };
  load_tile<BT, DQK, NT>(sQ, q + bi * st.qb + hh * st.qh + i0 * st.qs, st.qs, sq - i0, tid);
  load_tile<BT, DV, NT>(sO, dout + bi * st.ob + hh * st.oh + i0 * st.os, st.os, sq - i0, tid);
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
  float acc[DQP / 2];
#pragma unroll
  for (int i = 0; i < DQP / 2; ++i) acc[i] = 0.f;

  for (int stage = 0; j < nk; stage ^= 1) {
    const int jn = next(j + 1);
    if (jn < nk) load_kv(jn, stage ^ 1);
    cp_commit();
    cp_wait<1>();
    fence_async_smem();
    __syncthreads();
    const int j0 = j * BS;
    const uint32_t sK = sKV + stage * C::STAGE, sV = sK + C::SA::BYTES;
    float s[BS / 2], dp[BS / 2];
#pragma unroll
    for (int i = 0; i < BS / 2; ++i) s[i] = dp[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DQK / 16; ++kk)
      wgmma_ss<BS>(s, kmajor<BT, DQK>(sQ, 0, kk), kmajor<BS, DQK>(sK, 0, kk));
#pragma unroll
    for (int kk = 0; kk < DV / 16; ++kk)
      wgmma_ss<BS>(dp, kmajor<BT, DV>(sO, 0, kk), kmajor<BS, DV>(sV, 0, kk));
    wgmma_commit();
    wgmma_wait<0>();
    hold(s);
    hold(dp);
    const bool full = j0 + BS <= skv && tile_full(mk, q0 + i0, BT, k0 + j0, BS);
#pragma unroll
    for (int i = 0; i < BS / 2; ++i) {
      const int r = frag_row(i), kj = j0 + frag_col(i, lane);
      const bool ok =
          live[r] && (full || (kj < skv && visible(mk, q0 + i0 + wrow + 8 * r, k0 + kj)));
      const float p = ok ? ex2(s[i] * sl2 - lse2[r]) : 0.f;
      s[i] = p * (dp[i] - dl[r]) * sm_scale;
    }
    uint32_t da[BS / 16][4];
    to_frags<BS>(s, da);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BS / 16; ++kk) wgmma_rs_wide<DQP, BS, DQK>(acc, da[kk], sK, kk);
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
    __nv_bfloat16* out = dq + (rowb + qi) * DQK;
#pragma unroll
    for (int i = 2 * r; i < DQP / 2; i += 4) {
      const int c = frag_col(i, lane);
      if (c < DQK)
        *reinterpret_cast<__nv_bfloat162*>(out + c) = __floats2bfloat162_rn(acc[i], acc[i + 1]);
    }
  }
}

// One dk/dv block: dK (DK) and/or dV (DVO) of the 64 keys of key tile kt
template <int DQK, int DV, bool DK, bool DVO, class Off>
__device__ __forceinline__ void dkv_body(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, Off off,
    float* __restrict__ dk, float* __restrict__ dv, int h, int hk, int sq, int skv,
    Masks mk, float sm_scale, Strides st, int kt, int kh, int bi) {
  using C = Cfg<DQK, DV>;
  constexpr int BS = C::BS, DQP = C::DQP, DVP = C::DVP;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sK = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sV = sK + C::RA::BYTES, sT = sV + C::RB::BYTES;  // stage s: Q, dO at + s STAGE
  const uint32_t sL = sT + 2 * C::STAGE;  // stage s: lse[BS], delta[BS] at + 2s BS
  const float* lsm = reinterpret_cast<const float*>(smem_raw + (sL - smem_u32(smem_raw)));

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = h / hk;
  const int q0 = off.q_start(), k0 = off.k_start();
  const int kbase = kt * BT;
  const int nqt = (sq + BS - 1) / BS, total = g * nqt;
  auto next = [&](int u) {  // the first (head, query tile) from u on that runs
    while (u < total && !tile_runs(mk, q0 + (u % nqt) * BS, BS, k0 + kbase, BT)) ++u;
    return u;
  };
  auto load_q = [&](int u, int stage) {
    const int hh = kh * g + u / nqt, i0 = (u % nqt) * BS;
    const uint32_t s = sT + stage * C::STAGE;
    load_tile<BS, DQK, NT>(s, q + bi * st.qb + hh * st.qh + i0 * st.qs, st.qs, sq - i0, tid);
    load_tile<BS, DV, NT>(s + C::SA::BYTES, dout + bi * st.ob + hh * st.oh + i0 * st.os, st.os,
                          sq - i0, tid);
    if (tid < 2 * BS) {  // threads [0, BS) copy lse, [BS, 2 BS) delta
      const int qi = i0 + tid % BS;
      const float* src = (tid < BS ? lse : delta) + ((long long)bi * h + hh) * sq;
      cp4(sL + (stage * 2 * BS + tid) * 4, qi < sq ? src + qi : src, qi < sq);
    }
  };
  load_tile<BT, DQK, NT>(sK, k + bi * st.kb + kh * st.kh + kbase * st.ks, st.ks, skv - kbase,
                         tid);
  if constexpr (DK)  // the dV block needs no dP^T
    load_tile<BT, DV, NT>(sV, v + bi * st.vb + kh * st.vh + kbase * st.vs, st.vs, skv - kbase,
                          tid);
  int u = next(0);
  if (u < total) load_q(u, 0);
  cp_commit();

  const int krow = kbase + warp * 16 + lane / 4;  // this thread's keys: krow, krow + 8
  const float sl2 = sm_scale * LOG2E;
  float dka[DK ? DQP / 2 : 1], dva[DVO ? DVP / 2 : 1];
#pragma unroll
  for (int i = 0; i < (DK ? DQP / 2 : 0); ++i) dka[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (DVO ? DVP / 2 : 0); ++i) dva[i] = 0.f;
  bool first = true;
  int since = 0;
  // add the accumulators into dk, dv (store them, the first time); restart
  auto fold = [&]() {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int kj = krow + 8 * r;
      if (kj >= skv) continue;
      const long long row = ((long long)bi * hk + kh) * skv + kj;
      if constexpr (DK) {
#pragma unroll
        for (int i = 2 * r; i < DQP / 2; i += 4) {
          const int c = frag_col(i, lane);
          if (c >= DQK) continue;
          float2* pk = reinterpret_cast<float2*>(dk + row * DQK + c);
          const float2 o = first ? make_float2(0.f, 0.f) : *pk;
          *pk = make_float2(o.x + dka[i], o.y + dka[i + 1]);
        }
      }
      if constexpr (DVO) {
#pragma unroll
        for (int i = 2 * r; i < DVP / 2; i += 4) {
          const int c = frag_col(i, lane);
          if (c >= DV) continue;
          float2* pv = reinterpret_cast<float2*>(dv + row * DV + c);
          const float2 o = first ? make_float2(0.f, 0.f) : *pv;
          *pv = make_float2(o.x + dva[i], o.y + dva[i + 1]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < (DK ? DQP / 2 : 0); ++i) dka[i] = 0.f;
#pragma unroll
    for (int i = 0; i < (DVO ? DVP / 2 : 0); ++i) dva[i] = 0.f;
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
    const int i0 = (u % nqt) * BS;
    const uint32_t sQ = sT + stage * C::STAGE, sO = sQ + C::SA::BYTES;
    const float* ls = lsm + stage * 2 * BS;
    const float* dls = ls + BS;
    float s[BS / 2], dp[BS / 2];
#pragma unroll
    for (int i = 0; i < BS / 2; ++i) s[i] = dp[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DQK / 16; ++kk)
      wgmma_ss<BS>(s, kmajor<BT, DQK>(sK, 0, kk), kmajor<BS, DQK>(sQ, 0, kk));
    if constexpr (DK) {
#pragma unroll
      for (int kk = 0; kk < DV / 16; ++kk)
        wgmma_ss<BS>(dp, kmajor<BT, DV>(sV, 0, kk), kmajor<BS, DV>(sO, 0, kk));
    }
    wgmma_commit();
    wgmma_wait<0>();
    hold(s);
    if constexpr (DK) hold(dp);
    // s = S^T, dp = dP^T: rows are keys, columns queries
    const bool full = kbase + BT <= skv && i0 + BS <= sq &&
                      tile_full(mk, q0 + i0, BS, k0 + kbase, BT);
#pragma unroll
    for (int i = 0; i < BS / 2; ++i) {
      const int c = frag_col(i, lane), qi = i0 + c, kj = krow + 8 * frag_row(i);
      const float L = ls[c];
      const bool ok = L != -CUDART_INF_F &&
                      (full || (kj < skv && qi < sq && visible(mk, q0 + qi, k0 + kj)));
      const float p = ok ? ex2(s[i] * sl2 - L * LOG2E) : 0.f;
      if constexpr (DK) dp[i] = p * (dp[i] - dls[c]) * sm_scale;
      s[i] = p;
    }
    if constexpr (DVO && DK) {
      uint32_t ph[BS / 16][4], pl[BS / 16][4], dh[BS / 16][4], dlo[BS / 16][4];
      to_frags_hi_lo<BS>(s, ph, pl);
      to_frags_hi_lo<BS>(dp, dh, dlo);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BS / 16; ++kk) {
        wgmma_rs_wide<DVP, BS, DV>(dva, ph[kk], sO, kk);
        wgmma_rs_wide<DVP, BS, DV>(dva, pl[kk], sO, kk);
        wgmma_rs_wide<DQP, BS, DQK>(dka, dh[kk], sQ, kk);
        wgmma_rs_wide<DQP, BS, DQK>(dka, dlo[kk], sQ, kk);
      }
      wgmma_commit();
      wgmma_wait<0>();
      hold(dva);
      hold(dka);
      hold(ph);
      hold(pl);
      hold(dh);
      hold(dlo);
    } else if constexpr (DK) {  // one of the two (Cfg::SPLIT): dS^T Q ...
      accumulate_planes<DQP, BS, DQK>(dka, dp, sQ);
    } else {  // ... or P^T dO
      accumulate_planes<DVP, BS, DV>(dva, s, sO);
    }
    if (++since == FOLD) fold();
    __syncthreads();  // the stage is free for the tile after next
    u = un;
  }
  fold();  // the last partial; zeros where the block saw no query
}

template <int DQK, int DV, class Off>
__global__ void __launch_bounds__(NT, 1) dkv_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, Off off,
    float* __restrict__ dk, float* __restrict__ dv, int h, int hk, int sq, int skv,
    Masks mk, float sm_scale, Strides st) {
  const BlockIds id = block_ids();
  if constexpr (Cfg<DQK, DV>::SPLIT) {  // tile 2 kt: dK of key tile kt, 2 kt + 1: its dV
    if (id.tile % 2 == 0)
      dkv_body<DQK, DV, true, false>(q, k, v, dout, lse, delta, off, dk, dv, h, hk, sq, skv,
                                     mk, sm_scale, st, id.tile / 2, id.head, id.batch);
    else
      dkv_body<DQK, DV, false, true>(q, k, v, dout, lse, delta, off, dk, dv, h, hk, sq, skv,
                                     mk, sm_scale, st, id.tile / 2, id.head, id.batch);
  } else {
    dkv_body<DQK, DV, true, true>(q, k, v, dout, lse, delta, off, dk, dv, h, hk, sq, skv, mk,
                                  sm_scale, st, id.tile, id.head, id.batch);
  }
}

// Both kernels on stream s: dq (b, h, sq, DQK) bf16 contiguous; dk
// (b, hk, skv, DQK) and dv (b, hk, skv, DV) f32 contiguous.
template <int DQK, int DV, class Off>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* delta, Off off, void* dq, float* dk, float* dv,
                   int b, int h, int hk, int sq, int skv, Masks mk, float sm_scale,
                   const Strides& st, cudaStream_t s) {
  using C = Cfg<DQK, DV>;
  const auto* qt = static_cast<const __nv_bfloat16*>(q);
  const auto* kt = static_cast<const __nv_bfloat16*>(k);
  const auto* vt = static_cast<const __nv_bfloat16*>(v);
  const auto* ot = static_cast<const __nv_bfloat16*>(dout);
  auto kdq = dq_tc_kernel<DQK, DV, Off>;
  auto kdkv = dkv_tc_kernel<DQK, DV, Off>;
  const int smem = C::BYTES;
  cudaError_t e = cudaFuncSetAttribute(kdq, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kdkv, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kdq<<<dim3((sq + BT - 1) / BT, h, b), NT, smem, s>>>(
      qt, kt, vt, ot, lse, delta, off, static_cast<__nv_bfloat16*>(dq), h, hk, sq, skv, mk,
      sm_scale, st);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  kdkv<<<dim3((skv + BT - 1) / BT * (C::SPLIT ? 2 : 1), hk, b), NT, smem, s>>>(
      qt, kt, vt, ot, lse, delta, off, dk, dv, h, hk, sq, skv, mk, sm_scale, st);
  return cudaGetLastError();
}

}  // namespace bwd
}  // namespace attn
}  // namespace repro
