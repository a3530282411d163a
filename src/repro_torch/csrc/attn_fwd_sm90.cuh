// The tensor-core attention forward (bf16), shared by flash_fwd.cu
// (flash_fwd_tc: queries aligned to the end of the kv stream, q_start =
// skv - sq and k_start = 0 passed as ints) and ring_flash.cu
// (ring_flash_fwd_tc: one ring step at offsets read on the device). Both
// compute, at absolute positions q_start + i and k_start + j under the
// causal, window and prefix masks (the JAX _mask_block, kernel.py:145),
//   o = softmax(q k^T sm_scale) v over the visible keys, lse (b, h, sq) f32
// with o = 0 and lse = -inf on a row that sees no key: flash's rows always
// see one, and for the ring that is the identity of ring.py's merge.
//
// One block of one warpgroup per (64-row q tile, head, batch), several
// blocks an SM, so one block's softmax overlaps another's products; the
// last query tiles, which see the most keys under a causal mask with
// q_start >= k_start, start first. Q is copied once into 128-byte-swizzled
// shared memory (attn_sm90.cuh); K and V stream through two stages of 128
// keys (64 at d_qk > 64, 32 at 256), the next running tile's cp.async
// copies in flight while the current one is computed. S = Q K^T is a
// wgmma.m64n128k16 (m64n64k16, m64n32k16) with both operands K-major;
// the online softmax (running max, sum, rescale, in base 2) runs on S's
// accumulator fragment in registers; O += P V is a wgmma whose A operand
// is P, rounded to bf16, straight from those registers, with V read
// MN-major through the transpose bit.
//
// Masks: a key tile no row of the block can see is skipped whole (the TPU
// kernel's run predicate, tile_runs: the causal diagonal, the window's
// oldest key, the prefix), so the walk visits only running tiles, in
// ascending order. It steps through them in O(1) from the two ranges of
// tile indices that predicate admits: testing tile_runs tile by tile in a
// loop made the whole kernel 1.7x slower on an H100 (tools/ab_attn_fwd.py).
// Tiles every row sees whole (tile_full) skip the per-element masks; the
// others compare each key index with bounds each row works out once (the
// prefix, the window's oldest key, the diagonal), branch-free. A block
// that sees no tile of the chunk (a ring chunk wholly after its queries)
// reads its offsets, writes o = 0 and lse = -inf and loads nothing.
// Where the offsets come from is a template parameter (DeviceOffsets,
// ValueOffsets), so the flash forward allocates no device tensor for them.
//
// Head dims: DQK for q and k, DV for v and o. The ring takes DQK = DV in
// {32, 64, 128}; flash_fwd_tc also MLA's DQK = 192, DV = 128: S = Q K^T
// runs 12 k16 steps over three 64-column boxes of Q and K, O = P V, its
// accumulator and the epilogue are DV wide, and shared memory at 64 keys a
// stage holds Q (24 KB) and two stages of K (24 KB) and V (16 KB); and
// zamba2's DQK = DV = 112: rows padded to two boxes with zeros
// (attn_sm90.cuh), S takes 7 k16 steps, O = P V runs at N = 128 and the
// epilogue stores 112 columns; 64 keys a stage, as at 128; and
// paligemma's DQK = DV = 256: O's 64 x 256 f32 accumulator is 128
// registers a thread, and O += P V runs as two m64n128k16 products a k16
// step, over columns 0..127 and over 128..255 (two boxes into V), on the
// two halves of that accumulator; S takes 16 k16 steps over four boxes.
// At 64 keys a stage S and P's fragments took 48 more registers and
// ptxas spilled one (255 registers, an H100 build); at 32 keys a stage
// (S = Q K^T a wgmma.m64n32k16) they take 24, and shared memory holds Q
// (32 KB) and two stages of K and V (16 KB each), 97 KB, so two blocks
// share an SM where 64 keys (161 KB) left one.
#pragma once

#include "attn_sm90.cuh"

namespace repro {
namespace attn {
namespace fwd {

constexpr int BQ = 64;  // query rows per block, one warpgroup

// a / b rounded towards -inf, for b > 0
__device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

template <int DQK, int DV>
struct Smem {
  // keys per stage
  static constexpr int BKV = DQK == 256 ? 32 : DQK > 64 ? 64 : 128;
  using TQ = Tile<BQ, DQK>;
  using TK = Tile<BKV, DQK>;
  using TV = Tile<BKV, DV>;
  static constexpr int DP = TV::DP;  // accumulator columns
  static constexpr int STAGE = TK::BYTES + TV::BYTES;  // K, then V
  static constexpr int BYTES = TQ::BYTES + 2 * STAGE + 1024;  // + alignment
};

template <int DQK, int DV, class Off>
__global__ void __launch_bounds__(NT, DQK > 64 ? 1 : 2) fwd_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, Off off, __nv_bfloat16* __restrict__ o,
    float* __restrict__ lse, int h, int hk, int sq, int skv, Masks mk, float sm_scale,
    Strides st) {
  using F = Smem<DQK, DV>;
  constexpr int DP = F::DP, BKV = F::BKV;
  extern __shared__ uint8_t smem_raw[];
  // tiles start on 1024-byte boundaries, the period of the swizzle
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sKV = sQ + F::TQ::BYTES;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int qt = gridDim.x - 1 - blockIdx.x, hh = blockIdx.y, bi = blockIdx.z;
  const int kh = hh / (h / hk);
  const int qs0 = off.q_start(), ks0 = off.k_start();
  const int q0 = qt * BQ;
  const int nq = min(BQ, sq - q0);      // the block's rows
  const int qp_first = qs0 + q0;        // ... and their first position
  const int nk = (skv + BKV - 1) / BKV;
  // The key tiles tile_runs admits, as two ranges of tile indices: those
  // holding a key under the prefix, [0, p_end), and those between the
  // window's oldest key and the causal diagonal, [w_begin, c_end).
  const int c_end = mk.causal ? min(nk, floor_div(qp_first + nq - 1 - ks0, BKV) + 1) : nk;
  const int w_begin = mk.window > 0 ? max(0, floor_div(qp_first - mk.window + 1 - ks0, BKV)) : 0;
  const int p_end = mk.prefix > 0 ? min(nk, floor_div(mk.prefix - ks0 + BKV - 1, BKV)) : 0;
  auto next = [&](int j) {  // the first key tile from j on that the block sees
    if (j < p_end) return j;
    j = max(j, w_begin);
    return j < c_end ? j : nk;
  };
  const long long rowb = ((long long)bi * h + hh) * sq;
  int j = next(0);
  if (j >= nk) {  // no key of the chunk is visible to any row of the block
    for (int e = tid; e < nq * (DV / 8); e += NT) {
      const int r = e / (DV / 8), c = (e % (DV / 8)) * 8;
      *reinterpret_cast<uint4*>(o + (rowb + q0 + r) * DV + c) = make_uint4(0, 0, 0, 0);
    }
    if (tid < nq) lse[rowb + q0 + tid] = -CUDART_INF_F;
    return;
  }

  const __nv_bfloat16* kb = k + bi * st.kb + kh * st.kh;
  const __nv_bfloat16* vb = v + bi * st.vb + kh * st.vh;
  auto load_kv = [&](int jt, int stage) {  // key tile jt into the stage
    const int k0 = jt * BKV;
    const uint32_t s = sKV + stage * F::STAGE;
    load_tile<BKV, DQK, NT>(s, kb + k0 * st.ks, st.ks, skv - k0, tid);
    load_tile<BKV, DV, NT>(s + F::TK::BYTES, vb + k0 * st.vs, st.vs, skv - k0, tid);
  };
  load_tile<BQ, DQK, NT>(sQ, q + bi * st.qb + hh * st.qh + q0 * st.qs, st.qs, nq, tid);
  load_kv(j, 0);
  cp_commit();

  const int wrow = warp * 16 + lane / 4;  // this thread's rows: wrow, wrow + 8
  const float sl2 = sm_scale * LOG2E;     // scores in log2 units
  // The keys each of this thread's rows sees, as chunk indices j < skv
  // (visible() solved for j): j < pre (the prefix), or lo <= j <= hi (the
  // window's oldest key to the causal diagonal).
  const int pre = mk.prefix > 0 ? min(mk.prefix - ks0, skv) : 0;
  int lo[2], hi[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qj = qp_first + wrow + 8 * r - ks0;  // the row's position in chunk indices
    lo[r] = mk.window > 0 ? qj - mk.window + 1 : 0;
    hi[r] = mk.causal ? min(qj, skv - 1) : skv - 1;
  }

  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};

  for (int stage = 0; j < nk; stage ^= 1) {
    const int jn = next(j + 1);
    if (jn < nk) load_kv(jn, stage ^ 1);
    cp_commit();
    cp_wait<1>();  // tile j (and Q) have landed
    fence_async_smem();
    __syncthreads();  // ... for every thread
    const int k0 = j * BKV;
    const uint32_t sK = sKV + stage * F::STAGE, sV = sK + F::TK::BYTES;
    float s[BKV / 2];
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i) s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DQK / 16; ++kk)
      wgmma_ss<BKV>(s, kmajor<BQ, DQK>(sQ, 0, kk), kmajor<BKV, DQK>(sK, 0, kk));
    wgmma_commit();
    wgmma_wait<0>();
    hold(s);

    // per-element masks only where the tile is not seen whole by every row
    const bool full = k0 + BKV <= skv && tile_full(mk, qp_first, nq, ks0 + k0, BKV);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i) {
      float x = s[i] * sl2;
      if (!full) {
        const int kj = k0 + frag_col(i, lane), r = frag_row(i);
        if (!((kj >= lo[r] && kj <= hi[r]) || kj < pre)) x = -CUDART_INF_F;
      }
      s[i] = x;
      mx[frag_row(i)] = fmaxf(mx[frag_row(i)], x);
    }
    float mu[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // a row with no visible key yet keeps m = -inf, p = 0, acc = 0
      mu[r] = mx[r] == -CUDART_INF_F ? 0.f : mx[r];
      const float corr = ex2(m[r] - mu[r]);
      l[r] *= corr;
      m[r] = mx[r];
#pragma unroll
      for (int i = 2 * r; i < DP / 2; i += 4) {
        acc[i] *= corr;
        acc[i + 1] *= corr;
      }
    }
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i) {
      s[i] = ex2(s[i] - mu[frag_row(i)]);
      l[frag_row(i)] += s[i];  // this thread's share; summed at the end
    }
    uint32_t pa[BKV / 16][4];
    to_frags<BKV>(s, pa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      if constexpr (DP == 256) {  // two N = 128 halves, the second two boxes in
        auto& lo = *reinterpret_cast<float(*)[64]>(acc);
        auto& hi = *reinterpret_cast<float(*)[64]>(acc + 64);
        wgmma_rs<128>(lo, pa[kk], mnmajor<BKV, DV>(sV, kk));
        wgmma_rs<128>(hi, pa[kk], mnmajor<BKV, DV>(sV + 2 * F::TV::BOX, kk));
      } else {
        wgmma_rs<DP>(acc, pa[kk], mnmajor<BKV, DV>(sV, kk));
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    hold(acc);
    hold(pa);
    __syncthreads();  // the stage is free for the tile after next
    j = jn;
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int qi = q0 + wrow + 8 * r;
    if (qi >= sq) continue;
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
    __nv_bfloat16* op = o + (rowb + qi) * DV;
#pragma unroll
    for (int i = 2 * r; i < DP / 2; i += 4) {
      const int c = frag_col(i, lane);
      if (c < DV)
        *reinterpret_cast<__nv_bfloat162*>(op + c) =
            __floats2bfloat162_rn(acc[i] * inv, acc[i + 1] * inv);
    }
    if ((lane & 3) == 0)
      lse[rowb + qi] = l[r] > 0.f ? (m[r] + log2f(l[r])) * LN2 : -CUDART_INF_F;
  }
}

// The kernel on stream s: o (b, h, sq, dv) bf16 and lse (b, h, sq) f32,
// both contiguous.
template <int DQK, int DV, class Off>
cudaError_t launch(const void* q, const void* k, const void* v, Off off, void* o, float* lse,
                   int b, int h, int hk, int sq, int skv, Masks mk, float sm_scale,
                   const Strides& st, cudaStream_t s) {
  auto kern = fwd_tc_kernel<DQK, DV, Off>;
  const int smem = Smem<DQK, DV>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3((sq + BQ - 1) / BQ, h, b), NT, smem, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), off, static_cast<__nv_bfloat16*>(o), lse, h, hk,
      sq, skv, mk, sm_scale, st);
  return cudaGetLastError();
}

}  // namespace fwd
}  // namespace attn
}  // namespace repro
