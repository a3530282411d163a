// Flash-attention forward (prefill) for Hopper.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py:51 flash_fwd_builder
// (reached through pl.pallas_call at src/repro/core/lang.py:1076).
//
// Computes o = softmax(q k^T * sm_scale + mask) v and lse (b, h, sq) in f32,
// with queries aligned to the end of the kv stream (q_offset = skv - sq), an
// optional causal mask and an optional sliding window (a key is visible
// when q_pos - k_pos < window). GQA: query head hh reads kv head
// hh / (h / hk).
//
// Bound on the H100: at prefill lengths (hundreds to a few thousand tokens)
// the work is 4 * sq * skv * d / 2 FLOPs per head against O((sq + skv) * d)
// bytes, so it is bound by operations, at the bf16 tensor-core rate. Two
// kernels, picked by the wrapper from dtype and layout before any launch:
//
// flash_fwd_tc (bf16, every product on wgmma): one block of one warpgroup
// per (64-row q tile, head, batch), several blocks an SM, so one block's
// softmax overlaps another's products. Q is copied once into
// 128-byte-swizzled shared memory (attn_sm90.cuh); K and V stream through
// two stages of 128 keys (64 at d = 128), the next tile's cp.async copies
// in flight while the current one is computed. S = Q K^T is a
// wgmma.m64n128k16 (m64n64k16) with both operands K-major; the online
// softmax (running max, sum, rescale, in base 2) runs on S's accumulator
// fragment in registers, with per-element masks only on tiles that cross
// an edge; O += P V is a wgmma whose A operand is P, rounded to bf16,
// straight from those registers (the plain version rounds p to v's dtype
// too), with V read MN-major through the transpose bit.
//
// flash_fwd (f32, and bf16 inputs the copies cannot read): the first
// design, f32 math on the CUDA cores. One block per (q-tile of 64 rows,
// head, batch); K/V tiles of 32 keys staged in shared memory as f32 and
// read by all 64 rows.
//
// Both: the kv loop stops at the block's causal diagonal and, with a
// window, starts at the tile holding the block's oldest visible key (the
// TPU kernel's _run_cond whole-block skip), so masked tiles are never
// loaded or computed. Ragged sequence lengths are masked in the kernel
// (the TPU version degrades its blocks with fit_block).
#include "attn_sm90.cuh"
#include "common.cuh"

namespace {

constexpr int BQ = 64;   // query rows per block
constexpr int BK = 32;   // keys per shared-memory tile
constexpr int NT = 256;  // 4 threads per query row

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ lse, int h, int hk, int sq, int skv,
    int causal, int window, float sm_scale, long long qsb, long long qsh, long long qss,
    long long ksb, long long ksh, long long kss, long long vsb, long long vsh,
    long long vss) {
  __shared__ float ks[BK][D + 1];  // +1: rows read by 4 lanes hit 4 banks
  __shared__ float vs[BK][D];
  const int t = threadIdx.x, lane = t & 31;
  const int r = t >> 2, sub = t & 3;  // row of the tile, lane within the row
  const int qt = blockIdx.x, hh = blockIdx.y, bi = blockIdx.z;
  const int kh = hh / (h / hk);
  const int q_offset = skv - sq;
  const int qi = qt * BQ + r;
  const bool row_ok = qi < sq;
  const int q_pos = qi + q_offset;

  float qr[D];
  const T* qp = q + bi * qsb + hh * qsh + (long long)(row_ok ? qi : 0) * qss;
#pragma unroll
  for (int dd = 0; dd < D; ++dd) qr[dd] = row_ok ? repro::to_f32(qp[dd]) : 0.f;

  float acc[D / 4];
#pragma unroll
  for (int c = 0; c < D / 4; ++c) acc[c] = 0.f;
  float m = -CUDART_INF_F, l = 0.f;

  int kv_end = skv, kv_begin = 0;
  if (causal) {
    const int last = min(qt * BQ + BQ - 1, sq - 1) + q_offset;
    kv_end = min(skv, last + 1);  // stop at the block's diagonal
  }
  if (window > 0)  // start at the tile of the block's oldest visible key
    kv_begin = max(0, qt * BQ + q_offset - window + 1) / BK * BK;
  const T* kb = k + bi * ksb + kh * ksh;
  const T* vb = v + bi * vsb + kh * vsh;
  const int base = lane & ~3;

  for (int k0 = kv_begin; k0 < kv_end; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    for (int e = t; e < BK * D; e += NT) {
      const int j = e / D, dd = e % D, kpos = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (kpos < skv) {
        kv = repro::to_f32(kb[kpos * kss + dd]);
        vv = repro::to_f32(vb[kpos * vss + dd]);
      }
      ks[j][dd] = kv;
      vs[j][dd] = vv;
    }
    __syncthreads();

    // scores for keys sub, sub+4, ...: each lane holds BK/4 of the row's BK
    float s[BK / 4];
    float tmax = -CUDART_INF_F;
#pragma unroll
    for (int i = 0; i < BK / 4; ++i) {
      const int j = sub + 4 * i, kpos = k0 + j;
      const bool ok = kpos < skv && (!causal || kpos <= q_pos) &&
                      (window <= 0 || q_pos - kpos < window);
      float dot = 0.f;
#pragma unroll
      for (int dd = 0; dd < D; ++dd) dot += qr[dd] * ks[j][dd];
      s[i] = ok ? dot * sm_scale : -CUDART_INF_F;
      tmax = fmaxf(tmax, s[i]);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(m, tmax);
    // fully-masked history (m == -inf) has acc == 0: its correction is 0
    const float corr = (m == -CUDART_INF_F) ? 0.f : expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 4; ++i) {
      s[i] = (s[i] == -CUDART_INF_F) ? 0.f : expf(s[i] - m_new);
      psum += s[i];
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * corr + psum;
    m = m_new;
#pragma unroll
    for (int c = 0; c < D / 4; ++c) acc[c] *= corr;
    // acc[c] (column sub + 4c) += sum_j p_j v[j]; p_j sits in lane base|(j%4)
#pragma unroll
    for (int i = 0; i < BK / 4; ++i) {
#pragma unroll
      for (int s4 = 0; s4 < 4; ++s4) {
        const float p = __shfl_sync(0xffffffffu, s[i], base | s4);
        const int j = s4 + 4 * i;
#pragma unroll
        for (int c = 0; c < D / 4; ++c) acc[c] += p * vs[j][sub + 4 * c];
      }
    }
  }

  if (row_ok) {
    const float lsafe = (l == 0.f) ? 1.f : l;
    T* op = o + (((long long)bi * gridDim.y + hh) * sq + qi) * D;
#pragma unroll
    for (int c = 0; c < D / 4; ++c) op[sub + 4 * c] = repro::from_f32<T>(acc[c] / lsafe);
    if (sub == 0) lse[((long long)bi * gridDim.y + hh) * sq + qi] = m + logf(lsafe);
  }
}

template <typename T, int D>
void launch(const void* q, const void* k, const void* v, void* o, float* lse,
            int b, int h, int hk, int sq, int skv, int causal, int window,
            float sm_scale, const long long* st, cudaStream_t stream) {
  dim3 grid((sq + BQ - 1) / BQ, h, b);
  flash_fwd_kernel<T, D><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, h, hk, sq, skv, causal, window, sm_scale, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8]);
}

}  // namespace

// ---------------------------------------------------------------------------
// the tensor-core kernel (bf16)
// ---------------------------------------------------------------------------

namespace tc {

using namespace repro::attn;
using repro::attn::NT;  // not the CUDA-core kernel's

constexpr int BQ = 64;  // query rows per block, one warpgroup

template <int D>
struct Fwd {
  static constexpr int BKV = D == 128 ? 64 : 128;  // keys per stage
  using TQ = Tile<BQ, D>;
  using TK = Tile<BKV, D>;
  static constexpr int DP = TQ::DP;
  static constexpr int STAGE = 2 * TK::BYTES;  // K, then V
  static constexpr int SMEM = TQ::BYTES + 2 * STAGE + 1024;  // + alignment
};

template <int D>
__global__ void __launch_bounds__(NT, D == 128 ? 1 : 2) flash_fwd_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
    float* __restrict__ lse, int h, int hk, int sq, int skv, int causal, int window,
    float sm_scale, long long qsb, long long qsh, long long qss, long long ksb,
    long long ksh, long long kss, long long vsb, long long vsh, long long vss) {
  using F = Fwd<D>;
  constexpr int DP = F::DP, BKV = F::BKV;
  extern __shared__ uint8_t smem_raw[];
  // tiles start on 1024-byte boundaries, the period of the swizzle
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sKV = sQ + F::TQ::BYTES;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // the last query tiles see the most keys: they start first
  const int qt = gridDim.x - 1 - blockIdx.x, hh = blockIdx.y, bi = blockIdx.z;
  const int kh = hh / (h / hk);
  const int q_offset = skv - sq;
  const int q0 = qt * BQ;

  int kv_end = skv, kv_begin = 0;
  if (causal) kv_end = min(skv, min(q0 + BQ, sq) + q_offset);  // the diagonal
  if (window > 0) kv_begin = max(0, q0 + q_offset - window + 1) / BKV * BKV;
  const int ntiles = kv_end > kv_begin ? (kv_end - kv_begin + BKV - 1) / BKV : 0;

  const __nv_bfloat16* kb = k + bi * ksb + kh * ksh;
  const __nv_bfloat16* vb = v + bi * vsb + kh * vsh;
  auto load_kv = [&](int t) {  // tile t into stage t % 2
    const int k0 = kv_begin + t * BKV;
    const uint32_t st = sKV + (t & 1) * F::STAGE;
    load_tile<BKV, D, NT>(st, kb + k0 * kss, kss, skv - k0, tid);
    load_tile<BKV, D, NT>(st + F::TK::BYTES, vb + k0 * vss, vss, skv - k0, tid);
  };
  load_tile<BQ, D, NT>(sQ, q + bi * qsb + hh * qsh + q0 * qss, qss, sq - q0, tid);
  if (ntiles > 0) load_kv(0);
  cp_commit();

  const int wrow = warp * 16 + lane / 4;  // this thread's rows: wrow, wrow + 8
  const int qp_first = q0 + q_offset;     // the block's first and last positions
  const int qp_last = min(q0 + BQ, sq) - 1 + q_offset;
  const float sl2 = sm_scale * LOG2E;  // scores in log2 units

  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};

  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) load_kv(t + 1);
    cp_commit();
    cp_wait<1>();  // tile t (and Q) have landed
    fence_async_smem();
    __syncthreads();  // ... for every thread
    const int k0 = kv_begin + t * BKV;
    const uint32_t sK = sKV + (t & 1) * F::STAGE, sV = sK + F::TK::BYTES;
    float s[BKV / 2];
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i) s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<BKV>(s, kmajor<BQ, D>(sQ, 0, kk), kmajor<BKV, D>(sK, 0, kk));
    wgmma_commit();
    wgmma_wait<0>();
    hold(s);

    // per-element masks only where the tile crosses an edge
    const bool edge = k0 + BKV > skv || (causal && k0 + BKV - 1 > qp_first) ||
                      (window > 0 && qp_last - k0 >= window);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i) {
      float x = s[i] * sl2;
      if (edge) {
        const int kp = k0 + frag_col(i, lane);
        const int qp = q0 + wrow + 8 * frag_row(i) + q_offset;
        if (kp >= skv || (causal && kp > qp) || (window > 0 && qp - kp >= window))
          x = -CUDART_INF_F;
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
    for (int kk = 0; kk < BKV / 16; ++kk) wgmma_rs<DP>(acc, pa[kk], mnmajor<BKV, D>(sV, kk));
    wgmma_commit();
    wgmma_wait<0>();
    hold(acc);
    hold(pa);
    __syncthreads();  // the stage is free for tile t + 2
  }

  const long long rowb = ((long long)bi * h + hh) * sq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int qi = q0 + wrow + 8 * r;
    if (qi >= sq) continue;
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
    __nv_bfloat16* op = o + (rowb + qi) * D;
#pragma unroll
    for (int i = 2 * r; i < DP / 2; i += 4) {
      const int c = frag_col(i, lane);
      if (c < D)
        *reinterpret_cast<__nv_bfloat162*>(op + c) =
            __floats2bfloat162_rn(acc[i] * inv, acc[i + 1] * inv);
    }
    if ((lane & 3) == 0)
      lse[rowb + qi] = l[r] > 0.f ? (m[r] + log2f(l[r])) * LN2 : -CUDART_INF_F;
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int b,
                   int h, int hk, int sq, int skv, int causal, int window, float sm_scale,
                   const long long* st, cudaStream_t stream) {
  auto kern = flash_fwd_tc_kernel<D>;
  const int smem = Fwd<D>::SMEM;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3((sq + BQ - 1) / BQ, h, b), NT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse, h, hk, sq,
      skv, causal, window, sm_scale, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8]);
  return cudaGetLastError();
}

}  // namespace tc

// dtype: 0 = float32, 1 = bfloat16. d in {32, 64, 128}; window <= 0 means
// no window. o is contiguous (b, h, sq, d), lse contiguous (b, h, sq);
// q/k/v take element strides for their batch, head and sequence axes (the
// last axis is contiguous).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         float* lse, int b, int h, int hk, int sq, int skv,
                         int d, int dtype, int causal, int window,
                         float sm_scale, long long qsb, long long qsh,
                         long long qss, long long ksb, long long ksh,
                         long long kss, long long vsb, long long vsh,
                         long long vss, void* stream) {
  const long long st[9] = {qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_FWD(T, D) \
  launch<T, D>(q, k, v, o, lse, b, h, hk, sq, skv, causal, window, sm_scale, st, s)
  if (dtype == 0 && d == 32) REPRO_FWD(float, 32);
  else if (dtype == 0 && d == 64) REPRO_FWD(float, 64);
  else if (dtype == 0 && d == 128) REPRO_FWD(float, 128);
  else if (dtype == 1 && d == 32) REPRO_FWD(__nv_bfloat16, 32);
  else if (dtype == 1 && d == 64) REPRO_FWD(__nv_bfloat16, 64);
  else if (dtype == 1 && d == 128) REPRO_FWD(__nv_bfloat16, 128);
  else return static_cast<int>(cudaErrorInvalidValue);
#undef REPRO_FWD
  return static_cast<int>(cudaGetLastError());
}

// The tensor-core kernel: bf16 q, k, v with 16-byte aligned bases and
// strides (elements) that are multiples of 8; otherwise as flash_fwd.
extern "C" int flash_fwd_tc(const void* q, const void* k, const void* v, void* o,
                            float* lse, int b, int h, int hk, int sq, int skv, int d,
                            int causal, int window, float sm_scale, long long qsb,
                            long long qsh, long long qss, long long ksb, long long ksh,
                            long long kss, long long vsb, long long vsh, long long vss,
                            void* stream) {
  const long long st[9] = {qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (d == 32) e = tc::launch<32>(q, k, v, o, lse, b, h, hk, sq, skv, causal, window, sm_scale, st, s);
  else if (d == 64) e = tc::launch<64>(q, k, v, o, lse, b, h, hk, sq, skv, causal, window, sm_scale, st, s);
  else if (d == 128) e = tc::launch<128>(q, k, v, o, lse, b, h, hk, sq, skv, causal, window, sm_scale, st, s);
  else e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
