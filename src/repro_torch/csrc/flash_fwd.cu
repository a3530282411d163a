// Flash-attention forward (prefill) for Hopper.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py:51 flash_fwd_builder
// (reached through pl.pallas_call at src/repro/core/lang.py:1076).
//
// Computes o = softmax(q k^T * sm_scale + mask) v and lse (b, h, sq) in f32,
// with queries aligned to the end of the kv stream (q_offset = skv - sq), an
// optional causal mask, an optional sliding window (a key is visible when
// q_pos - k_pos < window) and an optional prefix-LM prefix (keys at
// positions below `prefix` are visible to every query, whatever the other
// two say: the JAX _mask_block). GQA: query head hh reads kv head
// hh / (h / hk). Head dims: q and k DQK, v and o DV, equal in {32, 64,
// 112, 128, 256} (112: zamba2's shared attention; 256: paligemma), or MLA's
// DQK = 192 with DV = 128 (deepseek-v2's prefill: nope 128 + rope 64
// against v_head_dim 128), on both kernels.
//
// Bound on the H100: at prefill lengths (hundreds to a few thousand tokens)
// the work is 4 * sq * skv * d / 2 FLOPs per head against O((sq + skv) * d)
// bytes, so it is bound by operations, at the bf16 tensor-core rate. Two
// kernels, picked by the wrapper from dtype and layout before any launch:
//
// flash_fwd_tc (bf16, every product on wgmma): the kernel of
// attn_fwd_sm90.cuh, shared with ring_flash.cu's ring_flash_fwd_tc, at
// q_start = skv - sq and k_start = 0 passed by value, with the prefix in
// its Masks. One block
// of one warpgroup per (64-row q tile, head, batch), several blocks an SM,
// so one block's softmax overlaps another's products. Q is copied once into
// 128-byte-swizzled shared memory (attn_sm90.cuh); K and V stream through
// two stages of 128 keys (64 at d_qk > 64, 32 at 256), the next tile's
// cp.async copies in flight while the current one is computed. S = Q K^T is
// a wgmma.m64n128k16 (m64n64k16, m64n32k16) with both operands K-major;
// the online softmax (running max, sum, rescale, in base 2) runs on S's
// accumulator fragment in registers, with per-element masks only on tiles
// that cross an edge; O += P V is a wgmma whose A operand is P, rounded to
// bf16, straight from those registers (the plain version rounds p to v's
// dtype too), with V read MN-major through the transpose bit.
//
// flash_fwd (f32, and bf16 inputs the copies cannot read): the first
// design, f32 math on the CUDA cores. One block per (q-tile of 64 rows,
// head, batch), 4 lanes a row; K/V tiles staged in shared memory as f32
// and read by all 64 rows. Up to d 192 (flash_fwd_kernel) each lane holds
// the whole q row, scores 8 of a 32-key tile and owns a quarter of the
// output columns. At d = 256 (flash_fwd_wide_kernel) a whole q row would
// take 256 registers and 32-key tiles 64 KB of f32, past the 48 KB of
// static shared memory: each lane holds a quarter of q (columns sub + 4 i),
// the tile is 16 keys (32.1 KB), and every key's dot is finished by two
// shuffles across the row's 4 lanes; the row's 16 scores go through shared
// memory to its 4 lanes, which run the online softmax alike.
//
// Both: the kv loop stops at the block's causal diagonal (or past the
// prefix) and, with a window and no prefix, starts at the tile holding the
// block's oldest visible key (the TPU kernel's _run_cond whole-block
// skip), so tiles past the diagonal are never loaded or computed. Ragged
// sequence lengths are masked in the kernel (the TPU version degrades its
// blocks with fit_block).
#include "attn_fwd_sm90.cuh"
#include "common.cuh"

namespace {

namespace at = repro::attn;

constexpr int BQ = 64;   // query rows per block
constexpr int BK = 32;   // keys per shared-memory tile (BKW at d = 256)
constexpr int BKW = 16;
constexpr int NT = 256;  // 4 threads per query row

// The keys [x, y) that the rows [q0, q0 + nq) of a block may see, x a
// multiple of bk: from the tile of the window's oldest key to the causal
// diagonal, and with a prefix from the first key to the diagonal or past
// the prefix, whichever is later (with a window too, the masked tiles
// between the prefix and the window are visited as well).
__device__ __forceinline__ int2 key_range(const at::Masks& mk, int q0, int nq, int q_offset,
                                          int skv, int bk) {
  int begin = 0, end = skv;
  if (mk.causal) end = min(skv, q0 + nq + q_offset);  // past the diagonal
  if (mk.prefix > 0)
    end = max(end, min(skv, mk.prefix));
  else if (mk.window > 0)
    begin = max(0, q0 + q_offset - mk.window + 1) / bk * bk;
  return make_int2(begin, end);
}

template <typename T, int DQK, int DV>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ lse, int h, int hk, int sq, int skv,
    at::Masks mk, float sm_scale, long long qsb, long long qsh, long long qss,
    long long ksb, long long ksh, long long kss, long long vsb, long long vsh,
    long long vss) {
  __shared__ float ks[BK][DQK + 1];  // +1: rows read by 4 lanes hit 4 banks
  __shared__ float vs[BK][DV];
  const int t = threadIdx.x, lane = t & 31;
  const int r = t >> 2, sub = t & 3;  // row of the tile, lane within the row
  const int qt = blockIdx.x, hh = blockIdx.y, bi = blockIdx.z;
  const int kh = hh / (h / hk);
  const int q_offset = skv - sq;
  const int qi = qt * BQ + r;
  const bool row_ok = qi < sq;
  const int q_pos = qi + q_offset;

  float qr[DQK];
  const T* qp = q + bi * qsb + hh * qsh + (long long)(row_ok ? qi : 0) * qss;
#pragma unroll
  for (int dd = 0; dd < DQK; ++dd) qr[dd] = row_ok ? repro::to_f32(qp[dd]) : 0.f;

  float acc[DV / 4];
#pragma unroll
  for (int c = 0; c < DV / 4; ++c) acc[c] = 0.f;
  float m = -CUDART_INF_F, l = 0.f;

  const int2 kr = key_range(mk, qt * BQ, min(BQ, sq - qt * BQ), q_offset, skv, BK);
  const T* kb = k + bi * ksb + kh * ksh;
  const T* vb = v + bi * vsb + kh * vsh;
  const int base = lane & ~3;
  // the keys this row sees (at::visible solved for the key, and below
  // skv), so each key's test is branch-free: lo <= k <= hi, or k < pre.
  // at::visible itself in the unrolled score loop took this file's nvcc
  // from ~23 to ~90 s of CPU on an H100 machine, the build's slowest.
  const int hi = mk.causal ? min(q_pos, skv - 1) : skv - 1;
  const int lo = mk.window > 0 ? q_pos - mk.window + 1 : 0;
  const int pre = min(mk.prefix, skv);

  for (int k0 = kr.x; k0 < kr.y; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    for (int e = t; e < BK * DQK; e += NT) {
      const int j = e / DQK, dd = e % DQK, kpos = k0 + j;
      ks[j][dd] = kpos < skv ? repro::to_f32(kb[kpos * kss + dd]) : 0.f;
    }
    for (int e = t; e < BK * DV; e += NT) {
      const int j = e / DV, dd = e % DV, kpos = k0 + j;
      vs[j][dd] = kpos < skv ? repro::to_f32(vb[kpos * vss + dd]) : 0.f;
    }
    __syncthreads();

    // scores for keys sub, sub+4, ...: each lane holds BK/4 of the row's BK
    float s[BK / 4];
    float tmax = -CUDART_INF_F;
#pragma unroll
    for (int i = 0; i < BK / 4; ++i) {
      const int j = sub + 4 * i, kpos = k0 + j;
      const bool ok = ((kpos >= lo) & (kpos <= hi)) | (kpos < pre);
      float dot = 0.f;
#pragma unroll
      for (int dd = 0; dd < DQK; ++dd) dot += qr[dd] * ks[j][dd];
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
    for (int c = 0; c < DV / 4; ++c) acc[c] *= corr;
    // acc[c] (column sub + 4c) += sum_j p_j v[j]; p_j sits in lane base|(j%4)
#pragma unroll
    for (int i = 0; i < BK / 4; ++i) {
#pragma unroll
      for (int s4 = 0; s4 < 4; ++s4) {
        const float p = __shfl_sync(0xffffffffu, s[i], base | s4);
        const int j = s4 + 4 * i;
#pragma unroll
        for (int c = 0; c < DV / 4; ++c) acc[c] += p * vs[j][sub + 4 * c];
      }
    }
  }

  if (row_ok) {
    const float lsafe = (l == 0.f) ? 1.f : l;
    T* op = o + (((long long)bi * gridDim.y + hh) * sq + qi) * DV;
#pragma unroll
    for (int c = 0; c < DV / 4; ++c) op[sub + 4 * c] = repro::from_f32<T>(acc[c] / lsafe);
    if (sub == 0) lse[((long long)bi * gridDim.y + hh) * sq + qi] = m + logf(lsafe);
  }
}

// d = 256: lane sub of row r holds q columns sub + 4 i (i < 64) and owns
// output columns sub + 4 c (c < 64); 16-key tiles. The loops over a tile's
// keys stay rolled (the row's scores pass through shared memory), which
// keeps the kernel's code short.
template <typename T>
__global__ void __launch_bounds__(NT) flash_fwd_wide_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ lse, int h, int hk, int sq, int skv,
    at::Masks mk, float sm_scale, long long qsb, long long qsh, long long qss,
    long long ksb, long long ksh, long long kss, long long vsb, long long vsh,
    long long vss) {
  constexpr int D = 256, DQ = D / 4;
  __shared__ float ks[BKW][D + 1];  // +1: rows of consecutive keys on other banks
  __shared__ float vs[BKW][D];
  __shared__ float ss[BQ][BKW + 1];  // each row's scores; +1: rows on other banks
  const int t = threadIdx.x;
  const int r = t >> 2, sub = t & 3;
  const int qt = blockIdx.x, hh = blockIdx.y, bi = blockIdx.z;
  const int kh = hh / (h / hk);
  const int q_offset = skv - sq;
  const int qi = qt * BQ + r;
  const bool row_ok = qi < sq;
  const int q_pos = qi + q_offset;

  float qr[DQ];
  const T* qp = q + bi * qsb + hh * qsh + (long long)(row_ok ? qi : 0) * qss;
#pragma unroll
  for (int i = 0; i < DQ; ++i) qr[i] = row_ok ? repro::to_f32(qp[sub + 4 * i]) : 0.f;
  float acc[DQ];
#pragma unroll
  for (int c = 0; c < DQ; ++c) acc[c] = 0.f;
  float m = -CUDART_INF_F, l = 0.f;

  const int2 kr = key_range(mk, qt * BQ, min(BQ, sq - qt * BQ), q_offset, skv, BKW);
  const T* kb = k + bi * ksb + kh * ksh;
  const T* vb = v + bi * vsb + kh * vsh;
  for (int k0 = kr.x; k0 < kr.y; k0 += BKW) {
    __syncthreads();  // the previous tile's readers are done
    for (int e = t; e < BKW * D; e += NT) {
      const int j = e / D, dd = e % D, kpos = k0 + j;
      ks[j][dd] = kpos < skv ? repro::to_f32(kb[kpos * kss + dd]) : 0.f;
      vs[j][dd] = kpos < skv ? repro::to_f32(vb[kpos * vss + dd]) : 0.f;
    }
    __syncthreads();

    // every key's score, its dot finished across the row's 4 lanes (one
    // warp holds 8 whole rows, so a warp barrier publishes them)
#pragma unroll 1
    for (int j = 0; j < BKW; ++j) {
      float d2[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < DQ; ++i) d2[i & 1] += qr[i] * ks[j][sub + 4 * i];
      float dot = d2[0] + d2[1];
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      const int kpos = k0 + j;
      if (sub == 0)
        ss[r][j] = kpos < skv && at::visible(mk, q_pos, kpos) ? dot * sm_scale : -CUDART_INF_F;
    }
    __syncwarp();
    float tmax = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < BKW; ++j) tmax = fmaxf(tmax, ss[r][j]);
    const float m_new = fmaxf(m, tmax);
    // fully-masked history (m == -inf) has acc == 0: its correction is 0
    const float corr = (m == -CUDART_INF_F) ? 0.f : expf(m - m_new);
#pragma unroll
    for (int c = 0; c < DQ; ++c) acc[c] *= corr;
    float psum = 0.f;
#pragma unroll 1
    for (int j = 0; j < BKW; ++j) {
      const float sj = ss[r][j];
      const float p = (sj == -CUDART_INF_F) ? 0.f : expf(sj - m_new);
      psum += p;
#pragma unroll
      for (int c = 0; c < DQ; ++c) acc[c] += p * vs[j][sub + 4 * c];
    }
    l = l * corr + psum;
    m = m_new;
  }

  if (row_ok) {
    const float lsafe = (l == 0.f) ? 1.f : l;
    T* op = o + (((long long)bi * gridDim.y + hh) * sq + qi) * D;
#pragma unroll
    for (int c = 0; c < DQ; ++c) op[sub + 4 * c] = repro::from_f32<T>(acc[c] / lsafe);
    if (sub == 0) lse[((long long)bi * gridDim.y + hh) * sq + qi] = m + logf(lsafe);
  }
}

template <typename T, int DQK, int DV>
void launch(const void* q, const void* k, const void* v, void* o, float* lse,
            int b, int h, int hk, int sq, int skv, const at::Masks& mk,
            float sm_scale, const long long* st, cudaStream_t stream) {
  dim3 grid((sq + BQ - 1) / BQ, h, b);
  const auto kern = [] {
    if constexpr (DQK == 256)
      return flash_fwd_wide_kernel<T>;
    else
      return flash_fwd_kernel<T, DQK, DV>;
  }();
  kern<<<grid, NT, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, h, hk, sq, skv, mk, sm_scale, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8]);
}

}  // namespace


// dtype: 0 = float32, 1 = bfloat16. (d, dv) = (d, d) with d in {32, 64,
// 112, 128, 256}, or (192, 128); window <= 0 means no window, prefix <= 0
// no prefix. o is contiguous
// (b, h, sq, dv), lse contiguous (b, h, sq); q/k/v take element strides for
// their batch, head and sequence axes (the last axis is contiguous).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         float* lse, int b, int h, int hk, int sq, int skv,
                         int d, int dv, int dtype, int causal, int window,
                         int prefix, float sm_scale, long long qsb, long long qsh,
                         long long qss, long long ksb, long long ksh,
                         long long kss, long long vsb, long long vsh,
                         long long vss, void* stream) {
  const long long st[9] = {qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss};
  const at::Masks mk{causal, window, prefix};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_FWD(T, D, DV) \
  launch<T, D, DV>(q, k, v, o, lse, b, h, hk, sq, skv, mk, sm_scale, st, s)
  if (dtype == 0 && d == 32 && dv == 32) REPRO_FWD(float, 32, 32);
  else if (dtype == 0 && d == 64 && dv == 64) REPRO_FWD(float, 64, 64);
  else if (dtype == 0 && d == 112 && dv == 112) REPRO_FWD(float, 112, 112);
  else if (dtype == 0 && d == 128 && dv == 128) REPRO_FWD(float, 128, 128);
  else if (dtype == 0 && d == 192 && dv == 128) REPRO_FWD(float, 192, 128);
  else if (dtype == 0 && d == 256 && dv == 256) REPRO_FWD(float, 256, 256);
  else if (dtype == 1 && d == 32 && dv == 32) REPRO_FWD(__nv_bfloat16, 32, 32);
  else if (dtype == 1 && d == 64 && dv == 64) REPRO_FWD(__nv_bfloat16, 64, 64);
  else if (dtype == 1 && d == 112 && dv == 112) REPRO_FWD(__nv_bfloat16, 112, 112);
  else if (dtype == 1 && d == 128 && dv == 128) REPRO_FWD(__nv_bfloat16, 128, 128);
  else if (dtype == 1 && d == 192 && dv == 128) REPRO_FWD(__nv_bfloat16, 192, 128);
  else if (dtype == 1 && d == 256 && dv == 256) REPRO_FWD(__nv_bfloat16, 256, 256);
  else return static_cast<int>(cudaErrorInvalidValue);
#undef REPRO_FWD
  return static_cast<int>(cudaGetLastError());
}

// The tensor-core kernel: bf16 q, k, v with 16-byte aligned bases and
// strides (elements) that are multiples of 8; otherwise as flash_fwd.
extern "C" int flash_fwd_tc(const void* q, const void* k, const void* v, void* o,
                            float* lse, int b, int h, int hk, int sq, int skv, int d,
                            int dv, int causal, int window, int prefix, float sm_scale,
                            long long qsb, long long qsh, long long qss, long long ksb,
                            long long ksh, long long kss, long long vsb, long long vsh,
                            long long vss, void* stream) {
  const at::Strides st{qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, 0, 0, 0};
  const at::Masks mk{causal, window, prefix};
  const at::ValueOffsets off{skv - sq, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_FWD_TC(D, DV) \
  at::fwd::launch<D, DV>(q, k, v, off, o, lse, b, h, hk, sq, skv, mk, sm_scale, st, s)
  cudaError_t e;
  if (d == 32 && dv == 32) e = REPRO_FWD_TC(32, 32);
  else if (d == 64 && dv == 64) e = REPRO_FWD_TC(64, 64);
  else if (d == 112 && dv == 112) e = REPRO_FWD_TC(112, 112);
  else if (d == 128 && dv == 128) e = REPRO_FWD_TC(128, 128);
  else if (d == 192 && dv == 128) e = REPRO_FWD_TC(192, 128);
  else if (d == 256 && dv == 256) e = REPRO_FWD_TC(256, 256);
  else e = cudaErrorInvalidValue;
#undef REPRO_FWD_TC
  return static_cast<int>(e);
}
