// One step of sequence-parallel ring flash attention for Hopper: forward
// (ring_flash_fwd) and backward (ring_flash_bwd).
//
// Replaces: src/repro/kernels/flash_attention/kernel.py:577
// ring_flash_fwd_builder and kernel.py:690 ring_flash_bwd_builder, with the
// GQA head-group sum of their host path (ring.py:192 _ring_step_bwd),
// reached through pl.pallas_call at src/repro/core/lang.py:1076.
//
// A ring step is flash attention of a query shard against one kv chunk at
// dynamic absolute offsets: query row i sits at q_start + i, key j at
// k_start + j. Both offsets are (1, 1) int32 tensors read on the device, so
// one launch signature serves every (shard, step) pair with no host sync.
// Masks (the JAX _mask_block, kernel.py:145): causal (k_pos <= q_pos),
// window (q_pos - k_pos < window) and prefix (k_pos < prefix_len is always
// visible, overriding both). The forward emits the chunk-normalised o and
// the chunk lse (b, h, sq) f32; a row that sees no key of the chunk gives
// o = 0, lse = -inf, the identity of the host's logsumexp merge. The
// backward recomputes p = exp(s - lse) from the step's own lse (p = 0 on
// rows with lse = -inf, never NaN) and takes delta' = rowsum(do o) - g_lse
// from the host:
//   dv = p^T do, ds = p * (do v^T - delta') * sm_scale, dk = ds^T q, dq = ds k
//
// Bound on the H100: operations. A step is 4 * d FLOPs per visible
// (query, key) pair per head forward (2.5 times that backward) against
// O((sq + skv) * d) bytes per head, held to the visible-pair FLOPs over the
// bf16 tensor-core peak. The forward and the f32 backward are the designs
// of flash_fwd.cu and flash_bwd.cu (f32 math on the CUDA cores).
// What the design does about it: a tile of keys (or, in the dk/dv kernels,
// of queries) is skipped whole when the TPU kernel's run predicate
// (kernel.py:620-626, :730-736) says no key of it is visible to any row of
// the block, so a chunk wholly after the query shard costs one offset read
// per block. The backward is split FA2-style into a dq kernel (one block per
// query tile, sweeping key tiles) and a dk/dv kernel (one block per key
// tile, sweeping the g query heads of its kv group and the query tiles), so
// dk and dv come out summed over the group in a fixed order with no atomics
// (the TPU kernel writes per-head dk/dv and the host sums). Ragged chunk and
// shard lengths are masked in the kernel.
//
// The bf16 backward (ring_flash_bwd_tc) runs that split on the tensor cores
// (attn_sm90.cuh): bf16 operands in 128-byte-swizzled shared memory, copied
// with cp.async from the strided inputs, f32 accumulators, one warpgroup a
// block and several blocks an SM, head dims 32, 64 and 128. Tiles whose
// pairs are all visible skip the per-element masks.
//  - dq (ring_dq_tc_kernel): Q and dO of 64 query rows resident; K and V
//    stream in two stages of 64 keys. S = Q K^T and dP = dO V^T on wgmma,
//    p = exp(s - lse) and ds = p (dp - delta') sm_scale on their fragments,
//    dQ += dS K with dS as the register A operand, one bf16 plane (dq is
//    rounded to bf16 anyway).
//  - dk/dv (ring_dkv_tc_kernel): K and V of 64 keys resident; Q, dO, lse
//    and delta' of 64 query rows stream in two stages. S^T = K Q^T and
//    dP^T = V dO^T, then dV += P^T dO and dK += dS^T Q with P^T and dS^T in
//    registers as two bf16 planes each, hi = bf16(x) and lo = bf16(x - hi):
//    one plane rounds each term by up to 2^-9, which over these sums
//    reaches the 1e-3 limit of dk/dv; two keep 2^-16. The tensor cores add
//    each k16 step into their f32 accumulator with truncation, so every
//    FOLD query tiles the accumulators are added into the f32 outputs
//    (round to nearest) and restarted: a partial drifts over at most
//    FOLD x 4 x 2 steps.
#include "attn_sm90.cuh"
#include "common.cuh"

namespace {

constexpr int NT = 256;   // 4 threads per row
constexpr int BQ = 64;    // forward and dq kernel: query rows per block
constexpr int BK = 32;    // forward and dq kernel: keys per shared tile
constexpr int BKV = 64;   // dk/dv kernel: keys per block
constexpr int BQT = 32;   // dk/dv kernel: queries per shared tile

struct Strides {  // element strides of the batch, head and sequence axes
  long long qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os;
};

struct Masks {
  int causal, window, prefix;  // window <= 0: none; prefix <= 0: none
};

__device__ __forceinline__ bool visible(const Masks& mk, int q_pos, int k_pos) {
  if (mk.prefix > 0 && k_pos < mk.prefix) return true;
  return (!mk.causal || k_pos <= q_pos) && (mk.window <= 0 || q_pos - k_pos < mk.window);
}

// The TPU kernel's whole-tile run predicate: may any key in
// [k_first, k_first + nk) be visible to any query in [q_first, q_first + nq)?
__device__ __forceinline__ bool tile_runs(const Masks& mk, int q_first, int nq,
                                          int k_first, int nk) {
  bool run = true;
  if (mk.causal) run &= k_first <= q_first + nq - 1;
  if (mk.window > 0) run &= q_first - (k_first + nk - 1) < mk.window;
  if (mk.prefix > 0) run |= k_first < mk.prefix;
  return run;
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) ring_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ q_start, const int* __restrict__ k_start,
    T* __restrict__ o, float* __restrict__ lse, int h, int hk, int sq, int skv,
    Masks mk, float sm_scale, Strides st) {
  __shared__ float ks[BK][D + 1];  // +1: rows read by 4 lanes hit 4 banks
  __shared__ float vs[BK][D];
  const int t = threadIdx.x, lane = t & 31;
  const int r = t >> 2, sub = t & 3;  // row of the tile, lane within the row
  const int qt = blockIdx.x, hh = blockIdx.y, bi = blockIdx.z;
  const int kh = hh / (h / hk);
  const int q0 = *q_start, k0 = *k_start;
  const int qi = qt * BQ + r;
  const bool row_ok = qi < sq;
  const int q_pos = q0 + qi;

  float qr[D];
  const T* qp = q + bi * st.qb + hh * st.qh + (long long)(row_ok ? qi : 0) * st.qs;
#pragma unroll
  for (int dd = 0; dd < D; ++dd) qr[dd] = row_ok ? repro::to_f32(qp[dd]) : 0.f;

  float acc[D / 4];
#pragma unroll
  for (int c = 0; c < D / 4; ++c) acc[c] = 0.f;
  float m = -CUDART_INF_F, l = 0.f;

  const T* kb = k + bi * st.kb + kh * st.kh;
  const T* vb = v + bi * st.vb + kh * st.vh;
  const int base = lane & ~3;

  for (int j0 = 0; j0 < skv; j0 += BK) {
    if (!tile_runs(mk, q0 + qt * BQ, BQ, k0 + j0, BK)) continue;  // uniform
    __syncthreads();  // the previous tile's readers are done
    for (int e = t; e < BK * D; e += NT) {
      const int j = e / D, dd = e % D, kj = j0 + j;
      float kv = 0.f, vv = 0.f;
      if (kj < skv) {
        kv = repro::to_f32(kb[kj * st.ks + dd]);
        vv = repro::to_f32(vb[kj * st.vs + dd]);
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
      const int j = sub + 4 * i, kj = j0 + j;
      const bool ok = row_ok && kj < skv && visible(mk, q_pos, k0 + kj);
      float dot = 0.f;
#pragma unroll
      for (int dd = 0; dd < D; ++dd) dot += qr[dd] * ks[j][dd];
      s[i] = ok ? dot * sm_scale : -CUDART_INF_F;
      tmax = fmaxf(tmax, s[i]);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(m, tmax);
    // a history with no visible key (m == -inf) has acc == 0: correction 0
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
    // no visible key: m = -inf, l = 0 -> o = 0, lse = -inf
    const float lsafe = (l == 0.f) ? 1.f : l;
    const long long row = ((long long)bi * h + hh) * sq + qi;
    T* op = o + row * D;
#pragma unroll
    for (int c = 0; c < D / 4; ++c) op[sub + 4 * c] = repro::from_f32<T>(acc[c] / lsafe);
    if (sub == 0) lse[row] = m + logf(lsafe);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) ring_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const int* __restrict__ q_start,
    const int* __restrict__ k_start, T* __restrict__ dq, int h, int hk, int sq,
    int skv, Masks mk, float sm_scale, Strides st) {
  __shared__ float ks[BK][D + 1];
  __shared__ float vs[BK][D + 1];
  const int t = threadIdx.x, lane = t & 31;
  const int r = t >> 2, sub = t & 3;
  const int qt = blockIdx.x, hh = blockIdx.y, bi = blockIdx.z;
  const int kh = hh / (h / hk);
  const int q0 = *q_start, k0 = *k_start;
  const int qi = qt * BQ + r;
  const bool row_ok = qi < sq;
  const int q_pos = q0 + qi;
  const long long row = ((long long)bi * h + hh) * sq + qi;
  const float lse_r = row_ok ? lse[row] : -CUDART_INF_F;
  const float delta_r = row_ok ? delta[row] : 0.f;
  const bool live = row_ok && lse_r != -CUDART_INF_F;  // exp argument stays finite

  float qr[D], dor[D];
  const long long qrow = row_ok ? qi : 0;
  const T* qp = q + bi * st.qb + hh * st.qh + qrow * st.qs;
  const T* op = dout + bi * st.ob + hh * st.oh + qrow * st.os;
#pragma unroll
  for (int dd = 0; dd < D; ++dd) {
    qr[dd] = row_ok ? repro::to_f32(qp[dd]) : 0.f;
    dor[dd] = row_ok ? repro::to_f32(op[dd]) : 0.f;
  }
  float acc[D / 4];
#pragma unroll
  for (int c = 0; c < D / 4; ++c) acc[c] = 0.f;

  const T* kb = k + bi * st.kb + kh * st.kh;
  const T* vb = v + bi * st.vb + kh * st.vh;
  const int base = lane & ~3;

  for (int j0 = 0; j0 < skv; j0 += BK) {
    if (!tile_runs(mk, q0 + qt * BQ, BQ, k0 + j0, BK)) continue;  // uniform
    __syncthreads();
    for (int e = t; e < BK * D; e += NT) {
      const int j = e / D, dd = e % D, kj = j0 + j;
      float kv = 0.f, vv = 0.f;
      if (kj < skv) {
        kv = repro::to_f32(kb[kj * st.ks + dd]);
        vv = repro::to_f32(vb[kj * st.vs + dd]);
      }
      ks[j][dd] = kv;
      vs[j][dd] = vv;
    }
    __syncthreads();

    float ds[BK / 4];
#pragma unroll
    for (int i = 0; i < BK / 4; ++i) {
      const int j = sub + 4 * i, kj = j0 + j;
      const bool ok = live && kj < skv && visible(mk, q_pos, k0 + kj);
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int dd = 0; dd < D; ++dd) {
        s += qr[dd] * ks[j][dd];
        dp += dor[dd] * vs[j][dd];
      }
      const float p = ok ? expf(s * sm_scale - lse_r) : 0.f;
      ds[i] = p * (dp - delta_r) * sm_scale;
    }
#pragma unroll
    for (int i = 0; i < BK / 4; ++i) {
#pragma unroll
      for (int s4 = 0; s4 < 4; ++s4) {
        const float dsj = __shfl_sync(0xffffffffu, ds[i], base | s4);
        const int j = s4 + 4 * i;
#pragma unroll
        for (int c = 0; c < D / 4; ++c) acc[c] += dsj * ks[j][sub + 4 * c];
      }
    }
  }

  if (row_ok) {
    T* out = dq + row * D;
#pragma unroll
    for (int c = 0; c < D / 4; ++c) out[sub + 4 * c] = repro::from_f32<T>(acc[c]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) ring_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const int* __restrict__ q_start,
    const int* __restrict__ k_start, float* __restrict__ dk, float* __restrict__ dv,
    int h, int hk, int sq, int skv, Masks mk, float sm_scale, Strides st) {
  __shared__ float qs[BQT][D + 1];
  __shared__ float dos[BQT][D + 1];
  __shared__ float ls[BQT];
  __shared__ float dls[BQT];
  const int t = threadIdx.x, lane = t & 31;
  const int r = t >> 2, sub = t & 3;  // key row of the tile, lane within it
  const int kt = blockIdx.x, kh = blockIdx.y, bi = blockIdx.z;
  const int g = h / hk;
  const int q0 = *q_start, k0 = *k_start;
  const int kj = kt * BKV + r;
  const bool key_ok = kj < skv;
  const int k_pos = k0 + kj;

  float kr[D], vr[D];
  const long long krow = key_ok ? kj : 0;
  const T* kp = k + bi * st.kb + kh * st.kh + krow * st.ks;
  const T* vp = v + bi * st.vb + kh * st.vh + krow * st.vs;
#pragma unroll
  for (int dd = 0; dd < D; ++dd) {
    kr[dd] = key_ok ? repro::to_f32(kp[dd]) : 0.f;
    vr[dd] = key_ok ? repro::to_f32(vp[dd]) : 0.f;
  }
  float dk_acc[D / 4], dv_acc[D / 4];
#pragma unroll
  for (int c = 0; c < D / 4; ++c) dk_acc[c] = dv_acc[c] = 0.f;
  const int base = lane & ~3;

  for (int gi = 0; gi < g; ++gi) {
    const int hh = kh * g + gi;
    const T* qb = q + bi * st.qb + hh * st.qh;
    const T* ob = dout + bi * st.ob + hh * st.oh;
    const long long rowb = ((long long)bi * h + hh) * sq;
    for (int i0 = 0; i0 < sq; i0 += BQT) {
      if (!tile_runs(mk, q0 + i0, BQT, k0 + kt * BKV, BKV)) continue;  // uniform
      __syncthreads();
      for (int e = t; e < BQT * D; e += NT) {
        const int i = e / D, dd = e % D, qi = i0 + i;
        float qv = 0.f, ov = 0.f;
        if (qi < sq) {
          qv = repro::to_f32(qb[qi * st.qs + dd]);
          ov = repro::to_f32(ob[qi * st.os + dd]);
        }
        qs[i][dd] = qv;
        dos[i][dd] = ov;
      }
      if (t < BQT) {
        const int qi = i0 + t;
        ls[t] = qi < sq ? lse[rowb + qi] : -CUDART_INF_F;
        dls[t] = qi < sq ? delta[rowb + qi] : 0.f;
      }
      __syncthreads();

      float p[BQT / 4], ds[BQT / 4];
#pragma unroll
      for (int i4 = 0; i4 < BQT / 4; ++i4) {
        const int i = sub + 4 * i4, qi = i0 + i;
        const float li = ls[i];
        const bool ok = key_ok && qi < sq && li != -CUDART_INF_F &&
                        visible(mk, q0 + qi, k_pos);
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int dd = 0; dd < D; ++dd) {
          s += qs[i][dd] * kr[dd];
          dp += dos[i][dd] * vr[dd];
        }
        p[i4] = ok ? expf(s * sm_scale - li) : 0.f;
        ds[i4] = p[i4] * (dp - dls[i]) * sm_scale;
      }
#pragma unroll
      for (int i4 = 0; i4 < BQT / 4; ++i4) {
#pragma unroll
        for (int s4 = 0; s4 < 4; ++s4) {
          const float pi = __shfl_sync(0xffffffffu, p[i4], base | s4);
          const float dsi = __shfl_sync(0xffffffffu, ds[i4], base | s4);
          const int i = s4 + 4 * i4;
#pragma unroll
          for (int c = 0; c < D / 4; ++c) {
            dv_acc[c] += pi * dos[i][sub + 4 * c];
            dk_acc[c] += dsi * qs[i][sub + 4 * c];
          }
        }
      }
    }
  }

  if (key_ok) {
    const long long off = (((long long)bi * hk + kh) * skv + kj) * D;
#pragma unroll
    for (int c = 0; c < D / 4; ++c) {
      dk[off + sub + 4 * c] = dk_acc[c];
      dv[off + sub + 4 * c] = dv_acc[c];
    }
  }
}

template <typename T, int D>
void launch_fwd(const void* q, const void* k, const void* v, const int* qs,
                const int* ks, void* o, float* lse, int b, int h, int hk, int sq,
                int skv, Masks mk, float sm_scale, const Strides& st,
                cudaStream_t s) {
  ring_fwd_kernel<T, D><<<dim3((sq + BQ - 1) / BQ, h, b), NT, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      qs, ks, static_cast<T*>(o), lse, h, hk, sq, skv, mk, sm_scale, st);
}

template <typename T, int D>
void launch_bwd(const void* q, const void* k, const void* v, const void* dout,
                const float* lse, const float* delta, const int* qs, const int* ks,
                void* dq, float* dk, float* dv, int b, int h, int hk, int sq, int skv,
                Masks mk, float sm_scale, const Strides& st, cudaStream_t s) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* ot = static_cast<const T*>(dout);
  ring_dq_kernel<T, D><<<dim3((sq + BQ - 1) / BQ, h, b), NT, 0, s>>>(
      qt, kt, vt, ot, lse, delta, qs, ks, static_cast<T*>(dq), h, hk, sq, skv, mk,
      sm_scale, st);
  ring_dkv_kernel<T, D><<<dim3((skv + BKV - 1) / BKV, hk, b), NT, 0, s>>>(
      qt, kt, vt, ot, lse, delta, qs, ks, dk, dv, h, hk, sq, skv, mk, sm_scale, st);
}

}  // namespace

// ---------------------------------------------------------------------------
// the tensor-core backward (bf16)
// ---------------------------------------------------------------------------

namespace tc {

using namespace repro::attn;
using repro::attn::NT;  // not the CUDA-core kernels'

constexpr int BT = 64;     // rows of every tile: a block's own, a stage's
constexpr int FOLD = 16;   // dk/dv: query tiles between folds

// May every key in [k_first, k_first + nk) be seen by every query in
// [q_first, q_first + nq)? Then a tile needs no per-element mask.
__device__ __forceinline__ bool tile_full(const Masks& mk, int q_first, int nq, int k_first,
                                          int nk) {
  const int q_last = q_first + nq - 1, k_last = k_first + nk - 1;
  if (mk.prefix > 0 && k_last < mk.prefix) return true;
  return (!mk.causal || k_last <= q_first) && (mk.window <= 0 || q_last - k_first < mk.window);
}

template <int D>
struct Smem {
  using T = Tile<BT, D>;
  static constexpr int DP = T::DP;
  // two resident tiles (Q, dO or K, V) and two stages of two streamed ones,
  // then the dk/dv kernel's lse and delta' for each stage
  static constexpr int BYTES = 6 * T::BYTES + 2 * 2 * BT * 4 + 1024;
};

template <int D>
__global__ void __launch_bounds__(NT, 1) ring_dq_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ q_start, const int* __restrict__ k_start,
    __nv_bfloat16* __restrict__ dq, int h, int hk, int sq, int skv, Masks mk,
    float sm_scale, Strides st) {
  using T = typename Smem<D>::T;
  constexpr int DP = T::DP;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sO = sQ + T::BYTES, sKV = sO + T::BYTES;  // stage s: K, V at + 2s

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int qt = gridDim.x - 1 - blockIdx.x, hh = blockIdx.y, bi = blockIdx.z;
  const int kh = hh / (h / hk);
  const int q0 = *q_start, k0 = *k_start;
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

template <int D>
__global__ void __launch_bounds__(NT, 1) ring_dkv_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ q_start, const int* __restrict__ k_start,
    float* __restrict__ dk, float* __restrict__ dv, int h, int hk, int sq, int skv,
    Masks mk, float sm_scale, Strides st) {
  using T = typename Smem<D>::T;
  constexpr int DP = T::DP;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sK = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sV = sK + T::BYTES, sT = sV + T::BYTES;  // stage s: Q, dO at + 2s
  const uint32_t sL = sT + 4 * T::BYTES;  // stage s: lse[BT], delta'[BT] at + 2s BT
  const float* lsm = reinterpret_cast<const float*>(smem_raw + (sL - smem_u32(smem_raw)));

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int kt = blockIdx.x, kh = blockIdx.y, bi = blockIdx.z;
  const int g = h / hk;
  const int q0 = *q_start, k0 = *k_start;
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
    const int qi = i0 + tid % BT;  // threads 0-63 copy lse, 64-127 delta'
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
      const long long off = (((long long)bi * hk + kh) * skv + kj) * D;
#pragma unroll
      for (int i = 2 * r; i < DP / 2; i += 4) {
        const int c = frag_col(i, lane);
        if (c >= D) continue;
        float2* pk = reinterpret_cast<float2*>(dk + off + c);
        float2* pv = reinterpret_cast<float2*>(dv + off + c);
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

template <int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* delta, const int* qs, const int* ks,
                       void* dq, float* dk, float* dv, int b, int h, int hk, int sq, int skv,
                       Masks mk, float sm_scale, const Strides& st, cudaStream_t s) {
  const auto* qt = static_cast<const __nv_bfloat16*>(q);
  const auto* kt = static_cast<const __nv_bfloat16*>(k);
  const auto* vt = static_cast<const __nv_bfloat16*>(v);
  const auto* ot = static_cast<const __nv_bfloat16*>(dout);
  auto kdq = ring_dq_tc_kernel<D>;
  auto kdkv = ring_dkv_tc_kernel<D>;
  const int smem = Smem<D>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(kdq, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kdkv, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kdq<<<dim3((sq + BT - 1) / BT, h, b), NT, smem, s>>>(
      qt, kt, vt, ot, lse, delta, qs, ks, static_cast<__nv_bfloat16*>(dq), h, hk, sq, skv, mk,
      sm_scale, st);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  kdkv<<<dim3((skv + BT - 1) / BT, hk, b), NT, smem, s>>>(
      qt, kt, vt, ot, lse, delta, qs, ks, dk, dv, h, hk, sq, skv, mk, sm_scale, st);
  return cudaGetLastError();
}

}  // namespace tc

// dtype: 0 = float32, 1 = bfloat16; d in {32, 64, 128}. q_start, k_start:
// one int32 each on the device. window <= 0: no window; prefix_len <= 0:
// no prefix. q, k, v take element strides for their batch, head and
// sequence axes (the last axis is contiguous); o is contiguous
// (b, h, sq, d) in the input dtype, lse contiguous (b, h, sq) f32.
extern "C" int ring_flash_fwd(const void* q, const void* k, const void* v,
                              const int* q_start, const int* k_start, void* o,
                              float* lse, int b, int h, int hk, int sq, int skv,
                              int d, int dtype, int causal, int window,
                              int prefix_len, float sm_scale, long long qsb,
                              long long qsh, long long qss, long long ksb,
                              long long ksh, long long kss, long long vsb,
                              long long vsh, long long vss, void* stream) {
  const Strides st{qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, 0, 0, 0};
  const Masks mk{causal, window, prefix_len};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_RING_FWD(T, D) \
  launch_fwd<T, D>(q, k, v, q_start, k_start, o, lse, b, h, hk, sq, skv, mk, sm_scale, st, s)
  if (dtype == 0 && d == 32) REPRO_RING_FWD(float, 32);
  else if (dtype == 0 && d == 64) REPRO_RING_FWD(float, 64);
  else if (dtype == 0 && d == 128) REPRO_RING_FWD(float, 128);
  else if (dtype == 1 && d == 32) REPRO_RING_FWD(__nv_bfloat16, 32);
  else if (dtype == 1 && d == 64) REPRO_RING_FWD(__nv_bfloat16, 64);
  else if (dtype == 1 && d == 128) REPRO_RING_FWD(__nv_bfloat16, 128);
  else return static_cast<int>(cudaErrorInvalidValue);
#undef REPRO_RING_FWD
  return static_cast<int>(cudaGetLastError());
}

// dtype: 0 = float32, 1 = bfloat16; d in {32, 64}. q, k, v and do take
// element strides for their batch, head and sequence axes; lse and delta
// (delta' = rowsum(do o) - g_lse) are contiguous (b, h, sq) f32. dq is
// contiguous (b, h, sq, d) in the input dtype; dk and dv are contiguous
// (b, hk, skv, d) f32, summed over each kv head's query-head group.
extern "C" int ring_flash_bwd(const void* q, const void* k, const void* v,
                              const void* dout, const float* lse, const float* delta,
                              const int* q_start, const int* k_start, void* dq,
                              float* dk, float* dv, int b, int h, int hk, int sq,
                              int skv, int d, int dtype, int causal, int window,
                              int prefix_len, float sm_scale, long long qsb,
                              long long qsh, long long qss, long long ksb,
                              long long ksh, long long kss, long long vsb,
                              long long vsh, long long vss, long long osb,
                              long long osh, long long oss, void* stream) {
  const Strides st{qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss};
  const Masks mk{causal, window, prefix_len};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_RING_BWD(T, D)                                                        \
  launch_bwd<T, D>(q, k, v, dout, lse, delta, q_start, k_start, dq, dk, dv, b, h, hk, \
                   sq, skv, mk, sm_scale, st, s)
  if (dtype == 0 && d == 32) REPRO_RING_BWD(float, 32);
  else if (dtype == 0 && d == 64) REPRO_RING_BWD(float, 64);
  else if (dtype == 1 && d == 32) REPRO_RING_BWD(__nv_bfloat16, 32);
  else if (dtype == 1 && d == 64) REPRO_RING_BWD(__nv_bfloat16, 64);
  else return static_cast<int>(cudaErrorInvalidValue);
#undef REPRO_RING_BWD
  return static_cast<int>(cudaGetLastError());
}

// The tensor-core backward: bf16 q, k, v and do with 16-byte aligned bases
// and strides (elements) that are multiples of 8; d in {32, 64, 128};
// otherwise as ring_flash_bwd.
extern "C" int ring_flash_bwd_tc(const void* q, const void* k, const void* v,
                                 const void* dout, const float* lse, const float* delta,
                                 const int* q_start, const int* k_start, void* dq,
                                 float* dk, float* dv, int b, int h, int hk, int sq,
                                 int skv, int d, int causal, int window, int prefix_len,
                                 float sm_scale, long long qsb, long long qsh,
                                 long long qss, long long ksb, long long ksh,
                                 long long kss, long long vsb, long long vsh,
                                 long long vss, long long osb, long long osh,
                                 long long oss, void* stream) {
  const Strides st{qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss};
  const Masks mk{causal, window, prefix_len};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_RING_BWD_TC(D)                                                            \
  tc::launch_bwd<D>(q, k, v, dout, lse, delta, q_start, k_start, dq, dk, dv, b, h, hk, sq, \
                    skv, mk, sm_scale, st, s)
  cudaError_t e;
  if (d == 32) e = REPRO_RING_BWD_TC(32);
  else if (d == 64) e = REPRO_RING_BWD_TC(64);
  else if (d == 128) e = REPRO_RING_BWD_TC(128);
  else e = cudaErrorInvalidValue;
#undef REPRO_RING_BWD_TC
  return static_cast<int>(e);
}
