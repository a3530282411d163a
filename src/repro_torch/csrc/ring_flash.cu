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
// bf16 tensor-core peak. Each direction has two kernels, picked by the
// wrapper from dtype and layout before any launch: for bf16 inputs the
// 16-byte copies can read, the tensor-core kernels (below); for f32 and
// other layouts ring_fwd_kernel and the ring_dq/ring_dkv kernels, the
// designs of flash_fwd.cu and flash_bwd.cu (f32 math on the CUDA cores).
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
// The bf16 forward (ring_flash_fwd_tc) is flash_fwd_tc's kernel,
// attn_fwd_sm90.cuh, with the offsets read on the device and the prefix
// mask: S and P V on wgmma, the walk over key tiles skipping those tile_runs
// rules out, a dead block (a chunk wholly after its queries) writing o = 0,
// lse = -inf after one read of the offsets. The bf16 backward
// (ring_flash_bwd_tc) runs the FA2 split on the tensor cores: the kernels
// of attn_bwd_sm90.cuh (shared with flash_bwd.cu's flash_bwd_tc), with the
// offsets read on the device.
#include "attn_bwd_sm90.cuh"
#include "attn_fwd_sm90.cuh"
#include "common.cuh"

namespace {

constexpr int NT = 256;   // 4 threads per row
constexpr int BQ = 64;    // forward and dq kernel: query rows per block
constexpr int BK = 32;    // forward and dq kernel: keys per shared tile
constexpr int BKV = 64;   // dk/dv kernel: keys per block
constexpr int BQT = 32;   // dk/dv kernel: queries per shared tile

using repro::attn::Masks;
using repro::attn::Strides;
using repro::attn::tile_runs;
using repro::attn::visible;

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

// The tensor-core forward: bf16 q, k and v with 16-byte aligned bases and
// strides (elements) that are multiples of 8; d in {32, 64, 128};
// otherwise as ring_flash_fwd.
extern "C" int ring_flash_fwd_tc(const void* q, const void* k, const void* v,
                                 const int* q_start, const int* k_start, void* o,
                                 float* lse, int b, int h, int hk, int sq, int skv, int d,
                                 int causal, int window, int prefix_len, float sm_scale,
                                 long long qsb, long long qsh, long long qss, long long ksb,
                                 long long ksh, long long kss, long long vsb, long long vsh,
                                 long long vss, void* stream) {
  const Strides st{qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, 0, 0, 0};
  const Masks mk{causal, window, prefix_len};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const repro::attn::DeviceOffsets off{q_start, k_start};
#define REPRO_RING_FWD_TC(D) \
  repro::attn::fwd::launch<D, D>(q, k, v, off, o, lse, b, h, hk, sq, skv, mk, sm_scale, st, s)
  cudaError_t e;
  if (d == 32) e = REPRO_RING_FWD_TC(32);
  else if (d == 64) e = REPRO_RING_FWD_TC(64);
  else if (d == 128) e = REPRO_RING_FWD_TC(128);
  else e = cudaErrorInvalidValue;
#undef REPRO_RING_FWD_TC
  return static_cast<int>(e);
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
  const repro::attn::DeviceOffsets off{q_start, k_start};
#define REPRO_RING_BWD_TC(D)                                                                \
  repro::attn::bwd::launch<D, D>(q, k, v, dout, lse, delta, off, dq, dk, dv, b, h, hk, sq, \
                                 skv, mk, sm_scale, st, s)
  cudaError_t e;
  if (d == 32) e = REPRO_RING_BWD_TC(32);
  else if (d == 64) e = REPRO_RING_BWD_TC(64);
  else if (d == 128) e = REPRO_RING_BWD_TC(128);
  else e = cudaErrorInvalidValue;
#undef REPRO_RING_BWD_TC
  return static_cast<int>(e);
}
