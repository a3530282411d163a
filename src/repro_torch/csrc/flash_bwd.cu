// Flash-attention backward (dq, dk, dv) for Hopper.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py:210 flash_bwd_builder
// and the GQA head-group sum of its host path flash_attention_bwd
// (kernel.py:317), reached through pl.pallas_call at
// src/repro/core/lang.py:1076.
//
// From q, k, v, do, the forward's lse and delta = rowsum(do * o):
//   p  = exp(q k^T * sm_scale - lse) on visible keys, 0 elsewhere
//   dv = p^T do, ds = p * (do v^T - delta) * sm_scale, dk = ds^T q, dq = ds k
// with queries aligned to the end of the kv stream (q_offset = skv - sq), an
// optional causal mask and (on the tensor-core route) an optional sliding
// window. A query that sees no key (lse = -inf) gives p = 0, never NaN.
//
// Bound on the H100: operations. At the training shapes (B = 4, H = 32,
// S = 1024, D = 64) the backward is about 2.5 times the causal forward's
// FLOPs (43 GFLOP) against O(S D) bytes per head, held to the FLOPs over
// the bf16 tensor-core peak. The TPU kernel runs one grid with both block
// axes sequential, carrying dq in scratch across the kv sweep and
// accumulating dk/dv in revisited output blocks across the q sweep. Hopper
// blocks run in no order, so the work is split FA2-style into a dq kernel
// (one block per (64-query tile, head, batch), sweeping the kv tiles up to
// its causal diagonal) and a dk/dv kernel (one block per (64-key tile, kv
// head, batch), sweeping the g query heads of its group and the query tiles
// from its diagonal on), both recomputing p from lse, so dk and dv come out
// summed over the group in a fixed order with no atomics (the TPU path sums
// on the host). q, k, v and do are read with their strides (the
// projections' transposed views). Two routes, picked by the wrapper from
// dtype and layout before any launch:
//
// flash_bwd_tc (bf16 whose rows the 16-byte copies can read; head dims 32,
// 64, 128; causal and window masks): the tensor-core kernels of
// attn_bwd_sm90.cuh, which the ring backward shares, at q_start = skv - sq
// and k_start = 0 passed as ints. Every product on wgmma, dk/dv as hi/lo
// bf16 planes folded into f32 every 16 query tiles; the blocks of both
// kernels start from the tile with the most visible pairs.
//
// flash_bwd (f32, and bf16 the copies cannot read; head dims 32, 64; no
// window): the first design, f32 math on the CUDA cores. dq_kernel holds
// 4 threads per query row and stages k and v through shared memory as f32,
// 32 keys deep; dkv_kernel holds 64 keys a block and sweeps 32-query tiles.
#include "attn_bwd_sm90.cuh"
#include "common.cuh"

namespace {

constexpr int NT = 256;   // 4 threads per row
constexpr int BQ = 64;    // dq kernel: query rows per block
constexpr int BK = 32;    // dq kernel: keys per shared-memory tile
constexpr int BKV = 64;   // dkv kernel: keys per block
constexpr int BQT = 32;   // dkv kernel: queries per shared-memory tile

using repro::attn::Strides;

template <typename T, int D>
__global__ void __launch_bounds__(NT) dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq, int h, int hk, int sq,
    int skv, int causal, float sm_scale, Strides st) {
  __shared__ float ks[BK][D + 1];  // +1: rows read by 4 lanes hit 4 banks
  __shared__ float vs[BK][D + 1];
  const int t = threadIdx.x, lane = t & 31;
  const int r = t >> 2, sub = t & 3;  // row of the tile, lane within the row
  const int qt = blockIdx.x, hh = blockIdx.y, bi = blockIdx.z;
  const int kh = hh / (h / hk);
  const int q_offset = skv - sq;
  const int qi = qt * BQ + r;
  const bool row_ok = qi < sq;
  const int q_pos = qi + q_offset;
  const long long row = ((long long)bi * h + hh) * sq + qi;
  const float lse_r = row_ok ? lse[row] : -CUDART_INF_F;
  const float delta_r = row_ok ? delta[row] : 0.f;
  const bool live = row_ok && lse_r != -CUDART_INF_F;

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

  int kv_end = skv;
  if (causal) {
    const int last = min(qt * BQ + BQ - 1, sq - 1) + q_offset;
    kv_end = max(0, min(skv, last + 1));  // stop at the block's diagonal
  }
  const T* kb = k + bi * st.kb + kh * st.kh;
  const T* vb = v + bi * st.vb + kh * st.vh;
  const int base = lane & ~3;

  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    for (int e = t; e < BK * D; e += NT) {
      const int j = e / D, dd = e % D, kpos = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (kpos < skv) {
        kv = repro::to_f32(kb[kpos * st.ks + dd]);
        vv = repro::to_f32(vb[kpos * st.vs + dd]);
      }
      ks[j][dd] = kv;
      vs[j][dd] = vv;
    }
    __syncthreads();

    // ds for keys sub, sub+4, ...: each lane holds BK/4 of the row's BK
    float ds[BK / 4];
#pragma unroll
    for (int i = 0; i < BK / 4; ++i) {
      const int j = sub + 4 * i, kpos = k0 + j;
      const bool ok = live && kpos < skv && (!causal || kpos <= q_pos);
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int dd = 0; dd < D; ++dd) {
        s += qr[dd] * ks[j][dd];
        dp += dor[dd] * vs[j][dd];
      }
      const float p = ok ? expf(s * sm_scale - lse_r) : 0.f;
      ds[i] = p * (dp - delta_r) * sm_scale;
    }
    // acc[c] (column sub + 4c) += sum_j ds_j k[j]; ds_j sits in lane base|(j%4)
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
__global__ void __launch_bounds__(NT) dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv,
    int h, int hk, int sq, int skv, int causal, float sm_scale, Strides st) {
  __shared__ float qs[BQT][D + 1];
  __shared__ float dos[BQT][D + 1];
  __shared__ float ls[BQT];
  __shared__ float dls[BQT];
  const int t = threadIdx.x, lane = t & 31;
  const int r = t >> 2, sub = t & 3;  // key row of the tile, lane within it
  const int kt = blockIdx.x, kh = blockIdx.y, bi = blockIdx.z;
  const int g = h / hk;
  const int q_offset = skv - sq;
  const int kpos = kt * BKV + r;
  const bool key_ok = kpos < skv;

  float kr[D], vr[D];
  const long long krow = key_ok ? kpos : 0;
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

  // causal: the first query that sees this block's first key
  const int q_begin = causal ? max(0, kt * BKV - q_offset) / BQT * BQT : 0;
  const int base = lane & ~3;

  for (int gi = 0; gi < g; ++gi) {
    const int hh = kh * g + gi;
    const T* qb = q + bi * st.qb + hh * st.qh;
    const T* ob = dout + bi * st.ob + hh * st.oh;
    const long long rowb = ((long long)bi * h + hh) * sq;
    for (int q0 = q_begin; q0 < sq; q0 += BQT) {
      __syncthreads();  // the previous tile's readers are done
      for (int e = t; e < BQT * D; e += NT) {
        const int i = e / D, dd = e % D, qi = q0 + i;
        float qv = 0.f, ov = 0.f;
        if (qi < sq) {
          qv = repro::to_f32(qb[qi * st.qs + dd]);
          ov = repro::to_f32(ob[qi * st.os + dd]);
        }
        qs[i][dd] = qv;
        dos[i][dd] = ov;
      }
      if (t < BQT) {
        const int qi = q0 + t;
        ls[t] = qi < sq ? lse[rowb + qi] : -CUDART_INF_F;
        dls[t] = qi < sq ? delta[rowb + qi] : 0.f;
      }
      __syncthreads();

      // p and ds for queries sub, sub+4, ... of this key row
      float p[BQT / 4], ds[BQT / 4];
#pragma unroll
      for (int i4 = 0; i4 < BQT / 4; ++i4) {
        const int i = sub + 4 * i4, qi = q0 + i;
        const float li = ls[i];
        const bool ok = key_ok && qi < sq && li != -CUDART_INF_F &&
                        (!causal || kpos <= qi + q_offset);
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int dd = 0; dd < D; ++dd) {
          s += qs[i][dd] * kr[dd];
          dp += dos[i][dd] * vr[dd];
        }
        p[i4] = ok ? expf(s * sm_scale - li) : 0.f;
        ds[i4] = p[i4] * (dp - dls[i]) * sm_scale;
      }
      // dv += p_i do_i, dk += ds_i q_i; query i's values sit in lane base|(i%4)
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
    const long long off = (((long long)bi * hk + kh) * skv + kpos) * D;
#pragma unroll
    for (int c = 0; c < D / 4; ++c) {
      dk[off + sub + 4 * c] = dk_acc[c];
      dv[off + sub + 4 * c] = dv_acc[c];
    }
  }
}

template <typename T, int D>
void launch(const void* q, const void* k, const void* v, const void* dout,
            const float* lse, const float* delta, void* dq, float* dk, float* dv,
            int b, int h, int hk, int sq, int skv, int causal, float sm_scale,
            const Strides& st, cudaStream_t s) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* ot = static_cast<const T*>(dout);
  dq_kernel<T, D><<<dim3((sq + BQ - 1) / BQ, h, b), NT, 0, s>>>(
      qt, kt, vt, ot, lse, delta, static_cast<T*>(dq), h, hk, sq, skv, causal,
      sm_scale, st);
  dkv_kernel<T, D><<<dim3((skv + BKV - 1) / BKV, hk, b), NT, 0, s>>>(
      qt, kt, vt, ot, lse, delta, dk, dv, h, hk, sq, skv, causal, sm_scale, st);
}

}  // namespace

// The CUDA-core route. dtype: 0 = float32, 1 = bfloat16. d in {32, 64}. q, k, v and do take
// element strides for their batch, head and sequence axes (the last axis is
// contiguous); lse and delta are contiguous (b, h, sq) f32. dq is contiguous
// (b, h, sq, d) in the input dtype; dk and dv are contiguous (b, hk, skv, d)
// f32, summed over each kv head's query-head group.
extern "C" int flash_bwd(const void* q, const void* k, const void* v, const void* dout,
                         const float* lse, const float* delta, void* dq, float* dk,
                         float* dv, int b, int h, int hk, int sq, int skv, int d,
                         int dtype, int causal, float sm_scale, long long qsb,
                         long long qsh, long long qss, long long ksb, long long ksh,
                         long long kss, long long vsb, long long vsh, long long vss,
                         long long osb, long long osh, long long oss, void* stream) {
  const Strides st{qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && d == 32)
    launch<float, 32>(q, k, v, dout, lse, delta, dq, dk, dv, b, h, hk, sq, skv, causal,
                      sm_scale, st, s);
  else if (dtype == 0 && d == 64)
    launch<float, 64>(q, k, v, dout, lse, delta, dq, dk, dv, b, h, hk, sq, skv, causal,
                      sm_scale, st, s);
  else if (dtype == 1 && d == 32)
    launch<__nv_bfloat16, 32>(q, k, v, dout, lse, delta, dq, dk, dv, b, h, hk, sq, skv,
                              causal, sm_scale, st, s);
  else if (dtype == 1 && d == 64)
    launch<__nv_bfloat16, 64>(q, k, v, dout, lse, delta, dq, dk, dv, b, h, hk, sq, skv,
                              causal, sm_scale, st, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// The tensor-core route: bf16 q, k, v and do with 16-byte aligned bases and
// strides (elements) that are multiples of 8; d in {32, 64, 128}; window
// <= 0: no window; otherwise as flash_bwd.
extern "C" int flash_bwd_tc(const void* q, const void* k, const void* v, const void* dout,
                            const float* lse, const float* delta, void* dq, float* dk,
                            float* dv, int b, int h, int hk, int sq, int skv, int d,
                            int causal, int window, float sm_scale, long long qsb,
                            long long qsh, long long qss, long long ksb, long long ksh,
                            long long kss, long long vsb, long long vsh, long long vss,
                            long long osb, long long osh, long long oss, void* stream) {
  namespace attn = repro::attn;
  const Strides st{qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss};
  const attn::Masks mk{causal, window, 0};
  const attn::ValueOffsets off{skv - sq, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_FLASH_BWD_TC(D)                                                            \
  attn::bwd::launch<D>(q, k, v, dout, lse, delta, off, dq, dk, dv, b, h, hk, sq, skv, mk, \
                       sm_scale, st, s)
  cudaError_t e;
  if (d == 32) e = REPRO_FLASH_BWD_TC(32);
  else if (d == 64) e = REPRO_FLASH_BWD_TC(64);
  else if (d == 128) e = REPRO_FLASH_BWD_TC(128);
  else e = cudaErrorInvalidValue;
#undef REPRO_FLASH_BWD_TC
  return static_cast<int>(e);
}
