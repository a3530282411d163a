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
// with queries aligned to the end of the kv stream (q_offset = skv - sq) and
// the forward's masks: causal, a sliding window (q_pos - k_pos < window) and
// a prefix-LM prefix (keys below it visible to every query, whatever the
// other two say: the JAX _mask_block). Head dims: q and k DQK, v and do DV,
// equal in {32, 64, 112, 128, 256} or MLA's (192, 128): every shape
// flash_fwd.cu takes, on both kernels. A query that sees no key (lse =
// -inf) gives p = 0, never NaN.
//
// Bound on the H100: operations. At training shapes (hundreds to a few
// thousand tokens) the backward is about 2.5 times the forward's FLOPs
// against O(S d) bytes per head, held to the FLOPs over the bf16
// tensor-core peak. The TPU kernel runs one grid with both block axes
// sequential, carrying dq in scratch across the kv sweep and accumulating
// dk/dv in revisited output blocks across the q sweep. Hopper blocks run in
// no order, so the work is split FA2-style into a dq kernel (one block per
// (query tile, head, batch), sweeping the key tiles it sees) and a dk/dv
// kernel (one block per (key tile, kv head, batch), sweeping the g query
// heads of its group and the query tiles that see it), both recomputing p
// from lse, so dk and dv come out summed over the group in a fixed order
// with no atomics (the TPU path sums on the host). Both skip a tile no pair
// of which is visible (the TPU kernel's _run_cond, at::tile_runs, with the
// prefix). q, k, v and do are read with their strides (the projections'
// transposed views). Two routes, picked by the wrapper from dtype and
// layout before any launch:
//
// flash_bwd_tc (bf16 whose rows the 16-byte copies can read): the
// tensor-core kernels of attn_bwd_sm90.cuh, which the ring backward
// shares, at q_start = skv - sq and k_start = 0 passed as ints, with the
// prefix in their Masks. Every product on wgmma, dk/dv as hi/lo bf16
// planes folded into f32 every 16 streamed tiles; the blocks of both
// kernels start from the tile with the most visible pairs. At d = 112 the
// rows are padded to 128 columns with zeros; at DQK >= 192 the products
// wider than 128 columns are two, each stage streams 32 rows, and the
// dk/dv grid gives dK and dV a block each, since one warpgroup cannot hold
// both accumulators beside S^T and dP^T (the header says why, in numbers).
//
// flash_bwd (f32, and bf16 the copies cannot read): f32 math on the CUDA
// cores. A row (a query row in dq_kernel, a key row in dkv_kernel) is kept
// by 4 lanes, each holding a quarter of it in registers (columns sub + 4 i)
// and owning the same quarter of its output; each dot is finished by two
// shuffles across the 4 lanes, so every lane has the score and no score
// goes through shared memory (whole rows a lane would be 2 d f32
// registers: no room past d = 64). The other side's rows stream through
// dynamic shared memory as f32, 16 keys (dq) or 16 queries (dk/dv) a
// tile, (DQK + DV) 64 bytes, sized at launch. Each key's mask test is
// against bounds a row works out once (branch-free, as flash_fwd.cu's
// CUDA-core kernels: at::visible's short-circuit test in an unrolled loop
// cost that file's nvcc about a minute). At d = 256 a key row's k, v, dk
// and dv quarters would be 256 registers, so there too dK and dV take a
// block each.
#include "attn_bwd_sm90.cuh"
#include "common.cuh"

namespace {

namespace at = repro::attn;

constexpr int NT = 256;   // 4 lanes a row
constexpr int BQ = 64;    // dq kernel: query rows a block
constexpr int BK = 16;    // dq kernel: keys a shared-memory tile
constexpr int BKV = 64;   // dk/dv kernel: key rows a block
constexpr int BQT = 16;   // dk/dv kernel: queries a shared-memory tile

using at::Strides;

// the CUDA-core dk/dv grid gives dK and dV a block each
template <int DQK, int DV>
__host__ __device__ constexpr bool simt_split() {
  return DQK + DV > 384;
}

// x . y over a row held a quarter a lane (lane sub: columns sub + 4 i),
// finished across the row's 4 lanes
template <int N>
__device__ __forceinline__ float quarter_dot(const float (&x)[N], const float* y, int sub) {
  float d2[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < N; ++i) d2[i & 1] += x[i] * y[sub + 4 * i];
  float d = d2[0] + d2[1];
  d += __shfl_xor_sync(0xffffffffu, d, 1);
  d += __shfl_xor_sync(0xffffffffu, d, 2);
  return d;
}

template <typename T, int DQK, int DV>
__global__ void __launch_bounds__(NT) dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq, int h, int hk, int sq,
    int skv, at::Masks mk, float sm_scale, Strides st) {
  extern __shared__ float smem[];
  float* ks = smem;             // [BK][DQK]
  float* vs = smem + BK * DQK;  // [BK][DV]
  const int t = threadIdx.x;
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

  float qr[DQK / 4], dor[DV / 4];
  const long long qrow = row_ok ? qi : 0;
  const T* qp = q + bi * st.qb + hh * st.qh + qrow * st.qs;
  const T* op = dout + bi * st.ob + hh * st.oh + qrow * st.os;
#pragma unroll
  for (int i = 0; i < DQK / 4; ++i) qr[i] = row_ok ? repro::to_f32(qp[sub + 4 * i]) : 0.f;
#pragma unroll
  for (int i = 0; i < DV / 4; ++i) dor[i] = row_ok ? repro::to_f32(op[sub + 4 * i]) : 0.f;
  float acc[DQK / 4];
#pragma unroll
  for (int c = 0; c < DQK / 4; ++c) acc[c] = 0.f;

  // the keys this row sees (at::visible solved for the key, below skv):
  // lo <= k <= hi, or k < pre
  const int lo = mk.window > 0 ? q_pos - mk.window + 1 : 0;
  const int hi = mk.causal ? min(q_pos, skv - 1) : skv - 1;
  const int pre = min(mk.prefix, skv);
  const int nq = min(BQ, sq - qt * BQ);
  const T* kb = k + bi * st.kb + kh * st.kh;
  const T* vb = v + bi * st.vb + kh * st.vh;

  for (int k0 = 0; k0 < skv; k0 += BK) {
    if (!at::tile_runs(mk, qt * BQ + q_offset, nq, k0, BK)) continue;  // the whole block
    __syncthreads();  // the previous tile's readers are done
    for (int e = t; e < BK * DQK; e += NT) {
      const int j = e / DQK, dd = e % DQK, kpos = k0 + j;
      ks[e] = kpos < skv ? repro::to_f32(kb[kpos * st.ks + dd]) : 0.f;
    }
    for (int e = t; e < BK * DV; e += NT) {
      const int j = e / DV, dd = e % DV, kpos = k0 + j;
      vs[e] = kpos < skv ? repro::to_f32(vb[kpos * st.vs + dd]) : 0.f;
    }
    __syncthreads();
#pragma unroll 1
    for (int j = 0; j < BK; ++j) {
      const float s = quarter_dot(qr, ks + j * DQK, sub);
      const float dp = quarter_dot(dor, vs + j * DV, sub);
      const int kpos = k0 + j;
      const bool ok = live & (((kpos >= lo) & (kpos <= hi)) | (kpos < pre));
      const float p = ok ? expf(s * sm_scale - lse_r) : 0.f;
      const float ds = p * (dp - delta_r) * sm_scale;
#pragma unroll
      for (int c = 0; c < DQK / 4; ++c) acc[c] += ds * ks[j * DQK + sub + 4 * c];
    }
  }

  if (row_ok) {
    T* out = dq + row * DQK;
#pragma unroll
    for (int c = 0; c < DQK / 4; ++c) out[sub + 4 * c] = repro::from_f32<T>(acc[c]);
  }
}

// One key row's dK (DK) and/or dV (DVO), a quarter a lane, over every
// query head of its group
template <typename T, int DQK, int DV, bool DK, bool DVO>
__device__ __forceinline__ void dkv_body(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv,
    int h, int hk, int sq, int skv, const at::Masks& mk, float sm_scale, const Strides& st,
    int kt) {
  extern __shared__ float smem[];
  float* qs = smem;              // [BQT][DQK]
  float* dos = qs + BQT * DQK;   // [BQT][DV]
  float* ls = dos + BQT * DV;    // [BQT]
  float* dls = ls + BQT;         // [BQT]
  const int t = threadIdx.x;
  const int r = t >> 2, sub = t & 3;  // key row of the block, lane within it
  const int kh = blockIdx.y, bi = blockIdx.z;
  const int g = h / hk;
  const int q_offset = skv - sq;
  const int kpos = kt * BKV + r;
  const bool key_ok = kpos < skv;

  float kr[DQK / 4], vr[DK ? DV / 4 : 1];
  const long long krow = key_ok ? kpos : 0;
  const T* kp = k + bi * st.kb + kh * st.kh + krow * st.ks;
  const T* vp = v + bi * st.vb + kh * st.vh + krow * st.vs;
#pragma unroll
  for (int i = 0; i < DQK / 4; ++i) kr[i] = key_ok ? repro::to_f32(kp[sub + 4 * i]) : 0.f;
  if constexpr (DK) {
#pragma unroll
    for (int i = 0; i < DV / 4; ++i) vr[i] = key_ok ? repro::to_f32(vp[sub + 4 * i]) : 0.f;
  }
  float dk_acc[DK ? DQK / 4 : 1], dv_acc[DVO ? DV / 4 : 1];
#pragma unroll
  for (int c = 0; c < (DK ? DQK / 4 : 0); ++c) dk_acc[c] = 0.f;
#pragma unroll
  for (int c = 0; c < (DVO ? DV / 4 : 0); ++c) dv_acc[c] = 0.f;

  // the queries (indices) that see this key: all of them under the prefix,
  // else qlo <= i <= qhi (at::visible solved for the query)
  const bool all = kpos < mk.prefix;
  const int qlo = mk.causal ? kpos - q_offset : 0;
  const int qhi = mk.window > 0 ? kpos + mk.window - 1 - q_offset : sq - 1;
  const int nk = min(BKV, skv - kt * BKV);

  for (int gi = 0; gi < g; ++gi) {
    const int hh = kh * g + gi;
    const T* qb = q + bi * st.qb + hh * st.qh;
    const T* ob = dout + bi * st.ob + hh * st.oh;
    const long long rowb = ((long long)bi * h + hh) * sq;
    for (int q0 = 0; q0 < sq; q0 += BQT) {
      if (!at::tile_runs(mk, q0 + q_offset, min(BQT, sq - q0), kt * BKV, nk)) continue;
      __syncthreads();  // the previous tile's readers are done
      for (int e = t; e < BQT * DQK; e += NT) {
        const int i = e / DQK, dd = e % DQK, qi = q0 + i;
        qs[e] = qi < sq ? repro::to_f32(qb[qi * st.qs + dd]) : 0.f;
      }
      for (int e = t; e < BQT * DV; e += NT) {
        const int i = e / DV, dd = e % DV, qi = q0 + i;
        dos[e] = qi < sq ? repro::to_f32(ob[qi * st.os + dd]) : 0.f;
      }
      if (t < BQT) {
        const int qi = q0 + t;
        ls[t] = qi < sq ? lse[rowb + qi] : -CUDART_INF_F;
        dls[t] = qi < sq ? delta[rowb + qi] : 0.f;
      }
      __syncthreads();
#pragma unroll 1
      for (int i = 0; i < BQT; ++i) {
        const float s = quarter_dot(kr, qs + i * DQK, sub);
        const int qi = q0 + i;
        const float L = ls[i];
        const bool ok = key_ok & (L != -CUDART_INF_F) & (all | ((qi >= qlo) & (qi <= qhi)));
        const float p = ok ? expf(s * sm_scale - L) : 0.f;
        if constexpr (DVO) {
#pragma unroll
          for (int c = 0; c < DV / 4; ++c) dv_acc[c] += p * dos[i * DV + sub + 4 * c];
        }
        if constexpr (DK) {
          const float dp = quarter_dot(vr, dos + i * DV, sub);
          const float ds = p * (dp - dls[i]) * sm_scale;
#pragma unroll
          for (int c = 0; c < DQK / 4; ++c) dk_acc[c] += ds * qs[i * DQK + sub + 4 * c];
        }
      }
    }
  }

  if (key_ok) {
    const long long row = ((long long)bi * hk + kh) * skv + kpos;
    if constexpr (DK) {
#pragma unroll
      for (int c = 0; c < DQK / 4; ++c) dk[row * DQK + sub + 4 * c] = dk_acc[c];
    }
    if constexpr (DVO) {
#pragma unroll
      for (int c = 0; c < DV / 4; ++c) dv[row * DV + sub + 4 * c] = dv_acc[c];
    }
  }
}

template <typename T, int DQK, int DV>
__global__ void __launch_bounds__(NT) dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv,
    int h, int hk, int sq, int skv, at::Masks mk, float sm_scale, Strides st) {
  if constexpr (simt_split<DQK, DV>()) {  // block 2 kt: dK of key tile kt, 2 kt + 1: its dV
    const int kt = blockIdx.x / 2;
    if (blockIdx.x % 2 == 0)
      dkv_body<T, DQK, DV, true, false>(q, k, v, dout, lse, delta, dk, dv, h, hk, sq, skv,
                                        mk, sm_scale, st, kt);
    else
      dkv_body<T, DQK, DV, false, true>(q, k, v, dout, lse, delta, dk, dv, h, hk, sq, skv,
                                        mk, sm_scale, st, kt);
  } else {
    dkv_body<T, DQK, DV, true, true>(q, k, v, dout, lse, delta, dk, dv, h, hk, sq, skv, mk,
                                     sm_scale, st, blockIdx.x);
  }
}

template <typename T, int DQK, int DV>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* delta, void* dq, float* dk, float* dv,
                   int b, int h, int hk, int sq, int skv, const at::Masks& mk,
                   float sm_scale, const Strides& st, cudaStream_t s) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* ot = static_cast<const T*>(dout);
  // at most (256 + 256) 64 bytes: under the 48 KB a launch may ask for
  constexpr int dq_smem = BK * (DQK + DV) * 4;
  constexpr int dkv_smem = (BQT * (DQK + DV) + 2 * BQT) * 4;
  dq_kernel<T, DQK, DV><<<dim3((sq + BQ - 1) / BQ, h, b), NT, dq_smem, s>>>(
      qt, kt, vt, ot, lse, delta, static_cast<T*>(dq), h, hk, sq, skv, mk, sm_scale, st);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int nkb = (skv + BKV - 1) / BKV * (simt_split<DQK, DV>() ? 2 : 1);
  dkv_kernel<T, DQK, DV><<<dim3(nkb, hk, b), NT, dkv_smem, s>>>(
      qt, kt, vt, ot, lse, delta, dk, dv, h, hk, sq, skv, mk, sm_scale, st);
  return cudaGetLastError();
}

}  // namespace

// The CUDA-core route. dtype: 0 = float32, 1 = bfloat16. (d, dv) = (d, d)
// with d in {32, 64, 112, 128, 256}, or (192, 128); window <= 0: no window;
// prefix <= 0: no prefix. q, k, v and do take element strides for their
// batch, head and sequence axes (the last axis is contiguous); lse and delta
// are contiguous (b, h, sq) f32. dq is contiguous (b, h, sq, d) in the input
// dtype; dk (b, hk, skv, d) and dv (b, hk, skv, dv) are contiguous f32,
// summed over each kv head's query-head group.
extern "C" int flash_bwd(const void* q, const void* k, const void* v, const void* dout,
                         const float* lse, const float* delta, void* dq, float* dk,
                         float* dv, int b, int h, int hk, int sq, int skv, int d, int d_v,
                         int dtype, int causal, int window, int prefix, float sm_scale,
                         long long qsb, long long qsh, long long qss, long long ksb,
                         long long ksh, long long kss, long long vsb, long long vsh,
                         long long vss, long long osb, long long osh, long long oss,
                         void* stream) {
  const Strides st{qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss};
  const at::Masks mk{causal, window, prefix};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_BWD(T, D, DV) \
  launch<T, D, DV>(q, k, v, dout, lse, delta, dq, dk, dv, b, h, hk, sq, skv, mk, sm_scale, st, s)
  cudaError_t e;
  if (dtype == 0 && d == 32 && d_v == 32) e = REPRO_BWD(float, 32, 32);
  else if (dtype == 0 && d == 64 && d_v == 64) e = REPRO_BWD(float, 64, 64);
  else if (dtype == 0 && d == 112 && d_v == 112) e = REPRO_BWD(float, 112, 112);
  else if (dtype == 0 && d == 128 && d_v == 128) e = REPRO_BWD(float, 128, 128);
  else if (dtype == 0 && d == 192 && d_v == 128) e = REPRO_BWD(float, 192, 128);
  else if (dtype == 0 && d == 256 && d_v == 256) e = REPRO_BWD(float, 256, 256);
  else if (dtype == 1 && d == 32 && d_v == 32) e = REPRO_BWD(__nv_bfloat16, 32, 32);
  else if (dtype == 1 && d == 64 && d_v == 64) e = REPRO_BWD(__nv_bfloat16, 64, 64);
  else if (dtype == 1 && d == 112 && d_v == 112) e = REPRO_BWD(__nv_bfloat16, 112, 112);
  else if (dtype == 1 && d == 128 && d_v == 128) e = REPRO_BWD(__nv_bfloat16, 128, 128);
  else if (dtype == 1 && d == 192 && d_v == 128) e = REPRO_BWD(__nv_bfloat16, 192, 128);
  else if (dtype == 1 && d == 256 && d_v == 256) e = REPRO_BWD(__nv_bfloat16, 256, 256);
  else e = cudaErrorInvalidValue;
#undef REPRO_BWD
  return static_cast<int>(e);
}

// The tensor-core route: bf16 q, k, v and do with 16-byte aligned bases and
// strides (elements) that are multiples of 8; otherwise as flash_bwd.
extern "C" int flash_bwd_tc(const void* q, const void* k, const void* v, const void* dout,
                            const float* lse, const float* delta, void* dq, float* dk,
                            float* dv, int b, int h, int hk, int sq, int skv, int d, int d_v,
                            int causal, int window, int prefix, float sm_scale,
                            long long qsb, long long qsh, long long qss, long long ksb,
                            long long ksh, long long kss, long long vsb, long long vsh,
                            long long vss, long long osb, long long osh, long long oss,
                            void* stream) {
  const Strides st{qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss};
  const at::Masks mk{causal, window, prefix};
  const at::ValueOffsets off{skv - sq, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_BWD_TC(D, DV)                                                                  \
  at::bwd::launch<D, DV>(q, k, v, dout, lse, delta, off, dq, dk, dv, b, h, hk, sq, skv, mk, \
                         sm_scale, st, s)
  cudaError_t e;
  if (d == 32 && d_v == 32) e = REPRO_BWD_TC(32, 32);
  else if (d == 64 && d_v == 64) e = REPRO_BWD_TC(64, 64);
  else if (d == 112 && d_v == 112) e = REPRO_BWD_TC(112, 112);
  else if (d == 128 && d_v == 128) e = REPRO_BWD_TC(128, 128);
  else if (d == 192 && d_v == 128) e = REPRO_BWD_TC(192, 128);
  else if (d == 256 && d_v == 256) e = REPRO_BWD_TC(256, 256);
  else e = cudaErrorInvalidValue;
#undef REPRO_BWD_TC
  return static_cast<int>(e);
}
