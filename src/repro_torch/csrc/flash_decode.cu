// Single-token decode attention against a contiguous KV cache, for Hopper.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py:356
// flash_decode_builder (the flash_decode op, reached through pl.pallas_call
// at src/repro/core/lang.py:1076).
//
// q (b, h, 1, d) attends to its sequence's cache k (b, hk, skv, d),
// v (b, hk, skv, d). The query sits at position q_pos = kv_len - 1.
// slot_pos (skv,) i32 holds each slot's absolute position (-1 = empty), so
// a rolling-window cache that stores ROTATED slots (slot = pos % W) masks
// correctly; a null slot_pos means slot i holds position i. A slot is live
// iff 0 <= pos <= q_pos and q_pos - pos < window. A row with no live slot
// gives 0. GQA: query head hh reads kv head hh / (h / hk).
//
// Bound on the H100: bytes. A step reads every live K/V entry once and does
// 4 * g * d FLOPs per (entry, kv head), far below the ~20 FLOP/byte the
// card needs to leave the memory roofline.
// What the design does about it: one block per (kv head, sequence) serves
// all g = h / hk query heads of the group, so each K/V row is read from
// device memory once (the TPU grid (b, h, nk) re-reads it per query head).
// The kv walk is split across the block's 8 warps, 32 slots per warp step
// (one slot per lane for the scores, one column per lane for p @ v, so V
// loads coalesce); each warp keeps its own online softmax and the warps'
// (m, l, acc) merge through shared memory at the end. While the cache is
// unwrapped (q_pos < skv) slot order is position order and the walk covers
// only [q_pos - window + 1, q_pos], the TPU kernel's whole-block skip; once
// wrapped every slot may be live and all are visited. A 32-slot chunk with
// no live slot is skipped before its K/V are loaded.
#include "common.cuh"

namespace {

constexpr int NT = 256;
constexpr int NW = NT / 32;   // warps, each walking its own 32-slot chunks
constexpr int MAXG = 16;      // query heads per kv head
constexpr int MAXGD = 1024;   // g * d per block (shared memory of the merge)

template <int D>
struct Cfg {
  static constexpr int G = (MAXGD / D < MAXG) ? MAXGD / D : MAXG;
  static constexpr int C = D / 32;   // output columns per lane
};

// 8 consecutive elements (16 or 32 bytes, 16-byte aligned) as f32
__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h2[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ slot_pos, T* __restrict__ o, int h, int hk,
    int skv, int kv_len, int window, float sm_scale, long long qsb,
    long long qsh, long long ksb, long long ksh, long long vsb,
    long long vsh) {
  constexpr int G = Cfg<D>::G, C = Cfg<D>::C;
  __shared__ float qs[G][D];
  __shared__ float acc_s[NW][G][D];
  __shared__ float m_s[NW][G], l_s[NW][G];
  const int g = h / hk;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int kh = blockIdx.x, bi = blockIdx.y;
  const int q_pos = kv_len - 1;

  for (int e = t; e < g * D; e += NT) {
    const int gi = e / D, dd = e % D;
    qs[gi][dd] = repro::to_f32(q[bi * qsb + (long long)(kh * g + gi) * qsh + dd]);
  }
  __syncthreads();

  // unwrapped cache: slot == position, so only [q_pos - window + 1, q_pos]
  // can be live; wrapped: every slot may hold a recent token
  int lo = 0, hi = skv;
  if (q_pos < skv) {
    hi = q_pos + 1;
    if (window > 0) lo = max(0, q_pos - window + 1);
  }

  float m[G], l[G], acc[G][C];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    m[gi] = -CUDART_INF_F;
    l[gi] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[gi][c] = 0.f;
  }
  const T* kb = k + bi * ksb + kh * ksh;
  const T* vb = v + bi * vsb + kh * vsh;

  for (int c0 = lo + warp * 32; c0 < hi; c0 += NW * 32) {
    const int j = c0 + lane;
    bool live = false;
    if (j < hi) {
      const int sp = slot_pos ? slot_pos[j] : j;
      live = sp >= 0 && sp <= q_pos && (window <= 0 || q_pos - sp < window);
    }
    // a chunk with no live slot is an exact no-op of the online softmax
    if (!__any_sync(0xffffffffu, live)) continue;

    float s[G];
#pragma unroll
    for (int gi = 0; gi < G; ++gi) s[gi] = 0.f;
    if (live) {
      const T* kr = kb + (long long)j * D;
#pragma unroll
      for (int d0 = 0; d0 < D; d0 += 8) {
        float k8[8];
        load8(kr + d0, k8);
#pragma unroll
        for (int gi = 0; gi < G; ++gi) {
          if (gi < g) {
#pragma unroll
            for (int e = 0; e < 8; ++e) s[gi] += qs[gi][d0 + e] * k8[e];
          }
        }
      }
    }
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      if (gi < g) {
        const float sc = live ? s[gi] * sm_scale : -CUDART_INF_F;
        const float m_new = fmaxf(m[gi], repro::warp_max(sc));  // finite
        const float corr = (m[gi] == -CUDART_INF_F) ? 0.f : expf(m[gi] - m_new);
        const float p = live ? expf(sc - m_new) : 0.f;
        l[gi] = l[gi] * corr + repro::warp_sum(p);
        m[gi] = m_new;
#pragma unroll
        for (int c = 0; c < C; ++c) acc[gi][c] *= corr;
        s[gi] = p;
      }
    }
    // acc (column lane + 32c) += p_j v[j]; p_j sits in lane jj
    const unsigned live_mask = __ballot_sync(0xffffffffu, live);
    for (int jj = 0; jj < 32; ++jj) {
      if (!((live_mask >> jj) & 1u)) continue;
      const T* vr = vb + (long long)(c0 + jj) * D;
      float vv[C];
#pragma unroll
      for (int c = 0; c < C; ++c) vv[c] = repro::to_f32(vr[lane + 32 * c]);
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        if (gi < g) {
          const float p = __shfl_sync(0xffffffffu, s[gi], jj);
#pragma unroll
          for (int c = 0; c < C; ++c) acc[gi][c] += p * vv[c];
        }
      }
    }
  }

  // merge the warps' online softmaxes
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    if (gi < g) {
      if (lane == 0) {
        m_s[warp][gi] = m[gi];
        l_s[warp][gi] = l[gi];
      }
#pragma unroll
      for (int c = 0; c < C; ++c) acc_s[warp][gi][lane + 32 * c] = acc[gi][c];
    }
  }
  __syncthreads();
  for (int e = t; e < g * D; e += NT) {
    const int gi = e / D, dd = e % D;
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, m_s[w][gi]);
    float lsum = 0.f, out = 0.f;
    if (mx != -CUDART_INF_F) {
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const float mw = m_s[w][gi];
        if (mw == -CUDART_INF_F) continue;
        const float f = expf(mw - mx);
        lsum += l_s[w][gi] * f;
        out += acc_s[w][gi][dd] * f;
      }
    }
    o[((long long)bi * h + kh * g + gi) * D + dd] =
        repro::from_f32<T>(lsum == 0.f ? 0.f : out / lsum);
  }
}

template <typename T, int D>
void launch(const void* q, const void* k, const void* v, const int* slot_pos,
            void* o, int b, int h, int hk, int skv, int kv_len, int window,
            float sm_scale, const long long* st, cudaStream_t stream) {
  dim3 grid(hk, b);
  flash_decode_kernel<T, D><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), slot_pos, static_cast<T*>(o), h, hk, skv,
      kv_len, window, sm_scale, st[0], st[1], st[2], st[3], st[4], st[5]);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; d in {32, 64, 128}; h / hk <= 16 and
// (h / hk) * d <= 1024. o is contiguous (b, h, 1, d); q takes element
// strides for its batch and head axes; k and v take them for their batch
// and head axes, their (skv, d) rows contiguous and 16-byte aligned.
// slot_pos is (skv,) i32 or null (slot i holds position i); window <= 0
// means no window.
extern "C" int flash_decode(const void* q, const void* k, const void* v,
                            const int* slot_pos, void* o, int b, int h,
                            int hk, int skv, int d, int dtype, int kv_len,
                            int window, float sm_scale, long long qsb,
                            long long qsh, long long ksb, long long ksh,
                            long long vsb, long long vsh, void* stream) {
  const long long st[6] = {qsb, qsh, ksb, ksh, vsb, vsh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hk <= 0 || h % hk != 0 || h / hk > MAXG || (h / hk) * d > MAXGD)
    return static_cast<int>(cudaErrorInvalidValue);
#define REPRO_DECODE(T, D) \
  launch<T, D>(q, k, v, slot_pos, o, b, h, hk, skv, kv_len, window, sm_scale, st, s)
  if (dtype == 0 && d == 32) REPRO_DECODE(float, 32);
  else if (dtype == 0 && d == 64) REPRO_DECODE(float, 64);
  else if (dtype == 0 && d == 128) REPRO_DECODE(float, 128);
  else if (dtype == 1 && d == 32) REPRO_DECODE(__nv_bfloat16, 32);
  else if (dtype == 1 && d == 64) REPRO_DECODE(__nv_bfloat16, 64);
  else if (dtype == 1 && d == 128) REPRO_DECODE(__nv_bfloat16, 128);
  else return static_cast<int>(cudaErrorInvalidValue);
#undef REPRO_DECODE
  return static_cast<int>(cudaGetLastError());
}
