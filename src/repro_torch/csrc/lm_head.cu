// Fused LM head for decode (logits + row max + greedy argmax) on Hopper.
//
// Replaces: src/repro/kernels/lm_head/kernel.py:64 lm_head_builder with
// emit_logits=1 (the lm_head_logits op, reached through pl.pallas_call at
// src/repro/core/lang.py:1076).
//
// x (R, d) @ w (d, V) -> logits (R, V) f32 with -1e30 on the padded columns
// >= vocab, the per-row max m (R, 1) f32 and the first-occurrence argmax
// arg (R, 1) i32 over the true vocab.
//
// Bound on the H100: bytes. At decode R is the slot count (1..16), so the
// product does 2 * R FLOPs per weight element: reading w (525 MB in bf16 for
// llama3.2-1b) dominates. What the design does about it: each block owns a
// tile of 64 vocab columns and holds ALL R rows, so w streams from HBM once
// per call; w is taken with strides, so the tied head (embed.T, k
// contiguous) is read in place with coalesced loads and never copied. Each
// block writes its logits tile and a per-row partial (max, argmax); a second
// small kernel reduces the partials, the larger max winning and, on equal
// max, the smaller column index (the TPU kernel's first-occurrence rule).
#include "common.cuh"

#include <climits>

namespace {

constexpr int BV = 64;   // vocab columns per block
constexpr int BKK = 64;  // depth per shared-memory tile
constexpr int RB = 16;   // rows per pass (R > RB loops, re-reading w from L2)
constexpr int NT = 256;  // BV columns x 4 row groups
constexpr int NTR = 256;

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

template <typename T>
__global__ void __launch_bounds__(NT) lm_head_kernel(
    const T* __restrict__ x, const T* __restrict__ w, float* __restrict__ logits,
    float* __restrict__ part_m, int* __restrict__ part_arg, int R, int d, int V,
    int vocab, long long xs_r, long long ws_k, long long ws_v) {
  __shared__ float wsm[BKK][BV + 1];
  __shared__ float xsm[RB][BKK];
  __shared__ float red[RB][BV];
  const int t = threadIdx.x, v = t % BV, rg = t / BV;
  const int lane = t & 31, warp = t >> 5;
  const int v0 = blockIdx.x * BV, col = v0 + v;
  const bool k_major = (ws_k == 1);  // tied head: column v is embed row v

  for (int r0 = 0; r0 < R; r0 += RB) {
    float acc[RB / 4];
#pragma unroll
    for (int i = 0; i < RB / 4; ++i) acc[i] = 0.f;
    for (int k0 = 0; k0 < d; k0 += BKK) {
      __syncthreads();
      for (int e = t; e < BKK * BV; e += NT) {
        int kk, vv;
        if (k_major) {
          kk = e % BKK;
          vv = e / BKK;
        } else {
          vv = e % BV;
          kk = e / BV;
        }
        float val = 0.f;
        if (k0 + kk < d && v0 + vv < V)
          val = repro::to_f32(w[(long long)(k0 + kk) * ws_k + (long long)(v0 + vv) * ws_v]);
        wsm[kk][vv] = val;
      }
      for (int e = t; e < RB * BKK; e += NT) {
        const int rr = e / BKK, kk = e % BKK;
        xsm[rr][kk] = (r0 + rr < R && k0 + kk < d)
                          ? repro::to_f32(x[(long long)(r0 + rr) * xs_r + k0 + kk])
                          : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < BKK; ++kk) {
        const float wv = wsm[kk][v];
#pragma unroll
        for (int i = 0; i < RB / 4; ++i) acc[i] += xsm[rg + 4 * i][kk] * wv;
      }
    }
    const bool valid = col < vocab;
#pragma unroll
    for (int i = 0; i < RB / 4; ++i) {
      const int r = r0 + rg + 4 * i;
      if (r < R && col < V) logits[(long long)r * V + col] = acc[i] + (valid ? 0.f : -1e30f);
      red[rg + 4 * i][v] = valid ? acc[i] : -CUDART_INF_F;
    }
    __syncthreads();
    for (int rr = warp; rr < RB; rr += NT / 32) {  // one warp per row
      float best = red[rr][lane];
      int bi = lane;
      if (red[rr][lane + 32] > best) {
        best = red[rr][lane + 32];
        bi = lane + 32;
      }
      for (int off = 16; off > 0; off >>= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, best, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
        if (better(ob, oi, best, bi)) {
          best = ob;
          bi = oi;
        }
      }
      const int r = r0 + rr;
      if (lane == 0 && r < R) {
        part_m[(long long)blockIdx.x * R + r] = best;
        part_arg[(long long)blockIdx.x * R + r] = v0 + bi;
      }
    }
  }
}

__global__ void __launch_bounds__(NTR) lm_head_reduce(
    const float* __restrict__ part_m, const int* __restrict__ part_arg,
    float* __restrict__ m, int* __restrict__ arg, int nblk, int R) {
  __shared__ float sm[NTR / 32];
  __shared__ int si[NTR / 32];
  const int r = blockIdx.x, t = threadIdx.x, lane = t & 31, warp = t >> 5;
  float best = -CUDART_INF_F;
  int bi = INT_MAX;
  for (int b = t; b < nblk; b += NTR) {
    const float v = part_m[(long long)b * R + r];
    const int i = part_arg[(long long)b * R + r];
    if (better(v, i, best, bi)) {
      best = v;
      bi = i;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, best, off);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
    if (better(ob, oi, best, bi)) {
      best = ob;
      bi = oi;
    }
  }
  if (lane == 0) {
    sm[warp] = best;
    si[warp] = bi;
  }
  __syncthreads();
  if (t == 0) {
    for (int k = 1; k < NTR / 32; ++k)
      if (better(sm[k], si[k], best, bi)) {
        best = sm[k];
        bi = si[k];
      }
    m[r] = best;
    arg[r] = bi;
  }
}

template <typename T>
void launch(const void* x, const void* w, float* logits, float* m, int* arg,
            float* part_m, int* part_arg, int R, int d, int V, int vocab,
            long long xs_r, long long ws_k, long long ws_v, cudaStream_t s) {
  const int nblk = (V + BV - 1) / BV;
  lm_head_kernel<T><<<nblk, NT, 0, s>>>(static_cast<const T*>(x),
                                        static_cast<const T*>(w), logits, part_m,
                                        part_arg, R, d, V, vocab, xs_r, ws_k, ws_v);
  lm_head_reduce<<<R, NTR, 0, s>>>(part_m, part_arg, m, arg, nblk, R);
}

}  // namespace

extern "C" int lm_head_partials(int V) { return (V + BV - 1) / BV; }

// dtype: 0 = float32, 1 = bfloat16. x (R, d) has a contiguous last axis and
// row stride xs_r; w (d, V) takes both element strides. logits (R, V), m (R,),
// arg (R,) are contiguous; part_m/part_arg hold lm_head_partials(V) * R
// entries of scratch, allocated by the caller.
extern "C" int lm_head(const void* x, const void* w, float* logits, float* m,
                       int* arg, float* part_m, int* part_arg, int R, int d,
                       int V, int vocab, int dtype, long long xs_r,
                       long long ws_k, long long ws_v, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch<float>(x, w, logits, m, arg, part_m, part_arg, R, d, V, vocab, xs_r, ws_k, ws_v, s);
  else if (dtype == 1)
    launch<__nv_bfloat16>(x, w, logits, m, arg, part_m, part_arg, R, d, V, vocab, xs_r, ws_k, ws_v, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
