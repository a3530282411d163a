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
// llama3.2-1b) dominates. Two routes, picked by the wrapper from dtype and
// layout before any launch:
//
// lm_head_tc (bf16 x and w that TMA can read, either layout): the product
// transposed, logits^T (V, R) = w^T (V, d) . x^T (d, R), on the
// gemm_sm90.cuh mainloop. The vocab is the M side: 128 vocab rows of w^T a
// block, the A operand, read K-major for the tied head (embed.T is embed
// (V, d), read in place) or MN-major through the transpose bit for a
// (d, V) head. The rows are the N side: x as a K-major B tile of R rounded
// up to 8, 16 or 64 (256-wide tiles beyond 64 rows). At decode a stage is
// 16 KB of w and at most 8 KB of x, so the ring holds 8 stages, ~136 KB in
// flight an SM at R = 8, enough to stream w at HBM rate; w is read from
// HBM once per call. The epilogue (LogitsEpi) stores the f32 logits
// transposed into (R, V) and reduces each warp's 16 vocab rows to a
// (max, first argmax) partial per decode row.
//
// lm_head (f32, and bf16 inputs TMA cannot read): the first design, f32
// math on the CUDA cores. Each block owns a tile of 64 vocab columns and
// holds ALL R rows, so w streams from HBM once per call; w is taken with
// strides, so the tied head is read in place with coalesced loads and never
// copied. Each block writes its logits tile and a per-row partial (max,
// argmax).
//
// Both routes end with lm_head_reduce, which folds the partials of each
// row, the larger max winning and, on equal max, the smaller column index
// (the TPU kernel's first-occurrence rule).
#include "common.cuh"
#include "gemm_sm90.cuh"

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

// ---------------------------------------------------------------------------
// the tensor-core route
// ---------------------------------------------------------------------------

constexpr int PART_ROWS = 16;  // vocab rows of one partial: one warp's share

// The epilogue of logits^T = w^T x^T: the thread's fragment holds vocab rows
// r0, r0 + 8 and decode rows c0 + 8 j + {0, 1} (gemm_sm90.cuh). Stores the
// logits into (R, V) with -1e30 past vocab, and writes, per decode row, the
// (max, first argmax) of the warp's 16 vocab rows (columns >= vocab count
// as -inf) to partial r0 / 16.
struct LogitsEpi {
  float* logits;
  float* part_m;
  int* part_arg;
  int R, V, vocab;

  template <int NF>
  __device__ __forceinline__ void operator()(const float (&acc)[NF], int r0, int c0) const {
    const int lane = threadIdx.x % 32;
    const int p = r0 / PART_ROWS;
#pragma unroll
    for (int i = 0; i < NF; ++i) {
      const int r = r0 + 8 * ((i >> 1) & 1), c = c0 + 8 * (i >> 2) + (i & 1);
      if (r < V && c < R) logits[(long long)c * V + r] = acc[i] + (r < vocab ? 0.f : -1e30f);
    }
#pragma unroll
    for (int j = 0; j < NF / 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float best = r0 < vocab ? acc[4 * j + e] : -CUDART_INF_F;
        int bi = r0;
        const float v8 = r0 + 8 < vocab ? acc[4 * j + 2 + e] : -CUDART_INF_F;
        if (better(v8, r0 + 8, best, bi)) {
          best = v8;
          bi = r0 + 8;
        }
        for (int off = 4; off < 32; off <<= 1) {  // the lanes of other rows
          const float ob = __shfl_xor_sync(0xffffffffu, best, off);
          const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
          if (better(ob, oi, best, bi)) {
            best = ob;
            bi = oi;
          }
        }
        const int c = c0 + 8 * j + e;
        if (lane < 4 && c < R && p * PART_ROWS < V) {
          part_m[(long long)p * R + c] = best;
          part_arg[(long long)p * R + c] = bi;
        }
      }
  }
};

template <bool W_MN, int TN>
cudaError_t launch_tc(const CUtensorMap& w_a, const void* x, int R, int d, int V,
                      long long xs_r, const LogitsEpi& epi, cudaStream_t s) {
  namespace sm = repro::sm90;
  CUtensorMap x_b;
  cudaError_t e = sm::operand_map(&x_b, x, d, R, xs_r, false, TN);
  if (e != cudaSuccess) return e;
  return sm::gemm<W_MN, false, 1, TN>(w_a, w_a, x_b, V, R, d, epi, s);
}

// The narrowest tile of the decode rows that holds all R of them (256-wide
// tiles beyond 64 rows).
template <bool W_MN>
cudaError_t launch_rows(const CUtensorMap& w_a, const void* x, int R, int d, int V,
                       long long xs_r, const LogitsEpi& epi, cudaStream_t s) {
  if (R <= 8) return launch_tc<W_MN, 8>(w_a, x, R, d, V, xs_r, epi, s);
  if (R <= 16) return launch_tc<W_MN, 16>(w_a, x, R, d, V, xs_r, epi, s);
  if (R <= 64) return launch_tc<W_MN, 64>(w_a, x, R, d, V, xs_r, epi, s);
  return launch_tc<W_MN, 256>(w_a, x, R, d, V, xs_r, epi, s);
}

}  // namespace

extern "C" int lm_head_partials(int V) { return (V + BV - 1) / BV; }

// Partials per row of the tensor-core route (one per 16 vocab rows).
extern "C" int lm_head_tc_partials(int V) { return (V + PART_ROWS - 1) / PART_ROWS; }

// The tensor-core route, bf16 x and w: x (R, d) rows contiguous, stride
// xs_r; w (d, V) at w[k * ws_k + v * ws_v] with ws_k == 1 (the tied head
// embed.T, (V, d) memory) or ws_v == 1 ((d, V) memory); every row stride a
// multiple of 8 elements and every base 16-byte aligned. logits (R, V),
// m (R,), arg (R,) contiguous; part_m/part_arg hold lm_head_tc_partials(V)
// * R entries of scratch, allocated by the caller.
extern "C" int lm_head_tc(const void* x, const void* w, float* logits, float* m, int* arg,
                          float* part_m, int* part_arg, int R, int d, int V, int vocab,
                          long long xs_r, long long ws_k, long long ws_v, void* stream) {
  namespace sm = repro::sm90;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool tied = ws_v != 1;  // (V, d) memory: w^T rows are embed's rows
  if (tied && ws_k != 1) return static_cast<int>(cudaErrorInvalidValue);
  // w^T as the A operand (M = V, K = d): K-major if tied, else MN-major
  CUtensorMap w_a;
  cudaError_t e = tied ? sm::operand_map(&w_a, w, d, V, ws_v, false, sm::BM)
                       : sm::operand_map(&w_a, w, V, d, ws_k, true, sm::BM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const LogitsEpi epi{logits, part_m, part_arg, R, V, vocab};
  e = tied ? launch_rows<false>(w_a, x, R, d, V, xs_r, epi, s)
           : launch_rows<true>(w_a, x, R, d, V, xs_r, epi, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  lm_head_reduce<<<R, NTR, 0, s>>>(part_m, part_arg, m, arg, lm_head_tc_partials(V), R);
  return static_cast<int>(cudaGetLastError());
}

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
