// Fused LM-head cross-entropy, forward and backward, for Hopper.
//
// Replaces: src/repro/kernels/lm_head/kernel.py:64 lm_head_builder with
// emit_logits=0 (the CE forward) and src/repro/kernels/lm_head/kernel.py:185
// lm_head_bwd_builder (the CE backward), reached through pl.pallas_call at
// src/repro/core/lang.py:1076.
//
// Forward: x (R, d) @ w (d, V) -> lse (R,) over the true vocab (columns
// >= vocab excluded) and gold (R,), each row's label logit; the (R, V)
// logits never reach device memory. Backward: dl = g * (exp(s - lse) -
// onehot) recomputed from the saved lse, formed in f32 as the TPU kernel
// forms it, dx = dl w^T (R, d) f32 and dw = x^T dl f32, written in w's own
// layout (for the tied head embed.T that is embed's (V, d) layout, so no
// transpose of the 1 GB f32 gradient).
//
// Bound on the H100: operations. At the training shapes (R = 4092, d = 2048,
// V = 128256) the forward is 2 R d V = 2.15 TFLOP against 0.5 GB of w, and
// the backward three such products, 3 * 2 R d V = 6.4 TFLOP: 6.5 ms at the
// bf16 tensor-core peak of 989 TFLOP/s.
//
// The forward has two routes, chosen by the wrapper up front:
// * lm_head_ce_fwd_tc, the tensor-core route (bf16 x and w with TMA-aligned
//   rows): one launch of the gemm_sm90.cuh mainloop over (M = R, N = V,
//   K = d) with the operand maps of the backward's pass (a), so the lse the
//   backward subtracts comes from the same products, summed in the same
//   order, as the s it subtracts it from. Its epilogue (CeStatsEpi) reduces
//   each row of the 128 x 256 tile in registers: the four lanes of a quad
//   hold one row's 64 columns, take the row max over the true vocab, then
//   sum exp(s - max) and pick the label's logit, and one lane writes the
//   tile's (max, sum, gold) into part[3][nt][R]; ce_merge_kernel folds the
//   nt = ceil(V / 256) partials. A tile wholly past vocab gives (-inf, 0, 0),
//   which the merge skips. The (R, V) logits never leave registers.
// * lm_head_ce_fwd, the CUDA-core route (f32 inputs, which keep exact f32
//   products, and bf16 inputs TMA cannot read): every product is one 64 x
//   64 output tile per block, staged through shared memory 16 deep, each
//   thread holding 4 x 4 accumulators; w is read with its strides, so
//   embed.T is read in place with loads along d. The TPU grid carries its
//   online-softmax state from one vocab block to the next in scratch;
//   Hopper blocks run in no order, so this route splits the vocab into at
//   most 16 chunks, one block per (chunk, 64-row tile) keeps the online
//   softmax over its chunk, and ce_merge_kernel merges the per-chunk
//   partials.
//
// The backward has two routes, chosen by the wrapper up front:
// * lm_head_ce_bwd_tc, the tensor-core route (bf16 x and w with TMA-aligned
//   rows), three launches of the gemm_sm90.cuh mainloop:
//   (a) s = x w (A = x K-major; B = w K-major for the tied head, N-major
//       for a (d, V) one), whose epilogue forms dl = g (p - onehot) in f32
//       from the row's lse, g and label (0 on columns >= vocab) and stores
//       it as two bf16 planes, hi = bf16(dl) and lo = bf16(dl - hi) (the
//       same 4 bytes an element as an f32 dl);
//   (b) dx = hi w^T + lo w^T (A = the planes K-major, B = w read as w^T),
//       in 128 x 128 tiles whose wgmma accumulator is folded into an f32
//       one every 4 k-tiles: the tensor cores add each k16 step with
//       truncation, and over V = 128256 terms one accumulator drifts by up
//       to an ulp a step (6.4e-4 of the largest dx at the training shapes
//       on an H100 before the fold, chip_smoke.py's full-width check);
//   (c) dw^T (V, d) = hi^T x + lo^T x (A = the planes M-major through the
//       transpose bit, B = x N-major), stored through dw's strides.
//   x and w are exact in bf16, so the two planes' products summed in f32
//   reproduce the f32-dl products to ~2^-16 relative; rounding dl once to
//   bf16 would put a 2^-9 error on the label column's g (p - 1), the
//   largest term of the largest dx and dw entries. Where the split pays:
//   (b) and (c) issue both planes against the same B tile, so the backward
//   issues 5 GEMM units of 2 R d V on the tensor cores against the bound's
//   3 (10.7 TFLOP: 10.9 ms at peak), and writes the planes once and reads
//   them twice (~6.3 GB, ~2 ms of memory time under the products).
//   What the design does about the bound: every product runs on wgmma with
//   TMA loads, and no f32 dl is formed in device memory.
// * lm_head_ce_bwd, the CUDA-core route (f32 inputs, which keep exact f32
//   products, and bf16 inputs TMA cannot read): one kernel writes dl (R, V)
//   f32 and two tiled SIMT products read it, dx sweeping the vocab per
//   output tile, dw the rows per output tile.
// No atomics on either route: every output element is summed in one fixed
// order.
#include "common.cuh"
#include "gemm_sm90.cuh"

namespace {

constexpr int BM = 64;   // output tile rows
constexpr int BN = 64;   // output tile columns
constexpr int BK = 16;   // depth per shared-memory step
constexpr int NT = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int MAX_SPLITS = 16;

struct Tiles {
  float a[BK][BM + 1];  // a[k][m]
  float b[BK][BN + 1];  // b[k][n]
};

__device__ __forceinline__ float half_max(float v) {  // over 16 lanes
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float half_sum(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// acc[i][j] = sum over k of A(m0 + ty + 16 i, k) * B(k, n0 + tx + 16 j), with
// A(m, k) at A[m * sam + k * sak] and B(k, n) at B[k * sbk + n * sbn]; out of
// range elements read as 0. Loads run along whichever axis is contiguous.
template <typename TA, typename TB>
__device__ __forceinline__ void gemm_tile(
    const TA* __restrict__ A, long long sam, long long sak,
    const TB* __restrict__ B, long long sbk, long long sbn, int M, int N, int K,
    int m0, int n0, float (&acc)[4][4], Tiles& sm) {
  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < K; k0 += BK) {
    __syncthreads();  // the previous step's readers are done
#pragma unroll
    for (int it = 0; it < BM * BK / NT; ++it) {
      const int e = t + it * NT;
      const int kk = (sak == 1) ? e % BK : e / BM;
      const int mm = (sak == 1) ? e / BK : e % BM;
      const int m = m0 + mm, k = k0 + kk;
      sm.a[kk][mm] = (m < M && k < K) ? repro::to_f32(A[m * sam + k * sak]) : 0.f;
    }
#pragma unroll
    for (int it = 0; it < BN * BK / NT; ++it) {
      const int e = t + it * NT;
      const int nn = (sbn == 1) ? e % BN : e / BK;
      const int kk = (sbn == 1) ? e / BN : e % BK;
      const int n = n0 + nn, k = k0 + kk;
      sm.b[kk][nn] = (n < N && k < K) ? repro::to_f32(B[k * sbk + n * sbn]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sm.a[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = sm.b[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
    }
  }
}

// One block per (vocab chunk, 64-row tile): online softmax over the chunk's
// 64-column tiles; writes the chunk's (max, sum of exp, gold) per row into
// part[3][nsplit][R].
template <typename T>
__global__ void __launch_bounds__(NT) ce_fwd_kernel(
    const T* __restrict__ x, const T* __restrict__ w, const int* __restrict__ labels,
    float* __restrict__ part, int R, int d, int V, int vocab, int chunk,
    long long xs_r, long long ws_k, long long ws_v) {
  __shared__ Tiles sm;
  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;
  const int split = blockIdx.x, nsplit = gridDim.x;
  const int m0 = blockIdx.y * BM;
  int lab[4];
  float m[4], l[4], gold[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty + 16 * i;
    lab[i] = r < R ? labels[r] : -1;
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
    gold[i] = 0.f;
  }
  const int v_end = min(V, (split + 1) * chunk);
  for (int n0 = split * chunk; n0 < v_end; n0 += BN) {
    float acc[4][4];
    gemm_tile<T, T>(x, xs_r, 1, w, ws_k, ws_v, R, V, d, m0, n0, acc, sm);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float tmax = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (n0 + tx + 16 * j < vocab) tmax = fmaxf(tmax, acc[i][j]);
      tmax = half_max(tmax);
      const float m_new = fmaxf(m[i], tmax);
      // an empty history (m == -inf) has l == 0: its correction is 0
      const float corr = (m[i] == -CUDART_INF_F) ? 0.f : expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = n0 + tx + 16 * j;
        if (c < vocab && m_new != -CUDART_INF_F) ps += expf(acc[i][j] - m_new);
        if (c < vocab && c == lab[i]) gold[i] += acc[i][j];
      }
      ps = half_sum(ps);
      l[i] = l[i] * corr + ps;
      m[i] = m_new;
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float gsum = half_sum(gold[i]);
    const int r = m0 + ty + 16 * i;
    if (tx == 0 && r < R) {
      part[((long long)0 * nsplit + split) * R + r] = m[i];
      part[((long long)1 * nsplit + split) * R + r] = l[i];
      part[((long long)2 * nsplit + split) * R + r] = gsum;
    }
  }
}

__global__ void ce_merge_kernel(const float* __restrict__ part, float* __restrict__ lse,
                                float* __restrict__ gold, int nsplit, int R) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  float M = -CUDART_INF_F;
  for (int s = 0; s < nsplit; ++s) M = fmaxf(M, part[(long long)s * R + r]);
  float L = 0.f, G = 0.f;
  for (int s = 0; s < nsplit; ++s) {
    const float ms = part[(long long)s * R + r];
    if (ms != -CUDART_INF_F) L += part[(long long)(nsplit + s) * R + r] * expf(ms - M);
    G += part[(long long)(2 * nsplit + s) * R + r];
  }
  lse[r] = M + logf(L == 0.f ? 1.f : L);
  gold[r] = G;
}

// dl (R, V) f32 = g * (exp(s - lse) - onehot) on the true vocab, 0 beyond it.
template <typename T>
__global__ void __launch_bounds__(NT) ce_dlogits_kernel(
    const T* __restrict__ x, const T* __restrict__ w, const int* __restrict__ labels,
    const float* __restrict__ lse, const float* __restrict__ g, float* __restrict__ dl,
    int R, int d, int V, int vocab, long long xs_r, long long ws_k, long long ws_v) {
  __shared__ Tiles sm;
  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[4][4];
  gemm_tile<T, T>(x, xs_r, 1, w, ws_k, ws_v, R, V, d, m0, n0, acc, sm);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty + 16 * i;
    if (r >= R) continue;
    const float lr = lse[r], gr = g[r];
    const int lab = labels[r];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx + 16 * j;
      if (c >= V) continue;
      float val = 0.f;
      if (c < vocab) {
        const float p = (lr == -CUDART_INF_F) ? 0.f : expf(acc[i][j] - lr);
        val = gr * (p - (c == lab ? 1.f : 0.f));
      }
      dl[(long long)r * V + c] = val;
    }
  }
}

// C (M, N) f32 at C[m * scm + n] = A (M, K) . B (K, N), strided operands.
template <typename TA, typename TB>
__global__ void __launch_bounds__(NT) gemm_kernel(
    const TA* __restrict__ A, long long sam, long long sak, const TB* __restrict__ B,
    long long sbk, long long sbn, float* __restrict__ C, long long scm, int M, int N,
    int K) {
  __shared__ Tiles sm;
  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[4][4];
  gemm_tile<TA, TB>(A, sam, sak, B, sbk, sbn, M, N, K, m0, n0, acc, sm);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (m < M && n < N) C[m * scm + n] = acc[i][j];
    }
  }
}

int ce_chunk(int V) {  // vocab columns per split, a multiple of BN
  const int tiles = (V + BN - 1) / BN;
  const int splits = tiles < MAX_SPLITS ? tiles : MAX_SPLITS;
  return BN * ((tiles + splits - 1) / splits);
}

int ce_splits(int V) {
  const int c = ce_chunk(V);
  return (V + c - 1) / c;
}

dim3 tiles(int M, int N) { return dim3((N + BN - 1) / BN, (M + BM - 1) / BM); }

template <typename T>
void launch_fwd(const void* x, const void* w, const int* labels, float* lse, float* gold,
                float* part, int R, int d, int V, int vocab, long long xs_r,
                long long ws_k, long long ws_v, cudaStream_t s) {
  const int nsplit = ce_splits(V);
  dim3 grid(nsplit, (R + BM - 1) / BM);
  ce_fwd_kernel<T><<<grid, NT, 0, s>>>(static_cast<const T*>(x), static_cast<const T*>(w),
                                       labels, part, R, d, V, vocab, ce_chunk(V), xs_r,
                                       ws_k, ws_v);
  ce_merge_kernel<<<(R + 255) / 256, 256, 0, s>>>(part, lse, gold, nsplit, R);
}

template <typename T>
void launch_bwd(const void* xv, const void* wv, const int* labels, const float* lse,
                const float* g, float* dl, float* dx, float* dw, int R, int d, int V,
                int vocab, long long xs_r, long long ws_k, long long ws_v,
                long long dws_k, long long dws_v, cudaStream_t s) {
  const T* x = static_cast<const T*>(xv);
  const T* w = static_cast<const T*>(wv);
  ce_dlogits_kernel<T><<<tiles(R, V), NT, 0, s>>>(x, w, labels, lse, g, dl, R, d, V,
                                                  vocab, xs_r, ws_k, ws_v);
  // dx (R, d) = dl (R, V) . w^T, where w^T(v, k) = w[k * ws_k + v * ws_v]
  gemm_kernel<float, T><<<tiles(R, d), NT, 0, s>>>(dl, V, 1, w, ws_v, ws_k, dx, d, R, d,
                                                   V);
  if (dws_v == 1)  // dw (d, V) = x^T . dl
    gemm_kernel<T, float><<<tiles(d, V), NT, 0, s>>>(x, 1, xs_r, dl, V, 1, dw, dws_k, d,
                                                     V, R);
  else  // dw in (V, d) memory: dw^T = dl^T . x
    gemm_kernel<float, T><<<tiles(V, d), NT, 0, s>>>(dl, 1, V, x, xs_r, 1, dw, dws_v, V,
                                                     d, R);
}

}  // namespace

// Number of vocab chunks the forward splits V into (the caller allocates
// 3 * splits * R floats of scratch for the partials).
extern "C" int lm_head_ce_splits(int V) { return ce_splits(V); }

// dtype: 0 = float32, 1 = bfloat16. x (R, d) has a contiguous last axis and
// row stride xs_r; w (d, V) takes both element strides. labels (R,) int32,
// lse and gold (R,) f32 contiguous.
extern "C" int lm_head_ce_fwd(const void* x, const void* w, const int* labels, float* lse,
                              float* gold, float* part, int R, int d, int V, int vocab,
                              int dtype, long long xs_r, long long ws_k, long long ws_v,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch_fwd<float>(x, w, labels, lse, gold, part, R, d, V, vocab, xs_r, ws_k, ws_v, s);
  else if (dtype == 1)
    launch_fwd<__nv_bfloat16>(x, w, labels, lse, gold, part, R, d, V, vocab, xs_r, ws_k,
                              ws_v, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// g (R,) f32 is the cotangent of the per-row NLL; dl is (R, V) f32 scratch;
// dx (R, d) f32 contiguous; dw (d, V) f32 at dw[k * dws_k + v * dws_v] with
// either dws_v == 1 ((d, V) memory) or dws_k == 1 ((V, d) memory).
extern "C" int lm_head_ce_bwd(const void* x, const void* w, const int* labels,
                              const float* lse, const float* g, float* dl, float* dx,
                              float* dw, int R, int d, int V, int vocab, int dtype,
                              long long xs_r, long long ws_k, long long ws_v,
                              long long dws_k, long long dws_v, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dws_v != 1 && dws_k != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    launch_bwd<float>(x, w, labels, lse, g, dl, dx, dw, R, d, V, vocab, xs_r, ws_k, ws_v,
                      dws_k, dws_v, s);
  else if (dtype == 1)
    launch_bwd<__nv_bfloat16>(x, w, labels, lse, g, dl, dx, dw, R, d, V, vocab, xs_r,
                              ws_k, ws_v, dws_k, dws_v, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

namespace {

constexpr int DX_TN = 128, DX_PROMOTE = 4;  // pass (b): tile width, k-tiles a chunk

// The epilogue of pass (a): dl = g (exp(s - lse) - onehot) in f32 on the
// true vocab (0 on columns >= vocab and for a row with lse = -inf's p),
// stored as hi = bf16(dl), lo = bf16(dl - hi) into (R, ld) planes.
struct DlEpi {
  const float* lse;
  const float* g;
  const int* labels;
  __nv_bfloat16* hi;
  __nv_bfloat16* lo;
  long long ld;
  int R, V, vocab;

  template <int NF>
  __device__ __forceinline__ void operator()(const float (&acc)[NF], int r0, int c0) const {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      if (r >= R) continue;
      const float lr = lse[r], gr = g[r];
      const int lab = labels[r];
      const bool dead = lr == -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < NF / 4; ++j) {
        const int col = c0 + 8 * j;
        if (col >= V) continue;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = col + e;
          v[e] = 0.f;
          if (c < vocab) {
            const float p = dead ? 0.f : expf(acc[4 * j + 2 * h + e] - lr);
            v[e] = gr * (p - (c == lab ? 1.f : 0.f));
          }
        }
        const __nv_bfloat162 vh = __floats2bfloat162_rn(v[0], v[1]);
        const __nv_bfloat162 vl = __floats2bfloat162_rn(v[0] - __low2float(vh),
                                                        v[1] - __high2float(vh));
        const long long off = r * ld + col;
        if (col + 1 < V) {
          *reinterpret_cast<__nv_bfloat162*>(hi + off) = vh;
          *reinterpret_cast<__nv_bfloat162*>(lo + off) = vl;
        } else {
          hi[off] = __low2bfloat16(vh);
          lo[off] = __low2bfloat16(vl);
        }
      }
    }
  }
};

// The epilogue of the forward's tensor-core route: for each of the thread's
// two rows, the tile's (max, sum of exp(s - max), label logit) over the
// columns < vocab, reduced across the quad of lanes that holds the row and
// written by its first lane into part[3][nt][R] at the tile's index. Every
// lane reaches the shuffles, rows >= R too. A tile with no column < vocab
// gives max = -inf and sums of 0 (no exp of an infinite argument).
struct CeStatsEpi {
  const int* labels;
  float* part;
  int R, vocab, nt;

  template <int NF>
  __device__ __forceinline__ void operator()(const float (&acc)[NF], int r0, int c0) const {
    const int tile = c0 / (2 * NF);  // the tile is 2 NF columns wide
    const bool writer = threadIdx.x % 4 == 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      const int lab = r < R ? labels[r] : -1;
      float m = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < NF / 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (c0 + 8 * j + e < vocab) m = fmaxf(m, acc[4 * j + 2 * h + e]);
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      float l = 0.f, gold = 0.f;
#pragma unroll
      for (int j = 0; j < NF / 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = c0 + 8 * j + e;
          const float sv = acc[4 * j + 2 * h + e];
          if (c < vocab) {
            l += expf(sv - m);
            if (c == lab) gold += sv;
          }
        }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        l += __shfl_xor_sync(0xffffffffu, l, o);
        gold += __shfl_xor_sync(0xffffffffu, gold, o);
      }
      if (writer && r < R) {
        part[((long long)0 * nt + tile) * R + r] = m;
        part[((long long)1 * nt + tile) * R + r] = l;
        part[((long long)2 * nt + tile) * R + r] = gold;
      }
    }
  }
};

}  // namespace

// The tensor-core route of the backward, bf16 x and w. x (R, d) rows
// contiguous, stride xs_r; w (d, V) at w[k * ws_k + v * ws_v] with ws_k == 1
// (the tied head embed.T, (V, d) memory) or ws_v == 1 ((d, V) memory); every
// row stride a multiple of 8 elements and every base 16-byte aligned. hi and
// lo are (R, ld) bf16 scratch, ld >= V a multiple of 8. dx (R, d) f32
// contiguous; dw (d, V) f32 at dw[k * dws_k + v * dws_v].
extern "C" int lm_head_ce_bwd_tc(const void* x, const void* w, const int* labels,
                                 const float* lse, const float* g, void* hi, void* lo,
                                 float* dx, float* dw, int R, int d, int V, int vocab,
                                 long long ld, long long xs_r, long long ws_k, long long ws_v,
                                 long long dws_k, long long dws_v, void* stream) {
  namespace sm = repro::sm90;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool tied = ws_v != 1;  // (V, d) memory: w^T rows are embed's rows
  if (tied && ws_k != 1) return static_cast<int>(cudaErrorInvalidValue);
  // x as pass (a)'s K-major A and as pass (c)'s N-major B
  CUtensorMap x_a, x_b, w_a, w_b, hi_k, lo_k, hi_m, lo_m;
  cudaError_t e = sm::operand_map(&x_a, x, d, R, xs_r, false, sm::BM);
  if (e == cudaSuccess) e = sm::operand_map(&x_b, x, d, R, xs_r, true, sm::BN);
  // w as pass (a)'s B (K = d, N = V) and pass (b)'s B (K = V, N = d)
  if (tied) {  // memory (V rows of d): (a) K-major, (b) N-major
    if (e == cudaSuccess) e = sm::operand_map(&w_a, w, d, V, ws_v, false, sm::BN);
    if (e == cudaSuccess) e = sm::operand_map(&w_b, w, d, V, ws_v, true, sm::BN);
  } else {  // memory (d rows of V): (a) N-major, (b) K-major
    if (e == cudaSuccess) e = sm::operand_map(&w_a, w, V, d, ws_k, true, sm::BN);
    if (e == cudaSuccess) e = sm::operand_map(&w_b, w, V, d, ws_k, false, DX_TN);
  }
  // the planes (R rows of V) as pass (b)'s K-major A and pass (c)'s M-major A
  if (e == cudaSuccess) e = sm::operand_map(&hi_k, hi, V, R, ld, false, sm::BM);
  if (e == cudaSuccess) e = sm::operand_map(&lo_k, lo, V, R, ld, false, sm::BM);
  if (e == cudaSuccess) e = sm::operand_map(&hi_m, hi, V, R, ld, true, sm::BM);
  if (e == cudaSuccess) e = sm::operand_map(&lo_m, lo, V, R, ld, true, sm::BM);
  if (e != cudaSuccess) return static_cast<int>(e);

  const DlEpi dl{lse, g, labels, static_cast<__nv_bfloat16*>(hi),
                 static_cast<__nv_bfloat16*>(lo), ld, R, V, vocab};
  const sm::StoreEpi<float> to_dx{dx, d, 1, R, d};
  const sm::StoreEpi<float> to_dw{dw, dws_v, dws_k, V, d};  // dw^T (V, d)
  // dx sums V = 128256 products a column: 128-wide tiles with the
  // accumulator promoted every DX_PROMOTE k-tiles (gemm_sm90.cuh)
  if (tied) {
    e = sm::gemm<false, false, 1>(x_a, x_a, w_a, R, V, d, dl, s);
    if (e == cudaSuccess)
      e = sm::gemm<false, true, 2, DX_TN, DX_PROMOTE>(hi_k, lo_k, w_b, R, d, V, to_dx, s);
  } else {
    e = sm::gemm<false, true, 1>(x_a, x_a, w_a, R, V, d, dl, s);
    if (e == cudaSuccess)
      e = sm::gemm<false, false, 2, DX_TN, DX_PROMOTE>(hi_k, lo_k, w_b, R, d, V, to_dx, s);
  }
  if (e == cudaSuccess) e = sm::gemm<true, true, 2>(hi_m, lo_m, x_b, V, d, R, to_dw, s);
  return static_cast<int>(e);
}

// Number of column tiles the forward's tensor-core route splits V into (the
// caller allocates 3 * tiles * R floats of scratch for the partials).
extern "C" int lm_head_ce_tc_tiles(int V) { return (V + repro::sm90::BN - 1) / repro::sm90::BN; }

// The tensor-core route of the forward, bf16 x and w, with the layouts of
// lm_head_ce_bwd_tc: x (R, d) rows contiguous, stride xs_r; w (d, V) at
// w[k * ws_k + v * ws_v] with ws_k == 1 (the tied head embed.T) or ws_v == 1;
// every row stride a multiple of 8 elements and every base 16-byte aligned.
// labels (R,) int32, lse and gold (R,) f32 contiguous, part 3 * tiles * R f32.
extern "C" int lm_head_ce_fwd_tc(const void* x, const void* w, const int* labels, float* lse,
                                 float* gold, float* part, int R, int d, int V, int vocab,
                                 long long xs_r, long long ws_k, long long ws_v,
                                 void* stream) {
  namespace sm = repro::sm90;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool tied = ws_v != 1;  // (V, d) memory: w^T rows are embed's rows
  if (tied && ws_k != 1) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap x_a, w_a;  // pass (a)'s maps: x K-major; w K-major if tied
  cudaError_t e = sm::operand_map(&x_a, x, d, R, xs_r, false, sm::BM);
  if (e == cudaSuccess)
    e = tied ? sm::operand_map(&w_a, w, d, V, ws_v, false, sm::BN)
             : sm::operand_map(&w_a, w, V, d, ws_k, true, sm::BN);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int nt = lm_head_ce_tc_tiles(V);
  const CeStatsEpi stats{labels, part, R, vocab, nt};
  e = tied ? sm::gemm<false, false, 1>(x_a, x_a, w_a, R, V, d, stats, s)
           : sm::gemm<false, true, 1>(x_a, x_a, w_a, R, V, d, stats, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  ce_merge_kernel<<<(R + 255) / 256, 256, 0, s>>>(part, lse, gold, nt, R);
  return static_cast<int>(cudaGetLastError());
}
