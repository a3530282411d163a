// Mamba selective scan for Hopper: a scan parallel over time.
//
// Replaces: src/repro/kernels/ssm_scan/kernel.py:26 ssm_scan_builder (the
// ssm_scan op, reached through pl.pallas_call at src/repro/core/lang.py:1076).
//
// x (bt, L, dm); delta (bt, L, dm) f32; A (dm, n) f32; B, C (bt, L, n); D (dm,) f32;
// h0 (bt, dm, n) f32 or null (zeros). For each (batch row, channel c) and
// t = 0..L-1, in f32:
//   h = exp(delta_t A[c]) * h + (delta_t B_t) x_t
//   y_t = sum_i C_t[i] h[i] + D[c] x_t
// Outputs y (bt, L, dm) in x's dtype and the final state hT (bt, dm, n) f32.
//
// Bound on the H100: the exponentials. The L * dm * n values exp(delta A)
// each take one MUFU.EX2, which issues 16 a clock per SM (4.18e12 a second
// at 1.98 GHz on 132 SMs): 0.064 ms at falcon-mamba's 2048 x 8192 x 16,
// above the 0.041 ms its bytes take. Each exponential is computed once.
// What the design does about it: time is parallel. A block owns CH = 32
// channels of one batch row and walks time in tiles of T = 128 steps; each
// channel's tile is split into P = 8 runs of R = 16 consecutive steps, one
// thread a run, the P threads of a channel in one quarter-warp. A tile of
// x, delta, B and C is staged into shared memory, transposed so that each
// run is contiguous (rows padded so a quarter-warp's float4 reads hit
// distinct banks); the global reads are coalesced along the contiguous
// channel (delta, x) or time (B, C) axis. Then, for one state index i at a
// time, each thread walks its run from zero with
// (a_t, b_t) = (2^(delta_t A[c, i] log2 e), delta_t x_t B_t[i]): the state
// reached, g_t, gives y_t += C_t[i] g_t at once, and the product of the a
// so far, P_t, is kept as w_t = C_t[i] P_t. The run is then one map
// h -> a h + b, the first run's applied to the state carried from the
// previous tile; a shuffle scan over the quarter-warp composes the runs,
// (a1, b1) then (a2, b2) = (a1 a2, a2 b1 + b2), which gives the state h_in
// entering each run, and y_t += w_t h_in finishes the run's y (its states
// are h_t = P_t h_in + g_t). Each exponential is taken once and no step is
// walked twice. The carried state of every i lives in shared memory
// between tiles (the last run writes it). y leaves through shared memory,
// transposed back, as coalesced stores. Steps past L are the identity
// (delta = 0, x = 0) and channels past dm compute zeros; neither is stored.
// At falcon-mamba's forward (bt = 1, dm = 8192) that is 256 blocks of 8
// warps, two a SM by registers: one wave.
#include "common.cuh"

namespace {

constexpr int P = 8;            // threads a channel (runs a tile)
constexpr int R = 16;           // steps a run
constexpr int T = P * R;        // steps a tile
constexpr int CH = 32;          // channels a block
constexpr int NT = CH * P;      // threads a block
constexpr int RS = R + 4;       // a run as stored: 4 floats of pad
constexpr int S = P * RS + 4;   // a channel's (or state's) tile as stored
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// step tt of a tile as stored within a channel's (or state's) row
__device__ __forceinline__ int slot(int tt) { return (tt / R) * RS + tt % R; }

template <int N>
constexpr int smem_bytes() {  // xs, ds (CH rows) | bs, cs (N rows) | al_s, h_s
  return (2 * CH + 2 * N) * S * 4 + 2 * CH * N * 4;
}

// K consecutive floats of shared memory (16-byte aligned) into registers
template <int K>
__device__ __forceinline__ void load_run(const float* p, float* out) {
#pragma unroll
  for (int k = 0; k < K / 4; ++k) {
    const float4 a = reinterpret_cast<const float4*>(p)[k];
    out[4 * k] = a.x;
    out[4 * k + 1] = a.y;
    out[4 * k + 2] = a.z;
    out[4 * k + 3] = a.w;
  }
}

template <typename T_, int N>
__global__ void __launch_bounds__(NT, 2) ssm_scan_kernel(
    const T_* __restrict__ x, const float* __restrict__ delta,
    const float* __restrict__ A, const T_* __restrict__ B,
    const T_* __restrict__ C, const float* __restrict__ Dskip,
    const float* __restrict__ h0, T_* __restrict__ y, float* __restrict__ hT,
    int L, int dm) {
  static_assert(R % 8 == 0, "runs of whole 8-step halves");
  extern __shared__ __align__(16) float sm[];
  float* xs = sm;             // [CH][S], later y
  float* ds = xs + CH * S;    // [CH][S]
  float* bs = ds + CH * S;    // [N][S]
  float* cs = bs + N * S;     // [N][S]
  float* al_s = cs + N * S;   // [CH][N]: A log2 e
  float* h_s = al_s + CH * N; // [CH][N]: the state carried between tiles
  const int tid = threadIdx.x;
  const int cl = tid / P, p = tid % P;
  const int c0 = blockIdx.x * CH;
  const int bi = blockIdx.y;

  for (int e = tid; e < CH * N; e += NT) {
    const int c = c0 + e / N;
    const long long at = static_cast<long long>(c) * N + e % N;
    al_s[e] = c < dm ? A[at] * LOG2E : 0.f;
    h_s[e] = (c < dm && h0) ? h0[static_cast<long long>(bi) * dm * N + at] : 0.f;
  }
  const float dsk = c0 + cl < dm ? Dskip[c0 + cl] : 0.f;
  const long long row = static_cast<long long>(bi) * L;
  const T_* xb = x + row * dm;
  const float* db = delta + row * dm;
  T_* yb = y + row * dm;
  const T_* Bb = B + row * N;
  const T_* Cb = C + row * N;
  const int own = cl * S + p * RS;  // this thread's run in xs / ds

  for (int t0 = 0; t0 < L; t0 += T) {
    __syncthreads();  // the previous tile's y has left xs
    for (int e = tid; e < T * CH; e += NT) {
      const int tt = e / CH, cc = e - tt * CH;
      const bool in = t0 + tt < L && c0 + cc < dm;
      const long long off = static_cast<long long>(t0 + tt) * dm + c0 + cc;
      xs[cc * S + slot(tt)] = in ? repro::to_f32(xb[off]) : 0.f;
      ds[cc * S + slot(tt)] = in ? db[off] : 0.f;
    }
    for (int e = tid; e < T * N; e += NT) {
      const int tt = e / N, i = e - tt * N;
      const bool in = t0 + tt < L;
      const long long off = static_cast<long long>(t0) * N + e;
      bs[i * S + slot(tt)] = in ? repro::to_f32(Bb[off]) : 0.f;
      cs[i * S + slot(tt)] = in ? repro::to_f32(Cb[off]) : 0.f;
    }
    __syncthreads();

    float dr[R], dx[R], yr[R];
    load_run<R>(ds + own, dr);
    load_run<R>(xs + own, dx);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      yr[r] = dsk * dx[r];
      dx[r] *= dr[r];
    }
    // one state at a time. A run's states are h_t = P_t h_in + g_t, where
    // P_t is the product of its a up to t and g_t the state reached from
    // zero: the walk adds C_t g_t to y_t at once and keeps w_t = C_t P_t,
    // and once the scan has given h_in, y_t += w_t h_in
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float* bi_s = bs + i * S + p * RS;
      const float* ci_s = cs + i * S + p * RS;
      const float al = al_s[cl * N + i];
      const float carry = h_s[cl * N + i];
      float w[R], ar = 1.f, br = 0.f;  // the run so far as h -> ar h + br
#pragma unroll
      for (int r0 = 0; r0 < R; r0 += 8) {
        float bv[8], cv[8];
        load_run<8>(bi_s + r0, bv);
        load_run<8>(ci_s + r0, cv);
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const float a = ex2(dr[r0 + r] * al);
          br = fmaf(a, br, dx[r0 + r] * bv[r]);
          ar *= a;
          yr[r0 + r] = fmaf(cv[r], br, yr[r0 + r]);
          w[r0 + r] = cv[r] * ar;
        }
      }
      if (p == 0) br = fmaf(ar, carry, br);  // the first run starts from the carry
      // inclusive scan over the channel's runs: br becomes the state after
      // run p
#pragma unroll
      for (int o = 1; o < P; o <<= 1) {
        const float ap = __shfl_up_sync(0xffffffffu, ar, o, P);
        const float bp = __shfl_up_sync(0xffffffffu, br, o, P);
        if (p >= o) {
          br = fmaf(ar, bp, br);
          ar *= ap;
        }
      }
      float h = __shfl_up_sync(0xffffffffu, br, 1, P);
      if (p == 0) h = carry;
      // every lane of the channel has read the carry (before the shuffles)
      if (p == P - 1) h_s[cl * N + i] = br;
#pragma unroll
      for (int r = 0; r < R; ++r) yr[r] = fmaf(w[r], h, yr[r]);
    }
    __syncthreads();  // every run has read its x from xs
#pragma unroll
    for (int k = 0; k < R / 4; ++k)
      reinterpret_cast<float4*>(xs + own)[k] =
          make_float4(yr[4 * k], yr[4 * k + 1], yr[4 * k + 2], yr[4 * k + 3]);
    __syncthreads();
    for (int e = tid; e < T * CH; e += NT) {
      const int tt = e / CH, cc = e - tt * CH;
      if (t0 + tt < L && c0 + cc < dm)
        yb[static_cast<long long>(t0 + tt) * dm + c0 + cc] =
            repro::from_f32<T_>(xs[cc * S + slot(tt)]);
    }
  }
  __syncthreads();
  for (int e = tid; e < CH * N; e += NT) {
    const int c = c0 + e / N;
    if (c < dm) hT[(static_cast<long long>(bi) * dm + c) * N + e % N] = h_s[e];
  }
}

template <typename T_, int N>
int launch(const void* x, const float* delta, const float* A, const void* B,
           const void* C, const float* D, const float* h0, void* y,
           float* hT, int bt, int L, int dm, cudaStream_t stream) {
  static const int attr = static_cast<int>(cudaFuncSetAttribute(
      ssm_scan_kernel<T_, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes<N>()));
  if (attr) return attr;
  dim3 grid((dm + CH - 1) / CH, bt);
  ssm_scan_kernel<T_, N><<<grid, NT, smem_bytes<N>(), stream>>>(
      static_cast<const T_*>(x), delta, A, static_cast<const T_*>(B),
      static_cast<const T_*>(C), D, h0, static_cast<T_*>(y), hT, L, dm);
  return 0;
}

template <typename T_>
int dispatch_n(const void* x, const float* delta, const float* A,
               const void* B, const void* C, const float* D, const float* h0,
               void* y, float* hT, int bt, int L, int dm, int n,
               cudaStream_t s) {
  int err;
  if (n == 4) err = launch<T_, 4>(x, delta, A, B, C, D, h0, y, hT, bt, L, dm, s);
  else if (n == 8) err = launch<T_, 8>(x, delta, A, B, C, D, h0, y, hT, bt, L, dm, s);
  else if (n == 16) err = launch<T_, 16>(x, delta, A, B, C, D, h0, y, hT, bt, L, dm, s);
  else return static_cast<int>(cudaErrorInvalidValue);
  return err ? err : static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype (of x, B, C and y): 0 = float32, 1 = bfloat16; delta is float32;
// n in {4, 8, 16}. Every array is contiguous; h0 may be null (zeros).
extern "C" int ssm_scan(const void* x, const float* delta, const float* A,
                        const void* B, const void* C, const float* D,
                        const float* h0, void* y, float* hT, int bt, int L,
                        int dm, int n, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bt <= 0 || L <= 0 || dm <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return dispatch_n<float>(x, delta, A, B, C, D, h0, y, hT, bt, L, dm, n, s);
  if (dtype == 1)
    return dispatch_n<__nv_bfloat16>(x, delta, A, B, C, D, h0, y, hT, bt, L, dm, n, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
