// Mamba selective scan for Hopper.
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
// Bound on the H100: bytes. Each input is read once and y written once
// (x, y and delta dominate: 2, 2 and 4 bytes per (t, c) in bf16); the n exponentials
// and 3n FMAs per (t, c) are far below the f32 rate at these sizes.
// What the design does about it: one thread per (batch row, channel) keeps
// its n-long state and A row in registers and walks time in order, so
// nothing (bt, L, dm, n)-shaped touches device memory (the point of the TPU
// kernel too). Channels are contiguous, so a warp's loads of x and delta
// and its stores of y coalesce. B_t and C_t are shared by the block's
// channels: they are staged in shared memory one chunk of TC time steps at
// a time. L and dm may be ragged (the last block masks its channels). The
// TPU grid's sequential chunk axis becomes the loop over chunks; the
// parallelism is bt * dm threads (8192 at bt = 1 on falcon-mamba), which
// blocks of 64 channels spread over 128 SMs.
#include "common.cuh"

namespace {

constexpr int NT = 64;   // channels per block
constexpr int TC = 64;   // time steps of B and C staged per chunk

template <typename T, int N>
__global__ void __launch_bounds__(NT) ssm_scan_kernel(
    const T* __restrict__ x, const float* __restrict__ delta,
    const float* __restrict__ A, const T* __restrict__ B,
    const T* __restrict__ C, const float* __restrict__ Dskip,
    const float* __restrict__ h0, T* __restrict__ y, float* __restrict__ hT,
    int L, int dm) {
  __shared__ float bs[TC][N], cs[TC][N];
  const int c = blockIdx.x * NT + threadIdx.x;
  const int bi = blockIdx.y;
  const bool ok = c < dm;
  const long long st = (long long)bi * dm + c;   // (bi, c) in (bt, dm)

  float a[N], h[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    a[i] = ok ? A[(long long)c * N + i] : 0.f;
    h[i] = (ok && h0) ? h0[st * N + i] : 0.f;
  }
  const float dsk = ok ? Dskip[c] : 0.f;
  const long long row = (long long)bi * L;
  const T* xb = x + row * dm;
  const float* db = delta + row * dm;
  T* yb = y + row * dm;
  const T* Bb = B + row * N;
  const T* Cb = C + row * N;

  for (int t0 = 0; t0 < L; t0 += TC) {
    const int n = min(TC, L - t0);
    __syncthreads();  // the previous chunk's readers are done
    for (int e = threadIdx.x; e < n * N; e += NT) {
      bs[e / N][e % N] = repro::to_f32(Bb[(long long)t0 * N + e]);
      cs[e / N][e % N] = repro::to_f32(Cb[(long long)t0 * N + e]);
    }
    __syncthreads();
    if (!ok) continue;
    for (int tt = 0; tt < n; ++tt) {
      const long long off = (long long)(t0 + tt) * dm + c;
      const float xv = repro::to_f32(xb[off]);
      const float dv = db[off];
      float yv = 0.f;
#pragma unroll
      for (int i = 0; i < N; ++i) {
        h[i] = expf(dv * a[i]) * h[i] + (dv * bs[tt][i]) * xv;
        yv += h[i] * cs[tt][i];
      }
      yb[off] = repro::from_f32<T>(yv + dsk * xv);
    }
  }
  if (ok) {
#pragma unroll
    for (int i = 0; i < N; ++i) hT[st * N + i] = h[i];
  }
}

template <typename T, int N>
void launch(const void* x, const float* delta, const float* A, const void* B,
            const void* C, const float* D, const float* h0, void* y,
            float* hT, int bt, int L, int dm, cudaStream_t stream) {
  dim3 grid((dm + NT - 1) / NT, bt);
  ssm_scan_kernel<T, N><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(x), delta, A,
      static_cast<const T*>(B), static_cast<const T*>(C), D, h0,
      static_cast<T*>(y), hT, L, dm);
}

template <typename T>
int dispatch_n(const void* x, const float* delta, const float* A,
               const void* B, const void* C, const float* D, const float* h0,
               void* y, float* hT, int bt, int L, int dm, int n,
               cudaStream_t s) {
  if (n == 4) launch<T, 4>(x, delta, A, B, C, D, h0, y, hT, bt, L, dm, s);
  else if (n == 8) launch<T, 8>(x, delta, A, B, C, D, h0, y, hT, bt, L, dm, s);
  else if (n == 16) launch<T, 16>(x, delta, A, B, C, D, h0, y, hT, bt, L, dm, s);
  else return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype (of x, B, C and y): 0 = float32, 1 = bfloat16; delta is float32;
// n in {4, 8, 16}. Every array is contiguous; h0 may be null (zeros).
extern "C" int ssm_scan(const void* x, const float* delta, const float* A,
                        const void* B, const void* C, const float* D,
                        const float* h0, void* y, float* hT, int bt, int L,
                        int dm, int n, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_n<float>(x, delta, A, B, C, D, h0, y, hT, bt, L, dm, n, s);
  if (dtype == 1)
    return dispatch_n<__nv_bfloat16>(x, delta, A, B, C, D, h0, y, hT, bt, L, dm, n, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
