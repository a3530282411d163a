// RMSNorm for Hopper.
//
// Replaces: src/repro/kernels/rmsnorm/kernel.py:21 rmsnorm_builder (reached
// through pl.pallas_call at src/repro/core/lang.py:1076).
//
// o = x * rsqrt(mean(x^2) + eps) * w over the last axis: the sum of x^2 in
// f32, (x * r) * w in f32, rounded once to x's dtype; x and w f32 or bf16.
//
// Bound on the H100: bytes. Each element is read once and written once with
// ~4 FLOPs between, far below the ~20 FLOP/byte where f32 arithmetic would
// be the limit; at decode (8 rows of 2048) the launch itself is the cost.
// What the design does about it: one warp per row, ROWS rows a block, holds
// the row in registers as raw 16-byte vectors (8 bf16 or 4 f32 a lane per
// vector, NV vectors a lane), so x is read from HBM once and written once;
// the sum of squares is reduced with warp shuffles (no shared memory, no
// block barrier); w is read 16 bytes at a time through the read-only path,
// beside x where the registers allow, so that one memory round trip serves
// both, and stays in L2 across rows. Rows that 16-byte accesses cannot
// serve (a width, row stride or base off 16 bytes) or that do not fit the
// registers (more than 32 vectors a lane) take rmsnorm_elem_kernel: the
// same warp per row, one element a lane at a time, x read twice (the second
// time from L1/L2). The Python wrapper picks the variant up front by layout
// (kernels/rmsnorm/ops.py::route) and this entry point refuses a vector
// launch whose layout does not allow it.
#include "common.cuh"

namespace {

using repro::Vec16;

constexpr int ROWS = 4;          // rows (warps) a block
constexpr int NT = ROWS * 32;
constexpr int MAX_NV = 32;       // 16-byte vectors a lane on the vector route

// the N elements of w that meet one 16-byte vector of x (8, 16 or 32
// bytes, as aligned), held raw and read through the read-only path
template <typename W, int N>
struct WVec {
  static constexpr int BYTES = N * static_cast<int>(sizeof(W));
  uint4 r[BYTES >= 16 ? BYTES / 16 : 1];
  __device__ __forceinline__ void load(const W* __restrict__ w, int e) {
    if constexpr (BYTES == 8) {  // 4 bf16
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(w + e));
      r[0].x = v.x;
      r[0].y = v.y;
    } else {
#pragma unroll
      for (int i = 0; i < BYTES / 16; ++i) r[i] = __ldg(reinterpret_cast<const uint4*>(w + e) + i);
    }
  }
  __device__ __forceinline__ void unpack(float* f) const {
    if constexpr (BYTES == 8) {
      Vec16<__nv_bfloat16>::unpack2(r[0].x, f);
      Vec16<__nv_bfloat16>::unpack2(r[0].y, f + 2);
    } else {
#pragma unroll
      for (int i = 0; i < BYTES / 16; ++i) Vec16<W>::unpack(r[i], f + i * Vec16<W>::N);
    }
  }
};

template <typename T, typename W, int NV>
__global__ void __launch_bounds__(NT) rmsnorm_vec_kernel(
    const T* __restrict__ x, const W* __restrict__ w, T* __restrict__ o, int rows,
    int d, long long sx, float eps) {
  constexpr int N = Vec16<T>::N;
  // w's vectors are loaded beside x's, before the reduction, while both fit
  // in 128 registers a lane; wider rows load them after it
  constexpr bool PRE = NV * (16 + WVec<W, N>::BYTES) <= 512;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * ROWS + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int nvec = d / N;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * sx);
  uint4 r[NV];
  WVec<W, N> wr[PRE ? NV : 1];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int v = lane + 32 * i;
    if (v < nvec) {
      r[i] = xr[v];
      if constexpr (PRE) wr[i].load(w, v * N);
    }
  }
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (lane + 32 * i < nvec) {
      float f[N];
      Vec16<T>::unpack(r[i], f);
#pragma unroll
      for (int k = 0; k < N; ++k) ss += f[k] * f[k];
    }
  }
  const float inv = rsqrtf(repro::warp_sum(ss) / d + eps);
  uint4* orow = reinterpret_cast<uint4*>(o + static_cast<long long>(row) * d);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int v = lane + 32 * i;
    if (v < nvec) {
      float f[N], wf[N];
      Vec16<T>::unpack(r[i], f);
      if constexpr (PRE) {
        wr[i].unpack(wf);
      } else {
        WVec<W, N> wv;
        wv.load(w, v * N);
        wv.unpack(wf);
      }
#pragma unroll
      for (int k = 0; k < N; ++k) f[k] = f[k] * inv * wf[k];
      orow[v] = Vec16<T>::pack(f);
    }
  }
}

template <typename T, typename W>
__global__ void __launch_bounds__(NT) rmsnorm_elem_kernel(
    const T* __restrict__ x, const W* __restrict__ w, T* __restrict__ o, int rows,
    int d, long long sx, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * ROWS + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + row * sx;
  float ss = 0.f;
  for (int c = lane; c < d; c += 32) {
    const float v = repro::to_f32(xr[c]);
    ss += v * v;
  }
  const float inv = rsqrtf(repro::warp_sum(ss) / d + eps);
  T* orow = o + static_cast<long long>(row) * d;
  for (int c = lane; c < d; c += 32)
    orow[c] = repro::from_f32<T>(repro::to_f32(xr[c]) * inv * repro::to_f32(__ldg(w + c)));
}

template <typename T, typename W>
int launch(bool vec, const void* x, const void* w, void* o, int rows, int d,
           long long sx, float eps, cudaStream_t s) {
  const T* xp = static_cast<const T*>(x);
  const W* wp = static_cast<const W*>(w);
  T* op = static_cast<T*>(o);
  const dim3 grid((rows + ROWS - 1) / ROWS);
  if (!vec) {
    rmsnorm_elem_kernel<T, W><<<grid, NT, 0, s>>>(xp, wp, op, rows, d, sx, eps);
    return 0;
  }
  constexpr int N = Vec16<T>::N;
  const int per = (d / N + 31) / 32;  // vectors a lane
#define REPRO_RMS(NVV)                                                          \
  if (per <= NVV) {                                                            \
    rmsnorm_vec_kernel<T, W, NVV><<<grid, NT, 0, s>>>(xp, wp, op, rows, d, sx, \
                                                      eps);                    \
    return 0;                                                                  \
  }
  REPRO_RMS(1)
  REPRO_RMS(2)
  REPRO_RMS(4)
  REPRO_RMS(8)
  REPRO_RMS(12)
  REPRO_RMS(16)
  REPRO_RMS(24)
  REPRO_RMS(32)
#undef REPRO_RMS
  return static_cast<int>(cudaErrorInvalidValue);
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// x (rows, d) with row stride sx (elements) and a contiguous last axis;
// w (d,) contiguous; o (rows, d) contiguous. x_dtype / w_dtype: 0 = float32,
// 1 = bfloat16. vec = 1 asks for the 16-byte vector kernel, which takes
// d and sx multiples of a 16-byte vector of x, x, w and o 16-byte aligned
// (8-byte for a bf16 w under an f32 x) and at most 32 vectors a lane;
// vec = 0 takes any layout. Returns a CUDA error code (0 = launched).
extern "C" int rmsnorm(int vec, const void* x, const void* w, void* o, int rows,
                       int d, long long sx, int x_dtype, int w_dtype, float eps,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (vec) {
    const int n = x_dtype == 0 ? 4 : 8;              // elements a vector of x
    const int wb = n * (w_dtype == 0 ? 4 : 2);       // bytes of w a vector
    if (d % n || sx % n || (d / n + 31) / 32 > MAX_NV || !aligned(x, 16) ||
        !aligned(o, 16) || !aligned(w, wb < 16 ? wb : 16))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  int err;
  if (x_dtype == 0 && w_dtype == 0)
    err = launch<float, float>(vec, x, w, o, rows, d, sx, eps, s);
  else if (x_dtype == 0 && w_dtype == 1)
    err = launch<float, __nv_bfloat16>(vec, x, w, o, rows, d, sx, eps, s);
  else if (x_dtype == 1 && w_dtype == 0)
    err = launch<__nv_bfloat16, float>(vec, x, w, o, rows, d, sx, eps, s);
  else if (x_dtype == 1 && w_dtype == 1)
    err = launch<__nv_bfloat16, __nv_bfloat16>(vec, x, w, o, rows, d, sx, eps, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return err ? err : static_cast<int>(cudaGetLastError());
}
