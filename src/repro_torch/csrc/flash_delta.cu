// The flash backward's delta precompute on Hopper.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py:180
// flash_delta_builder (reached through pl.pallas_call at
// src/repro/core/lang.py:1076).
//
// delta[b, h, s] = sum_d do[b, h, s, d] * o[b, h, s, d] in f32: do and o
// (B, H, Sq, D) f32 or bf16 with a contiguous last axis and any (b, h, s)
// strides (the train step's do is a transposed view of row stride H D,
// read in place), delta (B, H, Sq) f32 contiguous.
//
// Bound on the H100: bytes. Each element of do and o is read once for one
// product and one add; delta is written once (34.1 MB at the train step's
// 4 x 32 x 1024 x 64 bf16, 10.2 us at 3.35 TB/s). Design:
//  - "vec" route (d itemsize a multiple of 16, both bases 16-byte aligned,
//    every row stride whole vectors, one dtype): a group of L lanes reads a
//    row as 16-byte vectors, L the row's vectors rounded up to a power of 2
//    and at most 32 (8 lanes for bf16 d = 64, 16 for d = 128, 32 for 256).
//    "scalar" route otherwise: a warp reads a row element by element.
//  - Each group has RU = 2 rows in flight: every lane issues its 4 loads
//    before the first product (4 rows, 8 loads, ran slower on the card).
//  - Products and sums in f32 (bf16 x bf16 products are exact in f32), a
//    shuffle reduction inside the group, one lane stores.
//  - A grid over rows: block (x, h, b) takes 256 / L groups x RU rows of
//    head (b, h), so a row's offset is one multiply-add (2048 blocks at the
//    train shape: two waves of 8 an SM).
// The wrapper binds the C function once and passes ints for pointers and
// the raw stream handle: the call's host path is most of its cost.
#include "common.cuh"

namespace {

constexpr int NT = 256;  // threads a block
constexpr int RU = 2;    // rows a lane group has in flight

// (b, h, s) strides of do and o in elements
struct Strides {
  long long db, dh, ds, ob, oh, os;
};

template <int L>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// block (x, h, b) takes rows s = x G RU + g + k G (k < RU) of head (b, h):
// G groups of L lanes, nvec 16-byte vectors a row
template <typename T, int L>
__global__ void __launch_bounds__(NT) delta_vec_kernel(const T* __restrict__ dO,
                                                       const T* __restrict__ O,
                                                       float* __restrict__ delta, int Sq,
                                                       int nvec, Strides st) {
  constexpr int G = NT / L, VE = repro::Vec16<T>::N;
  const int lane = threadIdx.x % L, h = blockIdx.y, b = blockIdx.z;
  const int s0 = blockIdx.x * G * RU + threadIdx.x / L;
  const T* dr = dO + b * st.db + h * st.dh;
  const T* orow = O + b * st.ob + h * st.oh;
  float acc[RU];
#pragma unroll
  for (int k = 0; k < RU; ++k) acc[k] = 0.f;
  for (int v0 = 0; v0 < nvec; v0 += L) {   // one pass unless a row has > 32 vectors
    const int v = v0 + lane;
    uint4 x[RU], y[RU];
#pragma unroll
    for (int k = 0; k < RU; ++k) {
      const int s = s0 + k * G;
      const bool ok = s < Sq && v < nvec;
      x[k] = ok ? __ldg(reinterpret_cast<const uint4*>(dr + s * st.ds) + v)
                : make_uint4(0, 0, 0, 0);
      y[k] = ok ? __ldg(reinterpret_cast<const uint4*>(orow + s * st.os) + v)
                : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int k = 0; k < RU; ++k) {
      float a[VE], c[VE];
      repro::Vec16<T>::unpack(x[k], a);
      repro::Vec16<T>::unpack(y[k], c);
#pragma unroll
      for (int j = 0; j < VE; ++j) acc[k] = fmaf(a[j], c[j], acc[k]);
    }
  }
  float* out = delta + ((long long)b * gridDim.y + h) * Sq;
#pragma unroll
  for (int k = 0; k < RU; ++k) {
    const float sum = group_sum<L>(acc[k]);
    if (lane == 0 && s0 + k * G < Sq) out[s0 + k * G] = sum;
  }
}

// a warp a row, element by element (any d, any alignment, mixed dtypes);
// the same rows a block as the vec kernel at L = 32
template <typename TD, typename TO>
__global__ void __launch_bounds__(NT) delta_scalar_kernel(const TD* __restrict__ dO,
                                                          const TO* __restrict__ O,
                                                          float* __restrict__ delta, int Sq,
                                                          int d, Strides st) {
  constexpr int G = NT / 32;
  const int lane = threadIdx.x % 32, h = blockIdx.y, b = blockIdx.z;
  const int s0 = blockIdx.x * G * RU + threadIdx.x / 32;
  const TD* dr = dO + b * st.db + h * st.dh;
  const TO* orow = O + b * st.ob + h * st.oh;
  float acc[RU];
#pragma unroll
  for (int k = 0; k < RU; ++k) acc[k] = 0.f;
  for (int j0 = 0; j0 < d; j0 += 32) {
    const int j = j0 + lane;
    float x[RU], y[RU];
#pragma unroll
    for (int k = 0; k < RU; ++k) {
      const int s = s0 + k * G;
      const bool ok = s < Sq && j < d;
      x[k] = ok ? repro::to_f32<TD>(dr[s * st.ds + j]) : 0.f;
      y[k] = ok ? repro::to_f32<TO>(orow[s * st.os + j]) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < RU; ++k) acc[k] = fmaf(x[k], y[k], acc[k]);
  }
  float* out = delta + ((long long)b * gridDim.y + h) * Sq;
#pragma unroll
  for (int k = 0; k < RU; ++k) {
    const float sum = group_sum<32>(acc[k]);
    if (lane == 0 && s0 + k * G < Sq) out[s0 + k * G] = sum;
  }
}

// blocks of RU rows per group along Sq, one grid row per head, one grid
// layer per batch entry
dim3 grid_of(int B, int H, int Sq, int groups) {
  const int rows = groups * RU;
  return dim3((Sq + rows - 1) / rows, H, B);
}

template <typename T, int L>
int launch_vec(const void* dO, const void* O, float* delta, int B, int H, int Sq, int nvec,
               const Strides& st, cudaStream_t s) {
  delta_vec_kernel<T, L><<<grid_of(B, H, Sq, NT / L), NT, 0, s>>>(
      static_cast<const T*>(dO), static_cast<const T*>(O), delta, Sq, nvec, st);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int vec_lanes(const void* dO, const void* O, float* delta, int B, int H, int Sq, int nvec,
              const Strides& st, cudaStream_t s) {
  if (nvec <= 1) return launch_vec<T, 1>(dO, O, delta, B, H, Sq, nvec, st, s);
  if (nvec <= 2) return launch_vec<T, 2>(dO, O, delta, B, H, Sq, nvec, st, s);
  if (nvec <= 4) return launch_vec<T, 4>(dO, O, delta, B, H, Sq, nvec, st, s);
  if (nvec <= 8) return launch_vec<T, 8>(dO, O, delta, B, H, Sq, nvec, st, s);
  if (nvec <= 16) return launch_vec<T, 16>(dO, O, delta, B, H, Sq, nvec, st, s);
  return launch_vec<T, 32>(dO, O, delta, B, H, Sq, nvec, st, s);
}

template <typename TD, typename TO>
int launch_scalar(const void* dO, const void* O, float* delta, int B, int H, int Sq, int d,
                  const Strides& st, cudaStream_t s) {
  delta_scalar_kernel<TD, TO><<<grid_of(B, H, Sq, NT / 32), NT, 0, s>>>(
      static_cast<const TD*>(dO), static_cast<const TO*>(O), delta, Sq, d, st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// do, o (B, H, Sq, D) with (b, h, s) strides sd*, so* in elements and a
// contiguous last axis; dtype codes 0 = f32, 1 = bf16; delta (B, H, Sq) f32
// contiguous. vec = 1 takes the "vec" route (the wrapper checked its
// layout: one dtype, D itemsize a multiple of 16, bases 16-byte aligned,
// strides whole vectors), vec = 0 the "scalar" one. B and H at most 65535.
extern "C" int flash_delta(int vec, const void* dO, const void* O, float* delta, int B, int H,
                           int Sq, int D, int dt_do, int dt_o, long long sdb, long long sdh,
                           long long sds, long long sob, long long soh, long long sos,
                           void* stream) {
  if (B < 1 || H < 1 || B > 65535 || H > 65535 || Sq < 1 || D < 1 || dt_do < 0 || dt_do > 1 ||
      dt_o < 0 || dt_o > 1 || (vec && dt_do != dt_o))
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides st{sdb, sdh, sds, sob, soh, sos};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    if (dt_do == 0) return vec_lanes<float>(dO, O, delta, B, H, Sq, D / 4, st, s);
    return vec_lanes<__nv_bfloat16>(dO, O, delta, B, H, Sq, D / 8, st, s);
  }
  if (dt_do == 0 && dt_o == 0)
    return launch_scalar<float, float>(dO, O, delta, B, H, Sq, D, st, s);
  if (dt_do == 0) return launch_scalar<float, __nv_bfloat16>(dO, O, delta, B, H, Sq, D, st, s);
  if (dt_o == 0) return launch_scalar<__nv_bfloat16, float>(dO, O, delta, B, H, Sq, D, st, s);
  return launch_scalar<__nv_bfloat16, __nv_bfloat16>(dO, O, delta, B, H, Sq, D, st, s);
}
