// One leapfrog step of the 2-D acoustic wave equation (the paper's FD app)
// on Hopper.
//
// Replaces: src/repro/apps/fd2d.py:21 fd2d_builder (the fd2d op, reached
// through pl.pallas_call at src/repro/core/lang.py:1076).
//
// u3 = 2 u1 - u2 + dt^2 (u_xx + u_yy) on a periodic (h, w) f32 field, with
// the order-2r central second-derivative stencil `weights` (2r + 1 taps,
// 1 <= r <= 8) along each axis.
//
// Bound on the H100: bytes. Each node reads u1 and u2 once and writes u3
// once (12 B) for 4(2r+1)+5 FLOPs, ~3 FLOP/B at r = 4: far below the
// 67e12 / 3.35e12 = 20 FLOP/B where the f32 CUDA cores, not HBM, would be
// the limit. What the design does about it: one block per (bh, bw) output
// tile stages the tile's (bh+2r, bw+2r) window of u1 in shared memory with
// periodic wrap (modular row and column indices), so u1 comes from HBM
// (1 + 2r/bh)(1 + 2r/bw) times instead of once per stencil tap; u2 and u3
// stream through registers once, neighbouring threads on neighbouring
// columns. The ragged edge (h or w not a multiple of the tile) is masked
// here; the TPU builder needed exact tiles.
//
// The arithmetic follows the builder term by term so that f32 results agree
// to ~1 ulp: per k the vertical term, then the horizontal one (the centre
// weight counted twice), lap * (1/dx^2), and dt^2 computed by the host in
// f64 and rounded to f32. The _rn intrinsics keep nvcc from contracting
// a * b + c into one FMA, which the builder's separate roundings do not do.
#include "common.cuh"

namespace {

constexpr int NT = 256;
constexpr int MAX_R = 8;

struct Weights {
  float w[2 * MAX_R + 1];
};

template <int R>
__global__ void __launch_bounds__(NT) fd2d_kernel(
    const float* __restrict__ u1, const float* __restrict__ u2, float* __restrict__ u3,
    int h, int w, Weights wt, float inv_dx2, float dt2, int bh, int bw) {
  extern __shared__ float win[];  // (bh + 2R) x (bw + 2R), row-major
  const int ww = bw + 2 * R, wh = bh + 2 * R;
  const int y0 = blockIdx.y * bh, x0 = blockIdx.x * bw;
  for (int i = threadIdx.x; i < wh * ww; i += NT) {
    const int wy = i / ww, wx = i - wy * ww;
    int gy = (y0 - R + wy) % h;
    int gx = (x0 - R + wx) % w;
    if (gy < 0) gy += h;
    if (gx < 0) gx += w;
    win[i] = u1[(long long)gy * w + gx];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < bh * bw; i += NT) {
    const int ty = i / bw, tx = i - ty * bw;
    const int gy = y0 + ty, gx = x0 + tx;
    if (gy >= h || gx >= w) continue;
    const float* c = win + (ty + R) * ww + (tx + R);
    float lap = 0.f;
#pragma unroll
    for (int k = -R; k <= R; ++k) {
      const float wk = wt.w[k + R];
      lap = __fadd_rn(lap, __fmul_rn(wk, c[k * ww]));  // vertical
      lap = __fadd_rn(lap, __fmul_rn(wk, c[k]));       // horizontal
    }
    lap = __fmul_rn(lap, inv_dx2);
    const long long o = (long long)gy * w + gx;
    u3[o] = __fadd_rn(__fsub_rn(__fmul_rn(2.f, c[0]), u2[o]), __fmul_rn(dt2, lap));
  }
}

template <int R>
int launch(const float* u1, const float* u2, float* u3, int h, int w, const Weights& wt,
           float inv_dx2, float dt2, int bh, int bw, cudaStream_t s) {
  const size_t smem = sizeof(float) * (size_t)(bh + 2 * R) * (size_t)(bw + 2 * R);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fd2d_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((w + bw - 1) / bw, (h + bh - 1) / bh);
  fd2d_kernel<R><<<grid, NT, smem, s>>>(u1, u2, u3, h, w, wt, inv_dx2, dt2, bh, bw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// u1, u2, u3 (h, w) f32 contiguous; u3 must not alias u1. weights: 2r + 1
// host floats; inv_dx2 = 1/dx^2 and dt2 = dt^2 rounded to f32 by the caller.
// The tile (bh, bw) needs (bh + 2r)(bw + 2r) * 4 bytes of shared memory.
extern "C" int fd2d(const float* u1, const float* u2, float* u3, int h, int w, int r,
                    const float* weights, float inv_dx2, float dt2, int bh, int bw,
                    void* stream) {
  if (r < 1 || r > MAX_R || h < 1 || w < 1 || bh < 1 || bw < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Weights wt = {};
  for (int i = 0; i < 2 * r + 1; ++i) wt.w[i] = weights[i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (r) {
    case 1: return launch<1>(u1, u2, u3, h, w, wt, inv_dx2, dt2, bh, bw, s);
    case 2: return launch<2>(u1, u2, u3, h, w, wt, inv_dx2, dt2, bh, bw, s);
    case 3: return launch<3>(u1, u2, u3, h, w, wt, inv_dx2, dt2, bh, bw, s);
    case 4: return launch<4>(u1, u2, u3, h, w, wt, inv_dx2, dt2, bh, bw, s);
    case 5: return launch<5>(u1, u2, u3, h, w, wt, inv_dx2, dt2, bh, bw, s);
    case 6: return launch<6>(u1, u2, u3, h, w, wt, inv_dx2, dt2, bh, bw, s);
    case 7: return launch<7>(u1, u2, u3, h, w, wt, inv_dx2, dt2, bh, bw, s);
    default: return launch<8>(u1, u2, u3, h, w, wt, inv_dx2, dt2, bh, bw, s);
  }
}
