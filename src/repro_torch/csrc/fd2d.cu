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
// the limit. What the design does about it: rows are streamed, not 2-D
// windows staged. A block owns a (bh, bw) output tile and walks it top to
// bottom in strips of at most 4 * 256 columns, one row at a time:
//  - the rows of u1 arrive by cp.async in a shared ring of R + 1 + STAGES
//    rows (16-byte copies on the "vec" route), STAGES rows ahead of the one
//    in use, so HBM reads overlap the arithmetic and u1 is fetched
//    (1 + 2r/bh) times per node, with the column halo rounded up to 16
//    bytes;
//  - each thread owns 4 adjacent columns and keeps their 2r + 1 vertical
//    values in registers as a sliding queue; the horizontal taps come from
//    the centre row in shared memory (3 or 5 16-byte loads a row);
//  - u2 arrives by cp.async as well, each thread's own columns into a
//    second ring of STAGES + 1 rows (read in the step that uses it, its
//    latency stood exposed: 3-16% slower by tile on the H100), and u3 is
//    written once as 16-byte vectors with the streaming hint (__stcs): 3 x
//    256 MB at 8192^2 cannot stay in the 50 MB L2;
//  - the periodic wrap is taken once per row (its row index) and once per
//    strip (the columns each thread copies); a block whose window does not
//    wrap takes no modulo at all.
// The "scalar" route is the same kernel with 4-byte copies and accesses,
// for a field whose width or tile width is not a multiple of 4 floats or
// whose base is not 16-byte aligned; the wrapper picks it up front.
//
// The arithmetic follows the builder term by term: per k the vertical
// term, then the horizontal one (the centre weight counted twice), lap *
// (1/dx^2), and dt^2 computed by the host in f64 and rounded to f32. The
// _rn intrinsics keep nvcc from contracting a * b + c into one FMA, so the
// result does not depend on the tile or the route: every output is the
// same chain of roundings (fd2d_stream_ref is its plain model).
#include "common.cuh"

namespace {

constexpr int MAX_R = 8;
constexpr int C = 4;          // adjacent columns a thread owns
constexpr int MAX_NT = 256;   // threads a block: a strip of 4 * 256 columns
constexpr int STAGES = 4;     // rows in flight ahead of the one pushed
constexpr int NU = STAGES + 1;  // u2 rows of the second ring

struct Weights {
  float w[2 * MAX_R + 1];
};

// halo columns staged on each side: r rounded up to a 16-byte group
__host__ __device__ constexpr int halo(int r) { return (r + 3) & ~3; }

__device__ __forceinline__ int wrap(int v, int n) {
  v %= n;
  return v < 0 ? v + n : v;
}

__device__ __forceinline__ uint32_t sptr(const float* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int R, bool VEC>
__global__ void __launch_bounds__(MAX_NT) fd2d_rows_kernel(
    const float* __restrict__ u1, const float* __restrict__ u2, float* __restrict__ u3,
    int h, int w, Weights wt, float inv_dx2, float dt2, int bh, int bw) {
  constexpr int RA = halo(R);
  constexpr int NR = R + 1 + STAGES;  // rows of the ring
  // copy slots a thread fills in every staged row: 16-byte groups on the
  // vec route (a strip's nt + RA / 2 groups over nt threads), floats on
  // the scalar route (4 nt + 2 RA floats over nt >= 32 threads)
  constexpr int NS = VEC ? 2 : C + 1;
  extern __shared__ __align__(16) float ring[];  // NR rows of sw floats, NU of cw
  const int nt = blockDim.x, t = threadIdx.x;
  const int cw = C * nt;                         // columns of a strip
  const int sw = cw + 2 * RA;                    // floats of a staged row
  float* ring2 = ring + NR * sw;                 // u2 rows, each thread its own columns
  const int y0 = blockIdx.y * bh, x0 = blockIdx.x * bw;
  const int ny = min(bh, h - y0);                // output rows of this block
  const int xe = min(x0 + bw, w);                // end of its columns
  const int nrows = ny + 2 * R;                  // u1 rows streamed a strip
  const bool wrap_rows = y0 < R || y0 + ny + R > h;

  for (int xc = x0; xc < xe; xc += cw) {
    const int ncol = min(cw, xe - xc);
    // staged column j of a row holds global column (xc - RA + j) mod w
    const int nstage = ncol + 2 * RA;            // floats to copy a row
    const bool wrap_cols = xc < RA || xc + ncol + RA > w;
    int col[NS];
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      const int j = VEC ? C * (t + k * nt) : t + k * nt;
      col[k] = j < nstage ? (wrap_cols ? wrap(xc - RA + j, w) : xc - RA + j) : -1;
    }
    const int x = xc + C * t;                    // this thread's first column
    const bool mine = x < xc + ncol;
    const long long x_off = x;
    auto fetch = [&](int s) {                    // u1 row s of the stream -> slot s % NR
      if (s < nrows) {
        int gy = y0 - R + s;
        if (wrap_rows) gy = wrap(gy, h);
        const float* src = u1 + (long long)gy * w;
        float* dst = ring + (s % NR) * sw;
#pragma unroll
        for (int k = 0; k < NS; ++k) {
          if (col[k] < 0) continue;
          if (VEC)
            repro::cp16(sptr(dst + C * (t + k * nt)), src + col[k], true);
          else
            repro::cp4(sptr(dst + t + k * nt), src + col[k], true);
        }
        const int i = s - 2 * R;                 // u2 row of the output row that pushes row s
        if (i >= 0 && mine) {
          const float* u2r = u2 + (long long)(y0 + i) * w + x;
          float* d2 = ring2 + (s % NU) * cw + C * t;
          if (VEC) {
            repro::cp16(sptr(d2), u2r, true);
          } else {
#pragma unroll
            for (int c = 0; c < C; ++c)
              if (x + c < xe) repro::cp4(sptr(d2 + c), u2r + c, true);
          }
        }
      }
      repro::cp_commit();                        // one group a row, empty past the end
    };

    float q[2 * R + 1][C];                       // rows y - R .. y + R of its columns
#pragma unroll
    for (int i = 0; i < 2 * R + 1; ++i)
#pragma unroll
      for (int c = 0; c < C; ++c) q[i][c] = 0.f;

#pragma unroll
    for (int s = 0; s < STAGES; ++s) fetch(s);
    for (int s = 0; s < nrows; ++s) {
      const int i = s - 2 * R;                   // output row y0 + i, once i >= 0
      repro::cp_wait<STAGES - 1>();              // row s has landed (this thread's part)
      __syncthreads();                           // ... everyone's; step s - 1 is done
      fetch(s + STAGES);                         // into the slot of row s - R - 1
      const float* pushed = ring + (s % NR) * sw + RA + C * t;
      const float4 nv = *reinterpret_cast<const float4*>(pushed);
#pragma unroll
      for (int k = 0; k < 2 * R; ++k)
#pragma unroll
        for (int c = 0; c < C; ++c) q[k][c] = q[k + 1][c];
      q[2 * R][0] = nv.x, q[2 * R][1] = nv.y, q[2 * R][2] = nv.z, q[2 * R][3] = nv.w;
      if (i < 0 || !mine) continue;
      const float* b = ring2 + (s % NU) * cw + C * t;  // u2 of its columns

      float hr[C + 2 * RA];                      // the centre row, columns x - RA ..
      const float4* centre =
          reinterpret_cast<const float4*>(ring + ((s - R) % NR) * sw + C * t);
#pragma unroll
      for (int v = 0; v < (C + 2 * RA) / 4; ++v) {
        const float4 a = centre[v];
        hr[4 * v] = a.x, hr[4 * v + 1] = a.y, hr[4 * v + 2] = a.z, hr[4 * v + 3] = a.w;
      }
      float r3[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        float lap = 0.f;
#pragma unroll
        for (int k = -R; k <= R; ++k) {
          const float wk = wt.w[k + R];
          lap = __fadd_rn(lap, __fmul_rn(wk, q[k + R][c]));      // vertical
          lap = __fadd_rn(lap, __fmul_rn(wk, hr[RA + c + k]));   // horizontal
        }
        lap = __fmul_rn(lap, inv_dx2);
        r3[c] = __fadd_rn(__fsub_rn(__fmul_rn(2.f, q[R][c]), b[c]), __fmul_rn(dt2, lap));
      }
      const long long o = (long long)(y0 + i) * w + x_off;
      if (VEC) {
        __stcs(reinterpret_cast<float4*>(u3 + o), make_float4(r3[0], r3[1], r3[2], r3[3]));
      } else {
#pragma unroll
        for (int c = 0; c < C; ++c)
          if (x + c < xe) __stcs(u3 + o + c, r3[c]);
      }
    }
    repro::cp_wait<0>();                         // drain the empty groups
    __syncthreads();                             // the ring is free for the next strip
  }
}

// threads a block for a tile bw columns wide: one per 4 columns, whole
// warps, at most MAX_NT (a wider tile is walked in strips)
int threads_for(int bw) {
  const int nt = (bw + 32 * C - 1) / (32 * C) * 32;
  return nt < MAX_NT ? nt : MAX_NT;
}

template <int R, bool VEC>
int launch(const float* u1, const float* u2, float* u3, int h, int w, const Weights& wt,
           float inv_dx2, float dt2, int bh, int bw, cudaStream_t s) {
  const int nt = threads_for(bw);
  const size_t smem =
      sizeof(float) * ((R + 1 + STAGES) * (size_t)(C * nt + 2 * halo(R)) + NU * (size_t)(C * nt));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fd2d_rows_kernel<R, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((w + bw - 1) / bw, (h + bh - 1) / bh);
  fd2d_rows_kernel<R, VEC><<<grid, nt, smem, s>>>(u1, u2, u3, h, w, wt, inv_dx2, dt2, bh, bw);
  return static_cast<int>(cudaGetLastError());
}

template <bool VEC>
int dispatch(const float* u1, const float* u2, float* u3, int h, int w, int r,
             const Weights& wt, float inv_dx2, float dt2, int bh, int bw, cudaStream_t s) {
  switch (r) {
    case 1: return launch<1, VEC>(u1, u2, u3, h, w, wt, inv_dx2, dt2, bh, bw, s);
    case 2: return launch<2, VEC>(u1, u2, u3, h, w, wt, inv_dx2, dt2, bh, bw, s);
    case 3: return launch<3, VEC>(u1, u2, u3, h, w, wt, inv_dx2, dt2, bh, bw, s);
    case 4: return launch<4, VEC>(u1, u2, u3, h, w, wt, inv_dx2, dt2, bh, bw, s);
    case 5: return launch<5, VEC>(u1, u2, u3, h, w, wt, inv_dx2, dt2, bh, bw, s);
    case 6: return launch<6, VEC>(u1, u2, u3, h, w, wt, inv_dx2, dt2, bh, bw, s);
    case 7: return launch<7, VEC>(u1, u2, u3, h, w, wt, inv_dx2, dt2, bh, bw, s);
    default: return launch<8, VEC>(u1, u2, u3, h, w, wt, inv_dx2, dt2, bh, bw, s);
  }
}

}  // namespace

// u1, u2, u3 (h, w) f32 contiguous; u3 must not alias u1. weights: 2r + 1
// host floats; inv_dx2 = 1/dx^2 and dt2 = dt^2 rounded to f32 by the caller.
// vec = 1 (the "vec" route) needs w and bw multiples of 4 and the three
// bases 16-byte aligned; vec = 0 takes any layout. The tile (bh, bw) needs
// (r + 1 + 4) rows of (4 nt + 2 halo(r)) floats and 5 rows of 4 nt floats
// of shared memory, nt = threads_for(bw).
extern "C" int fd2d(int vec, const float* u1, const float* u2, float* u3, int h, int w, int r,
                    const float* weights, float inv_dx2, float dt2, int bh, int bw,
                    void* stream) {
  if (r < 1 || r > MAX_R || h < 1 || w < 1 || bh < 1 || bw < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  if (vec && (w % C || bw % C || !aligned(u1) || !aligned(u2) || !aligned(u3)))
    return static_cast<int>(cudaErrorInvalidValue);
  Weights wt = {};
  for (int i = 0; i < 2 * r + 1; ++i) wt.w[i] = weights[i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec ? dispatch<true>(u1, u2, u3, h, w, r, wt, inv_dx2, dt2, bh, bw, s)
             : dispatch<false>(u1, u2, u3, h, w, r, wt, inv_dx2, dt2, bh, bw, s);
}
