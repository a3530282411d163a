// The discontinuous-Galerkin shallow-water right-hand side (the paper's DG
// app) on Hopper: the volume kernel and the surface kernel.
//
// Replaces: src/repro/apps/dg_swe.py:26 dg_volume_builder and
// src/repro/apps/dg_swe.py:276 dg_surface_builder (the dg_volume and
// dg_surface ops, reached through pl.pallas_call at
// src/repro/core/lang.py:1076).
//
// Volume: q (E, np, 3) = (h, hu, hv) per node, geom (E, 4) = (rx, sx, ry, sy)
// affine factors, db (E, np, 2) bathymetry gradients, Dr/Ds (np, np):
//   F = (hu, hu u + g h^2/2, hu v),  G = (hv, hu v, hv v + g h^2/2)
//   out = -(rx Dr F + sx Ds F + ry Dr G + sy Ds G) + (0, -g h B_x, -g h B_y)
// Surface: traces qm, qp (E, 3nfp, 3), nrm (E, 3nfp, 3) = (nx, ny, fscale),
// lift (np, 3nfp): the local Lax-Friedrichs flux
//   f* = (FM + FP)/2 + max(lamM, lamP)/2 (qm - qp),  lam = |u.n| + sqrt(g h)
// and out (E, np, 3) = lift @ ((FM - f*) fscale) per element.
//
// Bound on the H100: bytes, for both. The volume moves (3 + 3 + 2) np + 4
// floats per element for 24 np^2 + 30 np FLOPs (5.3 FLOP/B at np = 21); the
// surface 3 * 3nfp * 3 + 3 np floats for 6 np 3nfp + ~80 3nfp FLOPs: both
// below the f32 ridge of 20 FLOP/B. What the design does about it: a block
// owns `eb` consecutive elements and stages Dr/Ds (or lift) in shared
// memory once for all of them. Volume: each thread forms F and G of its node
// into shared memory, the block syncs, then each thread computes its node's
// three outputs with np-long dot products, so q is read from HBM once and
// F, G never leave the SM. Surface: each face-node thread writes
// (FM - f*) fscale into shared memory, the block syncs, then each
// volume-node thread applies lift with 3nfp-long dot products. Divisions
// by h are as in the reference, unguarded. The last block's ragged run of
// elements is cut at E.
#include "common.cuh"

namespace {

constexpr int NT = 256;

__global__ void __launch_bounds__(NT) dg_volume_kernel(
    const float* __restrict__ q, const float* __restrict__ geom, const float* __restrict__ db,
    const float* __restrict__ dr, const float* __restrict__ ds, float* __restrict__ out,
    int E, int np, int eb, float g) {
  extern __shared__ float sm[];
  float* DR = sm;            // (np, np)
  float* DS = DR + np * np;  // (np, np)
  float* FG = DS + np * np;  // (eb, np, 6): F0 F1 F2 G0 G1 G2
  const int t = threadIdx.x;
  for (int i = t; i < np * np; i += NT) {
    DR[i] = dr[i];
    DS[i] = ds[i];
  }
  const int ebase = blockIdx.x * eb;
  const long long e0 = ebase;
  const int nn = min(eb, E - ebase) * np;
  const float* qb = q + e0 * np * 3;
  for (int i = t; i < nn; i += NT) {
    const float h = qb[3 * i], hu = qb[3 * i + 1], hv = qb[3 * i + 2];
    const float u = hu / h, v = hv / h;
    const float gh2 = 0.5f * g * h * h;
    float* f = FG + 6 * i;
    f[0] = hu;
    f[1] = hu * u + gh2;
    f[2] = hu * v;
    f[3] = hv;
    f[4] = hu * v;
    f[5] = hv * v + gh2;
  }
  __syncthreads();
  for (int i = t; i < nn; i += NT) {
    const int el = i / np, n = i - el * np;
    const float* fe = FG + 6 * el * np;
    float drf[3] = {0.f, 0.f, 0.f}, dsf[3] = {0.f, 0.f, 0.f};
    float drg[3] = {0.f, 0.f, 0.f}, dsg[3] = {0.f, 0.f, 0.f};
    for (int m = 0; m < np; ++m) {
      const float a = DR[n * np + m], b = DS[n * np + m];
      const float* f = fe + 6 * m;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        drf[k] += a * f[k];
        dsf[k] += b * f[k];
        drg[k] += a * f[3 + k];
        dsg[k] += b * f[3 + k];
      }
    }
    const float* ge = geom + 4 * (e0 + el);
    const float rx = ge[0], sx = ge[1], ry = ge[2], sy = ge[3];
    const float h = qb[3 * i];
    const float* dbi = db + 2 * (e0 * np + i);
    const float src[3] = {0.f, -g * h * dbi[0], -g * h * dbi[1]};
    float* o = out + 3 * (e0 * np + i);
#pragma unroll
    for (int k = 0; k < 3; ++k)
      o[k] = -((rx * drf[k] + sx * dsf[k]) + (ry * drg[k] + sy * dsg[k])) + src[k];
  }
}

__device__ __forceinline__ void normal_flux(float h, float hu, float hv, float nx, float ny,
                                            float g, float* fn, float* lam) {
  const float u = hu / h, v = hv / h;
  const float gh2 = 0.5f * g * h * h;
  fn[0] = hu * nx + hv * ny;
  fn[1] = (hu * u + gh2) * nx + hu * v * ny;
  fn[2] = hu * v * nx + (hv * v + gh2) * ny;
  *lam = fabsf(u * nx + v * ny) + sqrtf(g * h);
}

__global__ void __launch_bounds__(NT) dg_surface_kernel(
    const float* __restrict__ qm, const float* __restrict__ qp, const float* __restrict__ nrm,
    const float* __restrict__ lift, float* __restrict__ out, int E, int np, int nfp3, int eb,
    float g) {
  extern __shared__ float sm[];
  float* L = sm;               // (np, 3nfp)
  float* DF = L + np * nfp3;   // (eb, 3nfp, 3)
  const int t = threadIdx.x;
  for (int i = t; i < np * nfp3; i += NT) L[i] = lift[i];
  const int ebase = blockIdx.x * eb;
  const long long e0 = ebase;
  const int ne = min(eb, E - ebase);
  const long long f0 = e0 * nfp3;
  for (int i = t; i < ne * nfp3; i += NT) {
    const float* m = qm + 3 * (f0 + i);
    const float* p = qp + 3 * (f0 + i);
    const float* nr = nrm + 3 * (f0 + i);
    float fm[3], fp[3], lm, lp;
    normal_flux(m[0], m[1], m[2], nr[0], nr[1], g, fm, &lm);
    normal_flux(p[0], p[1], p[2], nr[0], nr[1], g, fp, &lp);
    const float C = fmaxf(lm, lp);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float fstar = 0.5f * (fm[k] + fp[k]) + 0.5f * C * (m[k] - p[k]);
      DF[3 * i + k] = (fm[k] - fstar) * nr[2];
    }
  }
  __syncthreads();
  for (int i = t; i < ne * np; i += NT) {
    const int el = i / np, n = i - el * np;
    const float* d = DF + 3 * el * nfp3;
    const float* l = L + n * nfp3;
    float s0 = 0.f, s1 = 0.f, s2 = 0.f;
    for (int f = 0; f < nfp3; ++f) {
      s0 += l[f] * d[3 * f];
      s1 += l[f] * d[3 * f + 1];
      s2 += l[f] * d[3 * f + 2];
    }
    float* o = out + 3 * (e0 * np + i);
    o[0] = s0;
    o[1] = s1;
    o[2] = s2;
  }
}

template <typename K>
int set_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
}

}  // namespace

// q, out (E, np, 3), geom (E, 4), db (E, np, 2), dr, ds (np, np): f32,
// contiguous. One block of 256 threads per run of eb elements, with
// (2 np^2 + 6 eb np) * 4 bytes of shared memory.
extern "C" int dg_volume(const float* q, const float* geom, const float* db, const float* dr,
                         const float* ds, float* out, int E, int np, int eb, float g,
                         void* stream) {
  if (E < 1 || np < 1 || eb < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * (2 * (size_t)np * np + 6 * (size_t)eb * np);
  const int err = set_smem(dg_volume_kernel, smem);
  if (err) return err;
  const int blocks = (E + eb - 1) / eb;
  dg_volume_kernel<<<blocks, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      q, geom, db, dr, ds, out, E, np, eb, g);
  return static_cast<int>(cudaGetLastError());
}

// qm, qp, nrm (E, nfp3, 3), lift (np, nfp3), out (E, np, 3): f32,
// contiguous. One block of 256 threads per run of eb elements, with
// (np nfp3 + 3 eb nfp3) * 4 bytes of shared memory.
extern "C" int dg_surface(const float* qm, const float* qp, const float* nrm, const float* lift,
                          float* out, int E, int np, int nfp3, int eb, float g, void* stream) {
  if (E < 1 || np < 1 || nfp3 < 1 || eb < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * ((size_t)np * nfp3 + 3 * (size_t)eb * nfp3);
  const int err = set_smem(dg_surface_kernel, smem);
  if (err) return err;
  const int blocks = (E + eb - 1) / eb;
  dg_surface_kernel<<<blocks, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      qm, qp, nrm, lift, out, E, np, nfp3, eb, g);
  return static_cast<int>(cudaGetLastError());
}
