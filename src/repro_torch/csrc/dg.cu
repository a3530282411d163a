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
// floats per element for 24 np^2 + 30 np FLOPs as the builder writes it
// (5.3 FLOP/B at np = 21); the surface 3 * 3nfp * 3 + 3 np floats for
// 6 np 3nfp + ~80 3nfp FLOPs: both below the f32 ridge of 20 FLOP/B.
//
// Volume design. 24 np^2 FMAs an element as the builder writes them, each
// wanting an entry of Dr or Ds: a loop that loads an entry per FMA is
// bound by the SM's shared-memory pipe before HBM (a 16-byte broadcast
// still returns 512 bytes to a warp). So:
//  - The affine factors are folded first: rx, sx, ry, sy are constant over
//    an element, so per node P = rx F + ry G and S = sx F + sy G (6 values),
//    and out = -(Dr P + Ds S) + src: 6 FMAs per (n, m) instead of 12.
//  - A chunk of ec <= 64 elements has 3 threads an element. First each
//    forms P and S of its element's every third node into shared memory
//    laid out element-fastest (no bank conflicts). Then each owns one of 3
//    groups of ceil(np / 3) output nodes for all three fields and keeps
//    their sums in registers: per m it reads its element's 6 values of P
//    and S and the group's entries of column m of Dr and Ds (16-byte
//    broadcasts: the threads of a warp read the same address), each entry
//    feeding the three fields. The two sums Dr P and Ds S stay apart and
//    are added at the end (rounding depth ~np + 4). np is a template
//    parameter for N = 1..7 (np 3..36), the loops fully unrolled; any other
//    np takes the generic instance (sums in blocks of 8 nodes), picked by
//    the wrapper up front.
//  - q, db and geom of the chunk are contiguous runs of floats: they arrive
//    by 16-byte cp.async (4-byte ones at a run's ragged ends), and the
//    outputs leave through shared memory by coalesced 16-byte stores,
//    whatever np is. With eb = 64 a block is one chunk of 192 threads (no
//    ragged round), three blocks an SM (at most 113 registers a thread).
// Dr and Ds sit in shared memory, so no launch writes module state (no
// __constant__ copy that two streams could race on).
// Surface design: each face-node thread writes (FM - f*) fscale into shared
// memory, the block syncs, then each volume-node thread applies lift with
// 3nfp-long dot products. Divisions by h are as in the reference,
// unguarded. The last block's ragged run of elements is cut at E.
#include "common.cuh"

namespace {

constexpr int NT = 256;      // threads a block of the surface kernel
constexpr int VOL_EC = 64;   // elements a chunk of the volume kernel: 192 threads
constexpr int VOL_MINB = 3;  // its blocks resident an SM (<= 113 registers a thread)

__device__ __forceinline__ uint32_t sptr(const float* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// floats a run starts past a 16-byte boundary
__device__ __forceinline__ int lead_of(const float* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

// n floats of global src into shared dst, src[i] at dst[i + lead_of(src)]:
// 16-byte cp.async for whole aligned groups, 4-byte ones at the run's ends
__device__ __forceinline__ void stage(float* dst, const float* src, int n, int t, int nt) {
  const int lead = lead_of(src);
  for (int g = t; g < (n + lead + 3) >> 2; g += nt) {
    const int lo = 4 * g - lead;
    if (lo >= 0 && lo + 4 <= n) {
      repro::cp16(sptr(dst + 4 * g), src + lo, true);
    } else {
      for (int j = 0; j < 4; ++j)
        if (lo + j >= 0 && lo + j < n) repro::cp4(sptr(dst + 4 * g + j), src + lo + j, true);
    }
  }
}

// the reverse: shared src (src[i + lead_of(dst)] holds dst[i]) to global dst
__device__ __forceinline__ void unstage(float* dst, const float* src, int n, int t, int nt) {
  const int lead = lead_of(dst);
  for (int g = t; g < (n + lead + 3) >> 2; g += nt) {
    const int lo = 4 * g - lead;
    if (lo >= 0 && lo + 4 <= n) {
      *reinterpret_cast<float4*>(dst + lo) = *reinterpret_cast<const float4*>(src + 4 * g);
    } else {
      for (int j = 0; j < 4; ++j)
        if (lo + j >= 0 && lo + j < n) dst[lo + j] = src[4 * g + j];
    }
  }
}

// A thread owns an element and one of 3 groups of ng = ceil(np / 3)
// output nodes, for all three fields. Its rows of Dr and Ds sit in shared
// memory as (np, 3, 2, ngp): for each m and group, the group's ng entries
// of column m of Dr, then of Ds, each padded with zeros to ngp (whole
// 16-byte groups, and whole blocks of 8 sums on the generic instance).
__host__ __device__ constexpr int vol_ngp(int np, bool generic) {
  return generic ? ((np + 2) / 3 + 7) & ~7 : ((np + 2) / 3 + 3) & ~3;
}

__host__ __device__ constexpr int r4(int n) { return (n + 3) / 4 * 4; }

// floats of a chunk's staged inputs, ec elements: q (ec np 3 + lead), db
// (ec np 2 + lead), geom (4 ec + lead), each 16-byte aligned
__host__ __device__ constexpr int vol_buf_floats(int np, int ec) {
  return r4(3 * ec * np + 4) + r4(2 * ec * np + 4) + 4 * ec + 4;
}

// shared floats of the volume kernel: DT (np, 3, 2, ngp), the staged
// inputs, P/S (np, 6, ec), and on the generic instance the outputs (ec
// np 3 + lead; the templated one writes them over P/S)
__host__ __device__ constexpr int vol_smem_floats(int np, int ec, bool generic) {
  return 6 * np * vol_ngp(np, generic) + vol_buf_floats(np, ec) + r4(6 * np * ec) +
         (generic ? r4(3 * ec * np + 4) : 0);
}

// P = rx F + ry G and S = sx F + sy G of field f at the node (h, hu, hv) at qn
__device__ __forceinline__ void fold(int f, const float* qn, float rx, float sx, float ry,
                                     float sy, float g, float& p, float& s) {
  const float h = qn[0], hu = qn[1], hv = qn[2];
  float F, G;
  if (f == 0) {
    F = hu, G = hv;
  } else {
    const float v = hv / h;
    const float gh2 = 0.5f * g * h * h;
    if (f == 1) {
      const float u = hu / h;
      F = hu * u + gh2, G = hu * v;
    } else {
      F = hu * v, G = hv * v + gh2;
    }
  }
  p = rx * F + ry * G;
  s = sx * F + sy * G;
}

// NP > 0: np = NP, the sums of a thread's whole group in registers; NP =
// 0: any np, the sums in blocks of 8 nodes. A block owns a run of eb
// elements and takes it in chunks of ec = blockDim.x / 3.
template <int NP>
__global__ void __launch_bounds__(3 * VOL_EC, VOL_MINB) dg_volume_kernel(
    const float* __restrict__ q, const float* __restrict__ geom, const float* __restrict__ db,
    const float* __restrict__ dr, const float* __restrict__ ds, float* __restrict__ out,
    int E, int np_rt, int eb, float g) {
  constexpr bool GEN = NP == 0;
  constexpr int NB = GEN ? 8 : (NP + 2) / 3;   // nodes whose sums a thread holds at a time
  const int np = GEN ? np_rt : NP;
  const int ng = (np + 2) / 3, ngp = vol_ngp(np, GEN);
  const int nt = blockDim.x, ec = nt / 3, t = threadIdx.x;
  const int grp = t / ec, e = t - grp * ec;    // this thread's node group and element
  extern __shared__ __align__(16) float vsm[];
  float* DT = vsm;                                         // (np, 3, 2, ngp)
  float* QS = DT + 6 * np * ngp;                           // q of the chunk
  float* DBS = QS + r4(3 * ec * np + 4);                   // db
  float* GS = DBS + r4(2 * ec * np + 4);                   // geom
  float* PS = GS + 4 * ec + 4;                             // (np, 6, ec)
  float* OS = GEN ? PS + r4(6 * np * ec) : PS;             // outputs

  const int eblk = blockIdx.x * eb, nblk = min(eb, E - eblk);
  for (int c0 = 0; c0 < nblk; c0 += ec) {
    const long long e0 = eblk + c0;
    const int ne = min(ec, nblk - c0);
    const float* qc = q + e0 * np * 3;
    const float* dbc = db + e0 * np * 2;
    const float* gc = geom + e0 * 4;
    stage(QS, qc, ne * np * 3, t, nt);
    stage(DBS, dbc, ne * np * 2, t, nt);
    stage(GS, gc, ne * 4, t, nt);
    repro::cp_commit();
    if (c0 == 0) {                             // Dr, Ds by group, while the copies fly
      for (int i = t; i < 6 * np * ngp; i += nt) {
        const int row = i / ngp, j = i - row * ngp;  // row = (m 3 + group) 2 + (0: Dr, 1: Ds)
        const int m = row / 6, gr = row / 2 - 3 * m, n = gr * ng + j;
        DT[i] = j < ng && n < np ? (row & 1 ? ds : dr)[n * np + m] : 0.f;
      }
    }
    repro::cp_wait<0>();
    __syncthreads();
    const int lq = lead_of(qc), ld = lead_of(dbc), lg = lead_of(gc);
    float* oc = out + e0 * np * 3;
    const int lo = lead_of(oc);

    // 1. the folded fluxes P, S of the three fields at nodes grp, grp + 3,
    // ... of element e
    if (e < ne) {
      const float* ge = GS + lg + 4 * e;
      const float rx = ge[0], sx = ge[1], ry = ge[2], sy = ge[3];
      const float* qe = QS + lq + 3 * e * np;
      for (int m = grp; m < np; m += 3) {
        float* ps = PS + 6 * m * ec + e;
#pragma unroll
        for (int f = 0; f < 3; ++f)
          fold(f, qe + 3 * m, rx, sx, ry, sy, g, ps[f * ec], ps[(3 + f) * ec]);
      }
    }
    __syncthreads();

    // 2. out[n, f] = -(sum_m Dr[n, m] P[m, f] + sum_m Ds[n, m] S[m, f]) + src
    // for the nodes n of this thread's group, each loaded Dr / Ds entry
    // feeding the three fields
    const float* pe = PS + e;                  // P[m, f] at pe[(6 m + f) ec], S at + 3 ec
    for (int j0 = 0; j0 < ng; j0 += NB) {
      float ar[3][NB], as[3][NB];
#pragma unroll
      for (int f = 0; f < 3; ++f)
#pragma unroll
        for (int j = 0; j < NB; ++j) ar[f][j] = as[f][j] = 0.f;
      if (e < ne) {
#pragma unroll(GEN ? 1 : NP)
        for (int m = 0; m < np; ++m) {
          float p[3], s[3];
#pragma unroll
          for (int f = 0; f < 3; ++f) p[f] = pe[(6 * m + f) * ec], s[f] = pe[(6 * m + 3 + f) * ec];
          const float4* dr4 = reinterpret_cast<const float4*>(DT + (6 * m + 2 * grp) * ngp + j0);
          const float4* ds4 = reinterpret_cast<const float4*>(DT + (6 * m + 2 * grp + 1) * ngp + j0);
#pragma unroll
          for (int j4 = 0; j4 < (NB + 3) / 4; ++j4) {
            const float4 a = dr4[j4], b = ds4[j4];
            const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              if (4 * j4 + c < NB) {
#pragma unroll
                for (int f = 0; f < 3; ++f) {
                  ar[f][4 * j4 + c] = fmaf(av[c], p[f], ar[f][4 * j4 + c]);
                  as[f][4 * j4 + c] = fmaf(bv[c], s[f], as[f][4 * j4 + c]);
                }
              }
            }
          }
        }
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          const int n = grp * ng + j0 + j;
          if (j0 + j >= ng || n >= np) break;
          const int node = e * np + n;
          const float gh = -g * QS[lq + 3 * node];
          ar[0][j] = -(ar[0][j] + as[0][j]) + 0.f;   // S = (0, -g h B_x, -g h B_y)
          ar[1][j] = -(ar[1][j] + as[1][j]) + gh * DBS[ld + 2 * node];
          ar[2][j] = -(ar[2][j] + as[2][j]) + gh * DBS[ld + 2 * node + 1];
        }
      }
      if (!GEN) __syncthreads();               // P/S all read: the outputs go over them
      if (e < ne) {
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          const int n = grp * ng + j0 + j;
          if (j0 + j >= ng || n >= np) break;
#pragma unroll
          for (int f = 0; f < 3; ++f) OS[lo + 3 * (e * np + n) + f] = ar[f][j];
        }
      }
    }
    __syncthreads();
    unstage(oc, OS, ne * np * 3, t, nt);
    __syncthreads();                           // shared memory free for the next chunk
  }
}

template <typename K>
int set_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
}

// elements a chunk: eb, at most VOL_EC, fewer where the block's shared
// memory would pass the card's 227 KB
int vol_chunk(int np, int eb, bool generic) {
  int ec = eb < VOL_EC ? eb : VOL_EC;
  while (ec > 1 && sizeof(float) * vol_smem_floats(np, ec, generic) > 232448) --ec;
  return ec;
}

// one block of 3 ec threads per run of eb elements
template <int NP>
int launch_volume(const float* q, const float* geom, const float* db, const float* dr,
                  const float* ds, float* out, int E, int np, int eb, float g,
                  cudaStream_t s) {
  const int ec = vol_chunk(np, eb, NP == 0);
  const size_t smem = sizeof(float) * vol_smem_floats(np, ec, NP == 0);
  const int err = set_smem(dg_volume_kernel<NP>, smem);
  if (err) return err;
  const int blocks = (E + eb - 1) / eb;
  dg_volume_kernel<NP><<<blocks, 3 * ec, smem, s>>>(q, geom, db, dr, ds, out, E, np, eb, g);
  return static_cast<int>(cudaGetLastError());
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


}  // namespace

// q, out (E, np, 3), geom (E, 4), db (E, np, 2), dr, ds (np, np): f32,
// contiguous. templated = 1 takes the instance of np (np one of 3, 6, 10,
// 15, 21, 28, 36: N = 1..7), templated = 0 the generic one. One block of
// 3 ec threads (ec = vol_chunk(np, eb, !templated)) per run of eb
// elements, with vol_smem_floats(np, ec, !templated) * 4 bytes of shared
// memory.
extern "C" int dg_volume(int templated, const float* q, const float* geom, const float* db,
                         const float* dr, const float* ds, float* out, int E, int np, int eb,
                         float g, void* stream) {
  if (E < 1 || np < 1 || eb < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!templated) return launch_volume<0>(q, geom, db, dr, ds, out, E, np, eb, g, s);
  switch (np) {
    case 3: return launch_volume<3>(q, geom, db, dr, ds, out, E, np, eb, g, s);
    case 6: return launch_volume<6>(q, geom, db, dr, ds, out, E, np, eb, g, s);
    case 10: return launch_volume<10>(q, geom, db, dr, ds, out, E, np, eb, g, s);
    case 15: return launch_volume<15>(q, geom, db, dr, ds, out, E, np, eb, g, s);
    case 21: return launch_volume<21>(q, geom, db, dr, ds, out, E, np, eb, g, s);
    case 28: return launch_volume<28>(q, geom, db, dr, ds, out, E, np, eb, g, s);
    case 36: return launch_volume<36>(q, geom, db, dr, ds, out, E, np, eb, g, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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
