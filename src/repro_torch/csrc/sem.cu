// The spectral-element screened-Coulomb operator (the paper's SEM app) on
// Hopper.
//
// Replaces: src/repro/apps/sem.py:29 sem_builder (the sem_apply op, reached
// through pl.pallas_call at src/repro/core/lang.py:1076).
//
// A u = K u + alpha M u on local dofs: u (E, nq, nq, nq) f32 with u[e][a][b][c]
// (c fastest), geo (E, 7, nq, nq, nq) the six symmetric geometric factors and
// the lumped mass, dmat (nq, nq) the 1-D GLL derivative matrix.
//   ur = D_a u, us = D_b u, ut = D_c u            (3 contractions)
//   [wr ws wt] = G [ur us ut]                    (3x3 symmetric per node)
//   A u = D_a^T wr + D_b^T ws + D_c^T wt + G6 u  (3 transposed contractions)
//
// Bound on the H100: bytes. Per element 9 nq^3 floats cross HBM (u, the 7
// geo fields, the output) for 12 nq^4 + 22 nq^3 FLOPs: 3.4 FLOP/B at nq = 8,
// below the f32 ridge of 20 FLOP/B.
//
// Templated route (nq = 2..10, a template parameter, loops unrolled), after
// the tensor-product kernels of Swirydowicz et al. (IJHPCA 2019, CEED BK5):
//  - Thread (b, c) of an element owns the column u[:, b, c] in registers.
//    ur needs no shared load of u: row a of D comes as 16-byte broadcasts
//    from shared memory. The thread's own rows D[b][:], D[c][:] and
//    columns D[:][b], D[:][c] sit in registers. us reads U[a][m][c] (nq
//    scalar loads a lane group shares), ut the row U[a][b][:] (16-byte
//    loads where nq % 4 == 0). The second stage mirrors the first: the
//    thread keeps its wr column in registers (D^T row a as broadcasts),
//    and only ws and wt go to shared memory.
//    24 nq shared loads a thread an element for the products (192 at nq =
//    8, the parent kernel 6 nq^2 = 384 plus its staging), 8 nq more for
//    its columns of u and geo; every lane group of a warp reads one bank's
//    worth: no bank conflict.
//  - A block holds ez = 128 / nq^2 elements side by side (2 at nq = 8,
//    threads (b, c, z)) and walks its run of eb elements in rounds of ez.
//  - Loads in flight: a three-slot cp.async ring in shared memory. A
//    round's u and geo are two contiguous spans (16-byte copies where nq
//    is even); round k + 2 is issued into the slot round k - 1 left, right
//    after round k's first barrier, so two rounds (16 KB an element) are in
//    flight while one computes; two 107 KB blocks an SM at nq = 8, two
//    barriers a round. (Tried on the card and slower: a register double
//    buffer of 256-thread blocks, one an SM; a two-slot ring of 64, 128 or
//    256 threads.)
//  - au = sr + ss + st + G6 u in that order, as the JAX body adds them.
// Generic route (any other nq <= 24): the parent kernel. Threads follow
// Nekbone: nq x nq threads, thread (b, c) owns the column u[:, b, c] and
// loops over a; u, the three w fields and dmat live in shared memory
// (4 nq^3 + nq^2 floats: nq = 25 would pass the 227 KB a block can have).
// On both routes the last block's ragged run of elements is cut at E.
#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// generic route
// ---------------------------------------------------------------------------

__global__ void sem_generic_kernel(const float* __restrict__ u, const float* __restrict__ geo,
                                   const float* __restrict__ dmat, float* __restrict__ out,
                                   int E, int nq, int eb) {
  extern __shared__ float sm[];
  const int nq2 = nq * nq, nq3 = nq2 * nq;
  float* D = sm;          // (nq, nq)
  float* U = D + nq2;     // (nq, nq, nq)
  float* WR = U + nq3;
  float* WS = WR + nq3;
  float* WT = WS + nq3;
  const int t = threadIdx.x, b = t / nq, c = t - b * nq;
  for (int i = t; i < nq2; i += blockDim.x) D[i] = dmat[i];
  const int e0 = blockIdx.x * eb, e1 = min(e0 + eb, E);
  for (int e = e0; e < e1; ++e) {
    __syncthreads();  // dmat staged; the previous element's reads are done
    const float* ue = u + (long long)e * nq3;
    for (int a = 0; a < nq; ++a) U[a * nq2 + t] = ue[a * nq2 + t];
    __syncthreads();
    const float* g = geo + (long long)e * 7 * nq3;
    for (int a = 0; a < nq; ++a) {
      float ur = 0.f, us = 0.f, ut = 0.f;
      for (int m = 0; m < nq; ++m) {
        ur += D[a * nq + m] * U[m * nq2 + b * nq + c];
        us += D[b * nq + m] * U[a * nq2 + m * nq + c];
        ut += D[c * nq + m] * U[a * nq2 + b * nq + m];
      }
      const int n = a * nq2 + t;
      const float g0 = g[n], g1 = g[nq3 + n], g2 = g[2 * nq3 + n];
      const float g3 = g[3 * nq3 + n], g4 = g[4 * nq3 + n], g5 = g[5 * nq3 + n];
      WR[n] = g0 * ur + g1 * us + g2 * ut;
      WS[n] = g1 * ur + g3 * us + g4 * ut;
      WT[n] = g2 * ur + g4 * us + g5 * ut;
    }
    __syncthreads();
    float* oe = out + (long long)e * nq3;
    for (int a = 0; a < nq; ++a) {
      float sr = 0.f, ss = 0.f, st = 0.f;
      for (int m = 0; m < nq; ++m) {
        sr += D[m * nq + a] * WR[m * nq2 + b * nq + c];
        ss += D[m * nq + b] * WS[a * nq2 + m * nq + c];
        st += D[m * nq + c] * WT[a * nq2 + b * nq + m];
      }
      const int n = a * nq2 + t;
      oe[n] = sr + ss + st + g[6 * nq3 + n] * U[n];
    }
  }
}

// ---------------------------------------------------------------------------
// templated route
// ---------------------------------------------------------------------------

constexpr int SEM_NT = 128;  // threads a block of the templated route, at most

template <int NQ>
struct Sem {
  static constexpr int NQ2 = NQ * NQ, NQ3 = NQ2 * NQ;
  static constexpr int EZ = SEM_NT / NQ2 > 0 ? SEM_NT / NQ2 : 1;  // elements side by side
  static constexpr int NQP = (NQ + 3) & ~3;   // a row of D or D^T, padded to float4s
};

// shared floats of a block with ez elements side by side: D and D^T rows,
// three ring slots of the ez elements' u and geo (8 nq^3 floats each),
// then the slabs WS, WT of each element
template <int NQ>
constexpr int sem_smem_floats(int ez) {
  return 2 * NQ * Sem<NQ>::NQP + 3 * 8 * ez * Sem<NQ>::NQ3 + 2 * ez * Sem<NQ>::NQ3;
}

// sum_m row[m] x[m], the padded shared row read as 16-byte broadcasts
template <int NQ>
__device__ __forceinline__ float dot_bcast(const float* row, const float (&x)[NQ]) {
  float s = 0.f;
#pragma unroll
  for (int m = 0; m < NQ; m += 4) {
    const float4 d = *reinterpret_cast<const float4*>(row + m);
    s = fmaf(d.x, x[m], s);
    if (m + 1 < NQ) s = fmaf(d.y, x[m + 1 < NQ ? m + 1 : 0], s);
    if (m + 2 < NQ) s = fmaf(d.z, x[m + 2 < NQ ? m + 2 : 0], s);
    if (m + 3 < NQ) s = fmaf(d.w, x[m + 3 < NQ ? m + 3 : 0], s);
  }
  return s;
}

// sum_m w[m] S[m] over a contiguous shared row (16-byte loads where nq % 4
// == 0, 8-byte ones where nq is even)
template <int NQ, typename W>
__device__ __forceinline__ float dot_row(const W& w, const float* S) {
  float s = 0.f;
  if constexpr (NQ % 4 == 0) {
#pragma unroll
    for (int m = 0; m < NQ; m += 4) {
      const float4 v = *reinterpret_cast<const float4*>(S + m);
      s = fmaf(w[m], v.x, s);
      s = fmaf(w[m + 1], v.y, s);
      s = fmaf(w[m + 2], v.z, s);
      s = fmaf(w[m + 3], v.w, s);
    }
  } else if constexpr (NQ % 2 == 0) {
#pragma unroll
    for (int m = 0; m < NQ; m += 2) {
      const float2 v = *reinterpret_cast<const float2*>(S + m);
      s = fmaf(w[m], v.x, s);
      s = fmaf(w[m + 1], v.y, s);
    }
  } else {
#pragma unroll
    for (int m = 0; m < NQ; ++m) s = fmaf(w[m], S[m], s);
  }
  return s;
}

// sum_m w[m] S[m * nq] down a column of a shared slab
template <int NQ, typename W>
__device__ __forceinline__ float dot_col(const W& w, const float* S) {
  float s = 0.f;
#pragma unroll
  for (int m = 0; m < NQ; ++m) s = fmaf(w[m], S[m * NQ], s);
  return s;
}

__device__ __forceinline__ uint32_t sptr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// copy round R (elements eR .. min(eR + ez, e1)) of u and geo into a ring
// slot: the u span, then the geo span, 16-byte copies where nq is even
template <int NQ>
__device__ __forceinline__ void issue_round(float* slot, int eR, int e1, int ez,
                                            const float* __restrict__ u,
                                            const float* __restrict__ geo) {
  constexpr int NQ3 = Sem<NQ>::NQ3;
  const int n = min(ez, e1 - eR);
  if (n <= 0) return;
  const int t = threadIdx.x, nt = blockDim.x;
  const float* us = u + (long long)eR * NQ3;
  const float* gs = geo + (long long)eR * 7 * NQ3;
  float* ud = slot;
  float* gd = slot + ez * NQ3;
  if constexpr (NQ3 % 4 == 0) {
    const int nu4 = n * NQ3 / 4, ng4 = 7 * nu4;
    for (int i = t; i < nu4; i += nt) repro::cp16(sptr(ud + 4 * i), us + 4 * i, true);
    for (int i = t; i < ng4; i += nt) repro::cp16(sptr(gd + 4 * i), gs + 4 * i, true);
  } else {
    const int nu1 = n * NQ3, ng1 = 7 * nu1;
    for (int i = t; i < nu1; i += nt) repro::cp4(sptr(ud + i), us + i, true);
    for (int i = t; i < ng1; i += nt) repro::cp4(sptr(gd + i), gs + i, true);
  }
}

// One block of ez * nq^2 threads (ez = min(EZ, eb)) per run of eb
// elements, in rounds of ez elements side by side; round k sits in ring
// slot k % 3.
template <int NQ>
__global__ void __launch_bounds__(Sem<NQ>::EZ * Sem<NQ>::NQ2)
    sem_templated_kernel(const float* __restrict__ u, const float* __restrict__ geo,
                         const float* __restrict__ dmat, float* __restrict__ out, int E,
                         int eb, int ez) {
  using S = Sem<NQ>;
  constexpr int NQ2 = S::NQ2, NQ3 = S::NQ3, NQP = S::NQP;
  extern __shared__ __align__(16) float smt[];
  float* Dp = smt;                        // D rows, padded to NQP (zeros past nq)
  float* DTp = Dp + NQ * NQP;             // D^T rows
  float* ring = DTp + NQ * NQP;           // 3 slots of ez * 8 * NQ3
  const int slot_f = ez * 8 * NQ3;
  const int t = threadIdx.x, z = t / NQ2, p = t - z * NQ2, b = p / NQ, c = p - b * NQ;
  float* WS = ring + 3 * slot_f + z * NQ3;
  float* WT = WS + ez * NQ3;
  const int e0 = blockIdx.x * eb, e1 = min(e0 + eb, E);
  // one commit group a round, empty past the run's end
  issue_round<NQ>(ring, e0, e1, ez, u, geo);
  repro::cp_commit();
  issue_round<NQ>(ring + slot_f, e0 + ez, e1, ez, u, geo);
  repro::cp_commit();
  for (int i = t; i < NQ * NQP; i += blockDim.x) {
    const int r = i / NQP, m = i - r * NQP;
    Dp[i] = m < NQ ? dmat[r * NQ + m] : 0.f;
    DTp[i] = m < NQ ? dmat[m * NQ + r] : 0.f;
  }
  __syncthreads();
  // D[b][:], D[c][:] (first stage) and D[:][b], D[:][c] (second stage)
  float db[NQ], dc[NQ], dtb[NQ], dtc[NQ];
#pragma unroll
  for (int m = 0; m < NQ; ++m) {
    db[m] = Dp[b * NQP + m];
    dc[m] = Dp[c * NQP + m];
    dtb[m] = DTp[b * NQP + m];
    dtc[m] = DTp[c * NQP + m];
  }
#pragma unroll 1
  for (int r0 = e0, k = 0; r0 < e1; r0 += ez, ++k) {
    const int e = r0 + z;
    float* sl = ring + (k % 3) * slot_f;
    const float* U = sl + z * NQ3;
    const float* G = sl + ez * NQ3 + z * 7 * NQ3 + p;
    repro::cp_wait<1>();  // round k has landed (this thread's copies)
    __syncthreads();      // ... and every thread's; every read of WS, WT done
    issue_round<NQ>(ring + ((k + 2) % 3) * slot_f, r0 + 2 * ez, e1, ez, u, geo);
    repro::cp_commit();
    float cu[NQ];
#pragma unroll
    for (int m = 0; m < NQ; ++m) cu[m] = U[m * NQ2 + p];
    float wr[NQ];
#pragma unroll
    for (int a = 0; a < NQ; ++a) {
      const float ur = dot_bcast<NQ>(Dp + a * NQP, cu);
      const float us = dot_col<NQ>(db, U + a * NQ2 + c);
      const float ut = dot_row<NQ>(dc, U + a * NQ2 + b * NQ);
      const float* g = G + a * NQ2;
      const float g0 = g[0], g1 = g[NQ3], g2 = g[2 * NQ3], g3 = g[3 * NQ3], g4 = g[4 * NQ3],
                  g5 = g[5 * NQ3];
      wr[a] = g0 * ur + g1 * us + g2 * ut;
      WS[a * NQ2 + p] = g1 * ur + g3 * us + g4 * ut;
      WT[a * NQ2 + p] = g2 * ur + g4 * us + g5 * ut;
    }
    __syncthreads();  // WS, WT complete
    if (e < e1) {
      float* oe = out + (long long)e * NQ3 + p;
#pragma unroll
      for (int a = 0; a < NQ; ++a) {
        const float sr = dot_bcast<NQ>(DTp + a * NQP, wr);
        const float ss = dot_col<NQ>(dtb, WS + a * NQ2 + c);
        const float st = dot_row<NQ>(dtc, WT + a * NQ2 + b * NQ);
        oe[a * NQ2] = sr + ss + st + G[6 * NQ3 + a * NQ2] * cu[a];
      }
    }
  }
  repro::cp_wait<0>();  // drain the empty groups
}

template <typename K>
int set_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
}

template <int NQ>
int launch_templated(const float* u, const float* geo, const float* dmat, float* out, int E,
                     int eb, cudaStream_t s) {
  const int ez = eb < Sem<NQ>::EZ ? eb : Sem<NQ>::EZ;
  const size_t smem = sizeof(float) * sem_smem_floats<NQ>(ez);
  const int err = set_smem(sem_templated_kernel<NQ>, smem);
  if (err) return err;
  const int blocks = (E + eb - 1) / eb;
  sem_templated_kernel<NQ><<<blocks, ez * Sem<NQ>::NQ2, smem, s>>>(u, geo, dmat, out, E, eb, ez);
  return static_cast<int>(cudaGetLastError());
}

int launch_generic(const float* u, const float* geo, const float* dmat, float* out, int E,
                   int nq, int eb, cudaStream_t s) {
  const size_t smem = sizeof(float) * ((size_t)nq * nq + 4 * (size_t)nq * nq * nq);
  const int err = set_smem(sem_generic_kernel, smem);
  if (err) return err;
  const int blocks = (E + eb - 1) / eb;
  sem_generic_kernel<<<blocks, nq * nq, smem, s>>>(u, geo, dmat, out, E, nq, eb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// u, out (E, nq, nq, nq), geo (E, 7, nq, nq, nq), dmat (nq, nq): f32,
// contiguous. templated = 1 takes the instance of nq (2..10), templated = 0
// the generic kernel (nq <= 24): the wrapper picks up front (sem_route).
extern "C" int sem_apply(int templated, const float* u, const float* geo, const float* dmat,
                         float* out, int E, int nq, int eb, void* stream) {
  if (E < 1 || nq < 1 || nq > 24 || eb < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!templated) return launch_generic(u, geo, dmat, out, E, nq, eb, s);
  switch (nq) {
    case 2: return launch_templated<2>(u, geo, dmat, out, E, eb, s);
    case 3: return launch_templated<3>(u, geo, dmat, out, E, eb, s);
    case 4: return launch_templated<4>(u, geo, dmat, out, E, eb, s);
    case 5: return launch_templated<5>(u, geo, dmat, out, E, eb, s);
    case 6: return launch_templated<6>(u, geo, dmat, out, E, eb, s);
    case 7: return launch_templated<7>(u, geo, dmat, out, E, eb, s);
    case 8: return launch_templated<8>(u, geo, dmat, out, E, eb, s);
    case 9: return launch_templated<9>(u, geo, dmat, out, E, eb, s);
    case 10: return launch_templated<10>(u, geo, dmat, out, E, eb, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
