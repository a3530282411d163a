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
// below the f32 ridge of 20 FLOP/B. What the design does about it: each
// element's u, the three w fields and dmat live in shared memory
// (4 nq^3 + nq^2 floats, 8.4 KB at nq = 8), so every HBM byte is read once;
// geo is read once, coalesced, straight into registers. Threads follow
// Nekbone: nq x nq threads, thread (b, c) owns the column u[:, b, c] and
// loops over a, so nq <= 24 fits (the shared memory of nq = 25 exceeds the
// 227 KB a block can have). A block applies the operator to `eb` consecutive
// elements one after another (the TPU's sequential grid step becomes the
// block's loop); the last block's ragged run is cut at E.
#include "common.cuh"

namespace {

__global__ void sem_kernel(const float* __restrict__ u, const float* __restrict__ geo,
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

}  // namespace

// u, out (E, nq, nq, nq), geo (E, 7, nq, nq, nq), dmat (nq, nq): f32,
// contiguous. One block of nq * nq threads per run of eb elements, with
// (nq^2 + 4 nq^3) * 4 bytes of shared memory: nq <= 24.
extern "C" int sem_apply(const float* u, const float* geo, const float* dmat, float* out,
                         int E, int nq, int eb, void* stream) {
  if (E < 1 || nq < 1 || nq > 24 || eb < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * ((size_t)nq * nq + 4 * (size_t)nq * nq * nq);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int blocks = (E + eb - 1) / eb;
  sem_kernel<<<blocks, nq * nq, smem, static_cast<cudaStream_t>(stream)>>>(u, geo, dmat, out,
                                                                          E, nq, eb);
  return static_cast<int>(cudaGetLastError());
}
