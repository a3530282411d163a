// Blocked matrix product C = A B for Hopper, with an f32 accumulator.
//
// Replaces: src/repro/kernels/matmul/kernel.py:20 matmul_builder (reached
// through pl.pallas_call at src/repro/core/lang.py:1076).
//
// a (M, K) and b (K, N) in f32 or bf16 (the same type), c (M, N) in f32 or
// bf16 (out_dtype): every product is formed and summed in f32 over K and the
// sum is rounded once to c's type, as the TPU kernel's f32 scratch
// accumulator is flushed on the last K step.
//
// Bound on the H100: operations, 2 M N K FLOPs at the bf16 tensor-core peak
// (989 TFLOP/s): 4096 x 2048 @ 2048 x 8192 in bf16 is 137 GFLOP against
// 0.1 GB of operands and result, ~1400 operations a byte, so 0.139 ms.
//
// Two routes, chosen by the wrapper up front from dtype and layout:
// * matmul_tc, the tensor-core route (bf16 a and b with TMA-aligned rows):
//   the mainloop of gemm_sm90.cuh, a K-major and b N-major (wgmma reads b
//   through its transpose bit), 128 x 256 output tiles, a ring of 4 stages of
//   64-deep TMA loads, two consumer warpgroups on wgmma.m64n256k16; the
//   epilogue rounds the f32 accumulator once into c. What the design does
//   about the bound: every FLOP runs on the tensor cores, the loads are
//   TMA's (no thread spends an instruction on an address), and the blocks in
//   flight share their operand panels through L2.
// * matmul, the CUDA-core route (f32 operands: TF32 would change an f32
//   product's numbers; and bf16 operands TMA cannot read): the classic
//   shared-memory SGEMM. The TPU grid's sequential K axis becomes a loop
//   inside the block; one block of 256 threads owns a 128 x 128 tile of C
//   and walks K in slices of 8, staging the A slice (transposed) and the B
//   slice in shared memory as f32; each thread keeps an 8 x 8 block of C in
//   registers (rows ty + 16 i, columns tx + 16 j), 64 FMAs for every 16
//   shared-memory loads. Ragged M, N and K are masked on load and store
//   (the TPU version fits its blocks to divisors instead).
#include "common.cuh"
#include "gemm_sm90.cuh"

namespace {

constexpr int BM = 128, BN = 128, BK = 8;
constexpr int NT = 256;  // 16 x 16 threads, each an 8 x 8 block of C
constexpr int TM = BM / 16, TN = BN / 16;

template <typename TI, typename TO>
__global__ void __launch_bounds__(NT) matmul_kernel(
    const TI* __restrict__ a, const TI* __restrict__ b, TO* __restrict__ c, int M,
    int N, int K, long long lda, long long ldb) {
  __shared__ float as[BK][BM];  // as[kk][m] = a[row0 + m, k0 + kk]
  __shared__ float bs[BK][BN];  // bs[kk][n] = b[k0 + kk, col0 + n]
  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // A slice: BM x BK, 4 elements a thread, the 8 of a row read together
#pragma unroll
    for (int e = t; e < BM * BK; e += NT) {
      const int m = e / BK, kk = e % BK;
      const int gm = row0 + m, gk = k0 + kk;
      as[kk][m] = (gm < M && gk < K) ? repro::to_f32(a[gm * lda + gk]) : 0.f;
    }
    // B slice: BK x BN, 4 elements a thread, coalesced along N
#pragma unroll
    for (int e = t; e < BK * BN; e += NT) {
      const int kk = e / BN, n = e % BN;
      const int gk = k0 + kk, gn = col0 + n;
      bs[kk][n] = (gk < K && gn < N) ? repro::to_f32(b[gk * ldb + gn]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float ra[TM], rb[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) ra[i] = as[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) rb[j] = bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += ra[i] * rb[j];
    }
    __syncthreads();  // the slice's readers are done before it is replaced
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = row0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = col0 + tx + 16 * j;
      if (gn < N) c[(long long)gm * N + gn] = repro::from_f32<TO>(acc[i][j]);
    }
  }
}

template <typename TI, typename TO>
void launch(const void* a, const void* b, void* c, int M, int N, int K,
            long long lda, long long ldb, cudaStream_t s) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  matmul_kernel<TI, TO><<<grid, NT, 0, s>>>(static_cast<const TI*>(a),
                                            static_cast<const TI*>(b),
                                            static_cast<TO*>(c), M, N, K, lda, ldb);
}

}  // namespace

// in_dtype, out_dtype: 0 = float32, 1 = bfloat16. a (M, K) and b (K, N) are
// row-major with leading (row) strides lda and ldb in elements; c is
// contiguous (M, N). M, N, K >= 1.
extern "C" int matmul(const void* a, const void* b, void* c, int M, int N, int K,
                      int in_dtype, int out_dtype, long long lda, long long ldb,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0 && out_dtype == 0)
    launch<float, float>(a, b, c, M, N, K, lda, ldb, s);
  else if (in_dtype == 0 && out_dtype == 1)
    launch<float, __nv_bfloat16>(a, b, c, M, N, K, lda, ldb, s);
  else if (in_dtype == 1 && out_dtype == 0)
    launch<__nv_bfloat16, float>(a, b, c, M, N, K, lda, ldb, s);
  else if (in_dtype == 1 && out_dtype == 1)
    launch<__nv_bfloat16, __nv_bfloat16>(a, b, c, M, N, K, lda, ldb, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// The tensor-core route: a (M, K) and b (K, N) bf16, rows contiguous with
// leading strides lda and ldb (multiples of 8 elements, 16-byte aligned
// bases); c contiguous (M, N), out_dtype 0 = float32, 1 = bfloat16.
extern "C" int matmul_tc(const void* a, const void* b, void* c, int M, int N, int K,
                         int out_dtype, long long lda, long long ldb, void* stream) {
  namespace g = repro::sm90;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CUtensorMap ta, tb;
  cudaError_t e = g::operand_map(&ta, a, K, M, lda, false, g::BM);
  if (e == cudaSuccess) e = g::operand_map(&tb, b, N, K, ldb, true, g::BN);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (out_dtype == 0)
    e = g::gemm<false, true, 1>(ta, ta, tb, M, N, K,
                                g::StoreEpi<float>{static_cast<float*>(c), N, 1, M, N}, s);
  else if (out_dtype == 1)
    e = g::gemm<false, true, 1>(
        ta, ta, tb, M, N, K,
        g::StoreEpi<__nv_bfloat16>{static_cast<__nv_bfloat16*>(c), N, 1, M, N}, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
