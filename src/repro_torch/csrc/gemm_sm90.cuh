// A Hopper GEMM mainloop: a ring of TMA-loaded shared-memory stages feeding
// wgmma, bf16 operands, f32 accumulators, written in raw PTX.
//
// C (M, N) = sum over planes p of A_p (M, K) . B (K, N), handed to an
// epilogue functor as each thread's accumulator fragment. Used by matmul.cu
// (one plane), by lm_head_ce.cu (one plane for the forward and the
// backward's logits recompute, two for the hi/lo bf16 split of the f32 dl)
// and by lm_head.cu's decode head (one plane, A = the head's vocab rows,
// B = the few decode rows in a narrow tile).
//
// Block: 3 warpgroups. Warpgroups 0 and 1 each own 64 rows of the
// BM x TN = 128 x 256 output tile and issue wgmma.m64n256k16 (128 f32
// accumulators a thread; TN = 128 and m64n128k16 where the accumulator is
// promoted, see gemm_kernel; TN = 64, 16 or 8 for narrow products); one
// thread of warpgroup 2 keeps the ring of 3-4 stages (up to 8 for TN <= 64)
// full with cp.async.bulk.tensor loads, 64 deep in K, behind a full and an
// empty mbarrier per stage. setmaxnreg moves registers from the loader to
// the two consumers.
//
// Operand layouts are template parameters. A K-major operand (K contiguous
// in memory) is loaded as one box of 64 K x rows; an MN-major operand (M or
// N contiguous) as boxes of 64 MN x 64 K, and wgmma reads it through its
// transpose bit. Both with the 128-byte swizzle, which the wgmma descriptor
// names (layout type 1): K-major SBO = 1024 bytes between 8-row groups;
// MN-major LBO = 8 KB between 64-wide MN chunks (one box), SBO = 1024 bytes
// between groups of 8 K rows. Each plane of A meets the same B tile, so B is
// loaded once per stage whatever the plane count.
//
// Ragged edges: TMA zero-fills what lies outside the tensor (M, N and K), so
// the products there are 0; the epilogue masks its stores. No atomics and no
// split-K: every output is summed by one warpgroup in one fixed order.
//
// Tensor maps are encoded on the host (make_map) through
// cudaGetDriverEntryPoint, so the libraries link no -lcuda; they reach the
// kernel as __grid_constant__ parameters.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only)

#include "common.cuh"

namespace repro {
namespace sm90 {

constexpr int BM = 128, BK = 64;
constexpr int BN = 256;                      // the default tile width
constexpr int CONSUMERS = 2;                 // warpgroups of 64 rows each
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int A_TILE = BM * BK * 2;          // bytes of one A plane's stage
constexpr int BOX = 64 * 64 * 2;             // one MN-major box, 64 x 64

// A stage holds PLANES A tiles and one B tile of TN columns; as many stages
// as fit in 220 KB of shared memory, at most 4, or 8 for a narrow B tile
// (TN <= 64: the LM head's decode rows), where a block's products are too
// few to hide a load and only bytes in flight keep HBM streaming.
template <int PLANES, int TN>
struct Ring {
  static constexpr int STAGE_BYTES = PLANES * A_TILE + TN * BK * 2;
  static constexpr int FIT = 220 * 1024 / STAGE_BYTES;
  static constexpr int CAP = TN <= 64 ? 8 : 4;
  static constexpr int STAGES = FIT < CAP ? FIT : CAP;
  static constexpr int SMEM = STAGES * STAGE_BYTES + 1024;  // + alignment
};

// ---------------------------------------------------------------------------
// PTX wrappers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Spin until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// One 2-D box at (c0 inner, c1 outer) into shared memory, completing on bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// A wgmma shared-memory descriptor with the 128-byte swizzle.
__device__ __forceinline__ uint64_t desc(uint32_t saddr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((saddr >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (64 x 256 f32, this warpgroup's fragment) += A (64 x 16) . B (16 x 256);
// TA / TB: 0 = K-major, 1 = MN-major (the transpose bits).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, "
      "%123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]),
        "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]),
        "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
        "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]),
        "+f"(d[127])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n16k16(float (&d)[8], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, %11, %12;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n8k16(float (&d)[4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3}, %4, %5, p, 1, 1, %7, %8;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// The tile widths the mainloop takes: 256 and 128 for the products of
// matmul and the CE head, 64, 16 and 8 for the decode LM head's rows.
template <int TN>
constexpr bool tile_width_ok() {
  return TN == 256 || TN == 128 || TN == 64 || TN == 16 || TN == 8;
}

// d (64 x TN) += A (64 x 16) . B (16 x TN) for a tile width of tile_width_ok.
template <int TN, int TA, int TB>
__device__ __forceinline__ void wgmma_tile(float (&d)[TN / 2], uint64_t da, uint64_t db) {
  if constexpr (TN == 256)
    wgmma_m64n256k16<TA, TB>(d, da, db);
  else if constexpr (TN == 128)
    wgmma_m64n128k16<TA, TB>(d, da, db);
  else if constexpr (TN == 64)
    wgmma_m64n64k16<TA, TB>(d, da, db);
  else if constexpr (TN == 16)
    wgmma_m64n16k16<TA, TB>(d, da, db);
  else
    wgmma_m64n8k16<TA, TB>(d, da, db);
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

// The accumulator fragment a thread hands its epilogue: element i of acc
// lies at row r0 + 8 * ((i >> 1) & 1), column c0 + 8 * (i >> 2) + (i & 1)
// (the m64nNk16 D layout: warp w of the warpgroup holds rows 16 w .. 16 w +
// 15, lane l rows l / 4 and l / 4 + 8, columns 2 (l % 4) + {0, 1} of every
// 8-column group). The epilogue is called as epi(acc, r0, c0) and masks
// rows >= M and columns >= N itself.
//
// PROMOTE > 0 folds the wgmma accumulator into a second, f32 one every
// PROMOTE k-tiles (and at the end) with ordinary round-to-nearest adds, and
// hands the epilogue that one. The tensor cores add each k16 step into the
// accumulator with truncation, so over a long K (the CE backward's dx sums
// V = 128256 terms) the accumulator drifts by up to one of its ulps a step;
// a fresh accumulator per chunk keeps that drift to PROMOTE * 4 * PLANES
// steps of the chunk's own partial sum. It needs TN / 2 more registers a
// thread, so it goes with TN = 128.
template <bool A_MN, bool B_MN, int PLANES, int TN, int PROMOTE, class Epi>
__global__ void __launch_bounds__(THREADS, 1)
    gemm_kernel(const __grid_constant__ CUtensorMap tmA0,
                const __grid_constant__ CUtensorMap tmA1,
                const __grid_constant__ CUtensorMap tmB, int K, int m_fast, Epi epi) {
  using R = Ring<PLANES, TN>;
  constexpr int NACC = TN / 2;
  __shared__ __align__(8) uint64_t full[R::STAGES], empty[R::STAGES];
  extern __shared__ uint8_t smem_raw[];
  // tiles start on 1024-byte boundaries: the swizzle repeats every 8 rows of
  // 128 bytes, and the wgmma descriptors assume that phase
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);

  const int mt = m_fast ? blockIdx.x : blockIdx.y;
  const int nt = m_fast ? blockIdx.y : blockIdx.x;
  const int m0 = mt * BM, n0 = nt * TN;
  const int KT = (K + BK - 1) / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < R::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == CONSUMERS) {  // the loader warpgroup: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == CONSUMERS * 128) {
      for (int kt = 0, s = 0, ph = 0; kt < KT; ++kt) {
        mbar_wait(&empty[s], ph ^ 1);  // the first pass finds every stage free
        uint8_t* st = smem + s * R::STAGE_BYTES;
        mbar_expect_tx(&full[s], R::STAGE_BYTES);
        const int k0 = kt * BK;
#pragma unroll
        for (int p = 0; p < PLANES; ++p) {
          const CUtensorMap* tm = p ? &tmA1 : &tmA0;
          uint8_t* a = st + p * A_TILE;
          if (A_MN) {
#pragma unroll
            for (int j = 0; j < BM / 64; ++j) tma_load(a + j * BOX, tm, &full[s], m0 + 64 * j, k0);
          } else {
            tma_load(a, tm, &full[s], k0, m0);
          }
        }
        uint8_t* b = st + PLANES * A_TILE;
        if (B_MN) {
#pragma unroll
          for (int j = 0; j < TN / 64; ++j) tma_load(b + j * BOX, &tmB, &full[s], n0 + 64 * j, k0);
        } else {
          tma_load(b, &tmB, &full[s], k0, n0);
        }
        if (++s == R::STAGES) {
          s = 0;
          ph ^= 1;
        }
      }
    }
  } else {  // the two consumer warpgroups
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    float acc[NACC], master[PROMOTE ? NACC : 1];
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
    if constexpr (PROMOTE > 0) {
#pragma unroll
      for (int i = 0; i < NACC; ++i) master[i] = 0.f;
    }
    const bool lead = threadIdx.x % 128 == 0;
    int prev = -1;  // the stage whose products may still be in flight
    for (int kt = 0, s = 0, ph = 0; kt < KT; ++kt) {
      mbar_wait(&full[s], ph);
      const uint32_t st = smem_u32(smem + s * R::STAGE_BYTES);
      const uint32_t b = st + PLANES * A_TILE;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        // 16 K: 32 bytes along a K-major row, 16 rows of 128 bytes MN-major
        const uint64_t db = B_MN ? desc(b + kk * 2048, BOX, 1024) : desc(b + kk * 32, 16, 1024);
#pragma unroll
        for (int p = 0; p < PLANES; ++p) {
          const uint32_t a = st + p * A_TILE;
          const uint64_t da = A_MN ? desc(a + wg * BOX + kk * 2048, BOX, 1024)
                                   : desc(a + wg * 64 * 128 + kk * 32, 16, 1024);
          wgmma_tile<TN, A_MN ? 1 : 0, B_MN ? 1 : 0>(acc, da, db);
        }
      }
      wgmma_commit();
      bool folded = false;
      if constexpr (PROMOTE > 0) {
        if ((kt + 1) % PROMOTE == 0 || kt + 1 == KT) {
          // the chunk is done: both stages go back, its partial into master
          wgmma_wait<0>();
          if (lead) {
            if (prev >= 0) mbar_arrive(&empty[prev]);
            mbar_arrive(&empty[s]);
          }
          prev = -1;
#pragma unroll
          for (int i = 0; i < NACC; ++i) {
            master[i] += acc[i];
            acc[i] = 0.f;
          }
          folded = true;
        }
      }
      if (!folded) {
        // keep this tile's products in flight; the previous tile's are
        // done, so its stage goes back to the loader
        wgmma_wait<1>();
        if (lead && prev >= 0) mbar_arrive(&empty[prev]);
        prev = s;
      }
      if (++s == R::STAGES) {
        s = 0;
        ph ^= 1;
      }
    }
    wgmma_wait<0>();
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int r0 = m0 + wg * 64 + warp * 16 + lane / 4, c0 = n0 + 2 * (lane % 4);
    if constexpr (PROMOTE > 0)
      epi(master, r0, c0);
    else
      epi(acc, r0, c0);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime has loaded (no -lcuda).
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A tensor map over a bf16 matrix of `rows` rows of `cols` contiguous
// elements, `ld` elements apart, cut into boxes of box_cols x box_rows with
// the 128-byte swizzle (box_cols = 64: one swizzle row). TMA wants the base
// 16-byte aligned and ld a multiple of 8; the wrappers route anything else
// to the CUDA-core kernels.
inline cudaError_t make_map(CUtensorMap* map, const void* ptr, long long cols, long long rows,
                            long long ld, int box_cols, int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The map of an operand as the kernel loads it: K-major, one box of 64 K x
// `tile_rows` (BM for A, the tile width for B); MN-major, boxes of 64 x 64.
inline cudaError_t operand_map(CUtensorMap* map, const void* ptr, long long cols,
                               long long rows, long long ld, bool mn_major, int tile_rows) {
  return make_map(map, ptr, cols, rows, ld, 64, mn_major ? 64 : tile_rows);
}

// Launch C = sum_p A_p . B over (M, N, K) on stream s, in BM x TN tiles.
// The grid walks the dimension with fewer tiles fastest, so the blocks in
// flight share the other operand's panels through L2.
template <bool A_MN, bool B_MN, int PLANES, int TN = BN, int PROMOTE = 0, class Epi>
cudaError_t gemm(const CUtensorMap& a0, const CUtensorMap& a1, const CUtensorMap& b, int M,
                 int N, int K, const Epi& epi, cudaStream_t s) {
  static_assert(tile_width_ok<TN>(), "tiles are 128 x 256, 128, 64, 16 or 8");
  static_assert(!B_MN || TN >= 64, "an MN-major B tile is boxes of 64 columns");
  static_assert(PROMOTE == 0 || TN == 128, "a promoted accumulator fits only TN = 128");
  auto kern = gemm_kernel<A_MN, B_MN, PLANES, TN, PROMOTE, Epi>;
  const int smem = Ring<PLANES, TN>::SMEM;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const int mt = (M + BM - 1) / BM, nt = (N + TN - 1) / TN;
  const int m_fast = mt <= nt;
  const dim3 grid(m_fast ? mt : nt, m_fast ? nt : mt);
  if (grid.y > 65535) return cudaErrorInvalidConfiguration;
  kern<<<grid, THREADS, smem, s>>>(a0, a1, b, K, m_fast, epi);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// a plain store epilogue
// ---------------------------------------------------------------------------

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// C[r * sr + c * sc] = acc rounded once to T, for r < M and c < N.
template <typename T>
struct StoreEpi {
  T* c;
  long long sr, sc;
  int M, N;

  template <int NF>
  __device__ __forceinline__ void operator()(const float (&acc)[NF], int r0, int c0) const {
    const bool pairs =
        sc == 1 && sr % 2 == 0 && reinterpret_cast<uintptr_t>(c) % (2 * sizeof(T)) == 0;
#pragma unroll
    for (int i = 0; i < NF; i += 2) {
      const int r = r0 + 8 * ((i >> 1) & 1), col = c0 + 8 * (i >> 2);
      if (r >= M || col >= N) continue;
      T* p = c + r * sr + col * sc;
      if (pairs && col + 1 < N) {
        store2(p, acc[i], acc[i + 1]);
      } else {
        p[0] = from_f32<T>(acc[i]);
        if (col + 1 < N) p[sc] = from_f32<T>(acc[i + 1]);
      }
    }
  }
};

}  // namespace sm90
}  // namespace repro
