// Shared pieces of the tensor-core attention kernels: the forward of
// attn_fwd_sm90.cuh (flash_fwd.cu's flash_fwd_tc, ring_flash.cu's
// ring_flash_fwd_tc) and the backward of attn_bwd_sm90.cuh (flash_bwd.cu's
// flash_bwd_tc, ring_flash.cu's ring_flash_bwd_tc), with the masks and the
// offset types they share. bf16 operands, f32 accumulators, every product
// on wgmma.
//
// Tiles: a tile of ROWS rows x D bf16 columns (one row of q, k, v or do per
// sequence position) sits in shared memory as DP / 64 boxes of ROWS x 64
// columns (DP = max(D, 64)), each row of a box one 128-byte line whose
// 16-byte chunks are XOR-swizzled by the row's index mod 8: the layout TMA
// writes with the 128-byte swizzle, and the one wgmma's descriptors name
// (layout type 1, gemm_sm90.cuh). It serves both operand majors:
//  - K-major (rows = M or N, columns = K = d): the k16 step kk starts at box
//    kk / 4, 32 bytes into the line times kk % 4; SBO 1024 (8 lines);
//  - MN-major (rows = K, columns = N = d, read through the transpose bit):
//    the k16 step starts 16 lines in, LBO = one box (the next 64 columns),
//    SBO 1024.
// Tiles are copied with cp.async, 16 bytes a thread, straight from the
// strided (batch, head, sequence) layout of the projections, so any input
// whose base and strides but the last are multiples of 16 bytes loads
// without a copy (the wrappers route anything else to the CUDA-core
// kernels). Rows past the sequence are zero-filled. At D = 32 the boxes
// are half used: a K-major read stops at K = D, and an MN-major B read
// over N = 64 fills accumulator columns D..63 that nobody stores. At
// D = 112 (zamba2) a row is 14 chunks: the tile is two boxes (DP = 128)
// and each load zero-fills the row's last two chunks, so an MN-major B
// read over N = 128 adds zeros into accumulator columns 112..127, which
// nobody stores either.
//
// Register fragments: wgmma's f32 accumulator of m64nNk16 puts element i of
// a thread at row 16 warp + lane / 4 + 8 ((i >> 1) & 1), column
// 8 (i >> 2) + 2 (lane % 4) + (i & 1). Elements 8t .. 8t + 7 are then, in
// order, the A fragment of the k16 step t of a register-A (RS) wgmma
// (rows r, r + 8 x columns 16t + 2 (lane % 4) + {0, 1} and 16t + 8 + ...),
// so a score tile turns into the A operand of the next product by packing
// pairs into bf16x2.
#pragma once

#include "gemm_sm90.cuh"

namespace repro {
namespace attn {

using sm90::desc;
using sm90::smem_u32;
using sm90::wgmma_commit;
using sm90::wgmma_fence;
using sm90::wgmma_wait;
using repro::cp16;       // the cp.async copies live in common.cuh
using repro::cp4;
using repro::cp_commit;
using repro::cp_wait;

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

constexpr int NT = 128;  // a block is one warpgroup

// 2^x in one MUFU.EX2 (relative error ~2^-22; results under 2^-126 flush
// to 0, and 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int ROWS, int D>
struct Tile {
  static constexpr int DP = (D + 63) / 64 * 64;  // columns as stored
  static constexpr int BOX = ROWS * 128;       // bytes of one 64-column box
  static constexpr int BYTES = (DP / 64) * BOX;
};

// make this thread's completed cp.async writes visible to wgmma's (async
// proxy) reads; a barrier after it publishes every thread's
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Rows [0, ROWS) of a bf16 matrix whose row r starts at base + r * stride
// (elements, D contiguous) into the swizzled tile at s; rows >= nvalid are
// zero-filled, and so are the chunks past D of a box a row fills in part
// (D = 112). NT threads take 16-byte chunks in turn.
template <int ROWS, int D, int NT>
__device__ __forceinline__ void load_tile(uint32_t s, const __nv_bfloat16* base,
                                          long long stride, int nvalid, int tid) {
  constexpr int CPR = D / 8;  // chunks per row
  static_assert(ROWS * CPR % NT == 0, "every thread copies as many chunks");
#pragma unroll
  for (int j = 0; j < ROWS * CPR / NT; ++j) {
    const int e = tid + j * NT, r = e / CPR, c = e % CPR;
    const bool ok = r < nvalid;
    const __nv_bfloat16* src = ok ? base + r * stride + c * 8 : base;
    cp16(s + (c >> 3) * Tile<ROWS, D>::BOX + r * 128 + (((c & 7) ^ (r & 7)) << 4), src, ok);
  }
  if constexpr (D > 64 && D % 64 != 0) {
    constexpr int PAD = Tile<ROWS, D>::DP / 8 - CPR;  // chunks of zeros a row
    static_assert(ROWS * PAD % NT == 0, "every thread zeroes as many chunks");
#pragma unroll
    for (int j = 0; j < ROWS * PAD / NT; ++j) {
      const int e = tid + j * NT, r = e / PAD, c = CPR + e % PAD;
      cp16(s + (c >> 3) * Tile<ROWS, D>::BOX + r * 128 + (((c & 7) ^ (r & 7)) << 4), base,
           false);
    }
  }
}

// ---------------------------------------------------------------------------
// descriptors of a Tile<ROWS, D> at s
// ---------------------------------------------------------------------------

// K-major, the k16 step kk of the 64 rows starting at row r0 (a multiple of 8)
template <int ROWS, int D>
__device__ __forceinline__ uint64_t kmajor(uint32_t s, int r0, int kk) {
  return desc(s + (kk >> 2) * Tile<ROWS, D>::BOX + r0 * 128 + (kk & 3) * 32, 16, 1024);
}

// MN-major (rows are K), the k16 step kk: rows 16 kk .. 16 kk + 15
template <int ROWS, int D>
__device__ __forceinline__ uint64_t mnmajor(uint32_t s, int kk) {
  return desc(s + kk * 16 * 128, Tile<ROWS, D>::BOX, 1024);
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// d (64 x 32 f32) += A (64 x 16) . B (16 x 32), both from shared memory,
// both K-major.
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 64 f32) += A (64 x 16) . B (16 x 64), both from shared memory,
// both K-major.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 64 f32) += A (64 x 16, bf16 fragments in registers) . B (16 x 64),
// B from shared memory MN-major (read through the transpose bit).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128 f32) += A (64 x 16, bf16 fragments in registers) . B (16 x 128),
// B from shared memory MN-major (read through the transpose bit).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x N) += A (64 x 16) . B (16 x N), both K-major, for N = 32, 64 or
// 128
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db) {
  if constexpr (N == 128)
    sm90::wgmma_m64n128k16<0, 0>(d, da, db);
  else if constexpr (N == 64)
    wgmma_ss_n64(d, da, db);
  else
    wgmma_ss_n32(d, da, db);
}

// d (64 x N) += A (64 x 16, registers) . B (16 x N, MN-major) for N = DP
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 128)
    wgmma_rs_n128(d, a, db);
  else
    wgmma_rs_n64(d, a, db);
}

// Keep the compiler from moving reads or writes of registers that an
// in-flight wgmma owns (its accumulator, its register A operand) across the
// wgmma_wait that ends it: the empty asm "redefines" them at this point.
template <int N>
__device__ __forceinline__ void hold(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void hold(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// ---------------------------------------------------------------------------
// fragments
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// The A fragments of a 64 x N f32 tile in accumulator layout (N / 16 k16
// steps), rounded once.
template <int N>
__device__ __forceinline__ void to_frags(const float (&x)[N / 2], uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int t = 0; t < N / 16; ++t)
#pragma unroll
    for (int j = 0; j < 4; ++j) a[t][j] = pack_bf16(x[8 * t + 2 * j], x[8 * t + 2 * j + 1]);
}

// The same as two planes, hi = bf16(x) and lo = bf16(x - hi): hi + lo holds
// x to 2^-16 of |x|, where hi alone holds it to 2^-9.
template <int N>
__device__ __forceinline__ void to_frags_hi_lo(const float (&x)[N / 2], uint32_t (&hi)[N / 16][4],
                                               uint32_t (&lo)[N / 16][4]) {
#pragma unroll
  for (int t = 0; t < N / 16; ++t)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float a = x[8 * t + 2 * j], b = x[8 * t + 2 * j + 1];
      const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
      hi[t][j] = *reinterpret_cast<const uint32_t*>(&h);
      lo[t][j] = pack_bf16(a - __low2float(h), b - __high2float(h));
    }
}

// Row (0 or 1: lane / 4 or lane / 4 + 8 of the warp's 16) and column of
// accumulator element i of a thread
__device__ __forceinline__ int frag_row(int i) { return (i >> 1) & 1; }
__device__ __forceinline__ int frag_col(int i, int lane) {
  return 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
}

// ---------------------------------------------------------------------------
// positions and masks (the JAX _mask_block, kernel.py:145), shared by the
// forward (attn_fwd_sm90.cuh) and the backward (attn_bwd_sm90.cuh)
// ---------------------------------------------------------------------------

struct Strides {  // element strides of the batch, head and sequence axes
  long long qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os;
};

struct Masks {
  int causal, window, prefix;  // window <= 0: none; prefix <= 0: none
};

__device__ __forceinline__ bool visible(const Masks& mk, int q_pos, int k_pos) {
  if (mk.prefix > 0 && k_pos < mk.prefix) return true;
  return (!mk.causal || k_pos <= q_pos) && (mk.window <= 0 || q_pos - k_pos < mk.window);
}

// The TPU kernel's whole-tile run predicate: may any key in
// [k_first, k_first + nk) be visible to any query in [q_first, q_first + nq)?
__device__ __forceinline__ bool tile_runs(const Masks& mk, int q_first, int nq, int k_first,
                                          int nk) {
  bool run = true;
  if (mk.causal) run &= k_first <= q_first + nq - 1;
  if (mk.window > 0) run &= q_first - (k_first + nk - 1) < mk.window;
  if (mk.prefix > 0) run |= k_first < mk.prefix;
  return run;
}

// May every key in [k_first, k_first + nk) be seen by every query in
// [q_first, q_first + nq)? Then a tile needs no per-element mask.
__device__ __forceinline__ bool tile_full(const Masks& mk, int q_first, int nq, int k_first,
                                          int nk) {
  const int q_last = q_first + nq - 1, k_last = k_first + nk - 1;
  if (mk.prefix > 0 && k_last < mk.prefix) return true;
  return (!mk.causal || k_last <= q_first) && (mk.window <= 0 || q_last - k_first < mk.window);
}

// A ring step's offsets: one int32 each on the device
struct DeviceOffsets {
  const int* q;
  const int* k;
  __device__ __forceinline__ int q_start() const { return *q; }
  __device__ __forceinline__ int k_start() const { return *k; }
};

// Offsets known on the host (flash_fwd_tc, flash_bwd_tc: skv - sq and 0),
// passed by value
struct ValueOffsets {
  int q, k;
  __device__ __forceinline__ int q_start() const { return q; }
  __device__ __forceinline__ int k_start() const { return k; }
};

}  // namespace attn
}  // namespace repro
