// Single-token decode attention against a contiguous KV cache for Hopper:
// split-KV.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py:356
// flash_decode_builder (the flash_decode op, reached through pl.pallas_call
// at src/repro/core/lang.py:1076).
//
// q (b, h, 1, d) attends to its sequence's cache k (b, hk, skv, d),
// v (b, hk, skv, d). The query sits at position q_pos = kv_len - 1, where
// kv_len is read on the device (kv_len_dev, one int32) or, when that
// pointer is null, passed by value. slot_pos (skv,) i32 holds each slot's
// absolute position (-1 = empty), so a rolling-window cache that stores
// ROTATED slots (slot = pos % W) masks correctly; a null slot_pos means
// slot i holds position i. A slot is live iff 0 <= pos <= q_pos and
// q_pos - pos < window. A row with no live slot gives exactly 0. GQA: query
// head hh reads kv head hh / (h / hk).
//
// Bound on the H100: bytes. A step reads every live K/V entry once and does
// 4 * g * d FLOPs per (entry, kv head), far below the ~20 FLOP/byte the
// card needs to leave the memory roofline. At decode sizes (tens of MB)
// the bound is microseconds, so the kernel is latency-bound unless the
// whole card reads at once.
// What the design does about it (the split-KV form of paged_decode.cu):
//  - Split-KV. The grid is (split, kv head, sequence): each block takes one
//    range of `split` consecutive slots (a multiple of the 32-slot tile,
//    fixed by the wrapper from the shapes alone, never from kv_len), so a
//    sequence is read by many SMs at once. While the cache is unwrapped
//    (q_pos < skv, so slot i holds position i or nothing) a range wholly
//    past q_pos or wholly below the window exits after reading kv_len, and
//    the merge skips it by the same rule (range_live); the TPU kernel's
//    whole-block skip. Once wrapped every range runs and masks by slot_pos.
//  - All g = h / hk query heads of the kv head share each K/V tile, so
//    every byte is read from HBM once.
//  - The block marks the 32-slot tiles of its range that hold a live slot
//    and streams only those: K and V stay in their dtype in shared memory,
//    arriving by 16-byte cp.async into a multi-stage ring (3 stages; 2 when
//    a stage passes 32 KB), so the next tiles' loads are in flight during
//    this tile's math. Rows are padded to a multiple of 32 elements in
//    shared memory (d = 112 is stored as 128, the pad zero-filled), so
//    every head dim shares one lane layout.
//  - Scores: 4 lanes a slot, each holding a quarter of the key row in f32
//    registers, q (pre-scaled by sm_scale * log2 e, held as f32 in shared
//    memory: 8 KB at g * d = 2048) read as float4, two shuffles to finish
//    each dot; rows' 16-byte pieces are XOR-swizzled so those reads are
//    free of bank conflicts. The online softmax runs one warp per head in
//    base 2. P.V: each thread owns 8 outputs of one head (two such chunks
//    when g * d > 1024) and a share of the tile's slots; the shares are
//    summed once, at the end.
//  - Merge: each range writes (m, l, acc[g * d]) in f32 into a workspace the
//    wrapper allocates; flash_decode_combine_kernel, launched by the same
//    entry point, rescales and sums them, 256 outputs a block. A live
//    range with no live slot writes m = -inf, l = 0, acc = 0: an exact
//    no-op. A masked slot adds exactly nothing (p = 0 selects), whatever
//    its k and v hold.
#include "attn_sm90.cuh"  // cp16, cp_commit, cp_wait, ex2, LOG2E, smem_u32
#include "common.cuh"

#include <limits>

namespace {

namespace ra = repro::attn;
using repro::Vec16;

constexpr int NT = 128;      // threads a block (4 warps), both kernels
constexpr int KT = 32;       // slots a tile: one lane each in the softmax
constexpr int MAXG = 16;     // query heads per kv head
constexpr int MAXGD = 2048;  // g * d (q as f32 in shared memory: 8 KB)
constexpr int MAXL = 512;    // slots a split
constexpr float NEG_INF = -std::numeric_limits<float>::infinity();

template <typename T, int D>
struct Geo {
  static constexpr int DP = (D + 31) / 32 * 32;  // a row as stored
  static constexpr int VEC = Vec16<T>::N;        // elements a 16-byte piece
  static constexpr int PR = D / VEC;             // pieces a row in memory
  static constexpr int PRP = DP / VEC;           // pieces a row as stored: 4 .. 64
  static constexpr int SWZ = PRP >= 8 ? 4 : 0;   // odd rows' pieces XOR 4
  static constexpr int OUT = D / 8;              // 8-column output chunks a head
  static constexpr int TILE = KT * DP;           // elements of a K (or V) tile
  static constexpr int STAGE_BYTES = 2 * TILE * static_cast<int>(sizeof(T));
  static constexpr int STAGES = STAGE_BYTES > 32768 ? 2 : 3;
  static constexpr int KV_BYTES = STAGES * STAGE_BYTES;
  static_assert(D % VEC == 0 && D % 8 == 0, "rows of whole pieces and chunks");
  static_assert(KV_BYTES >= 2 * NT * 8 * 4, "the ring holds the final reduction");
};

// shared memory of a launch: kv ring | qs (g * DP f32) | ss (g * KT f32) |
// vis_s (split ints) | m_s, l_s, corr_s (g f32 each) | tile_ok (split / KT)
template <typename T, int D>
__host__ __device__ constexpr int smem_bytes(int g, int split) {
  return Geo<T, D>::KV_BYTES + (g * Geo<T, D>::DP + g * KT + 3 * g) * 4 +
         split * 4 + (split / KT) * 4;
}

// the position of piece p of tile row j
template <typename T, int D>
__device__ __forceinline__ int piece(int j, int p) {
  return p ^ ((j & 1) * Geo<T, D>::SWZ);
}

// whether range [s0, s0 + n) may hold a live slot, decided without reading
// slot_pos: while the cache is unwrapped slot i holds position i or nothing
__device__ __forceinline__ bool range_live(int s0, int n, int q_pos, int skv,
                                           int window) {
  if (q_pos >= skv) return true;
  if (s0 > q_pos) return false;
  return window <= 0 || q_pos - (s0 + n - 1) < window;
}

// range_live of range s of `split` slots
__device__ __forceinline__ bool split_live(int s, int split, int q_pos, int skv,
                                           int window) {
  return range_live(s * split, min(split, skv - s * split), q_pos, skv, window);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_decode_split_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ slot_pos, const int* __restrict__ kv_len_dev,
    float* __restrict__ ws, int h, int hk, int skv, int kv_len, int window,
    int split, float scale2, long long qsb, long long qsh, long long ksb,
    long long ksh, long long vsb, long long vsh) {
  using G = Geo<T, D>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int g = h / hk;
  T* kv = reinterpret_cast<T*>(smem);
  float* qs = reinterpret_cast<float*>(smem + G::KV_BYTES);
  float* ss = qs + g * G::DP;
  int* vis_s = reinterpret_cast<int*>(ss + g * KT);
  float* m_s = reinterpret_cast<float*>(vis_s + split);
  float* l_s = m_s + g;
  float* corr_s = l_s + g;
  int* tile_ok = reinterpret_cast<int*>(corr_s + g);

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int sp = blockIdx.x, kh = blockIdx.y, bi = blockIdx.z;
  const int nsplit = gridDim.x;
  const int s0 = sp * split;
  const int n = min(split, skv - s0);  // slots of this range
  const int ntiles = (n + KT - 1) / KT;
  const int q_pos = (kv_len_dev ? *kv_len_dev : kv_len) - 1;
  if (!range_live(s0, n, q_pos, skv, window)) return;  // the merge skips it

  const long long unit = static_cast<long long>(bi * hk + kh) * nsplit + sp;
  float2* ml = reinterpret_cast<float2*>(ws) + unit * g;
  float* acc_out = ws + 2LL * gridDim.z * hk * nsplit * g + unit * g * D;
  const T* kb = k + bi * ksb + kh * ksh;
  const T* vb = v + bi * vsb + kh * vsh;

  for (int e = t; e < g * G::DP; e += NT) {
    const int gi = e / G::DP, dd = e - gi * G::DP;
    qs[e] = dd < D ? repro::to_f32(q[bi * qsb + (kh * g + gi) * qsh + dd]) * scale2 : 0.f;
  }
  for (int i = t; i < ntiles; i += NT) tile_ok[i] = 0;
  if (t < g) {
    m_s[t] = NEG_INF;
    l_s[t] = 0.f;
  }
  __syncthreads();
  for (int i = t; i < n; i += NT) {
    const int pos = slot_pos ? slot_pos[s0 + i] : s0 + i;
    const int ok = pos >= 0 && pos <= q_pos && (window <= 0 || q_pos - pos < window);
    vis_s[i] = ok;
    if (ok) tile_ok[i / KT] = 1;
  }
  __syncthreads();

  // tiles with a live slot, in order; a tile without one is never loaded
  auto next = [&](int from) {
    while (from < ntiles && !tile_ok[from]) ++from;
    return from;
  };
  int cur = next(0);
  if (cur == ntiles) {  // an empty partial
    if (t < g) ml[t] = make_float2(NEG_INF, 0.f);
    for (int e = t; e < g * D; e += NT) acc_out[e] = 0.f;
    return;
  }

  auto load = [&](int tile, int stage) {
    T* dk = kv + stage * 2 * G::TILE;
    T* dv = dk + G::TILE;
    const int base = tile * KT;
    for (int e = t; e < KT * G::PRP; e += NT) {
      const int j = e / G::PRP, p = e - j * G::PRP;
      const bool in = base + j < n && p < G::PR;  // the pad is zero-filled
      const long long src = in ? static_cast<long long>(s0 + base + j) * D + p * G::VEC : 0;
      const int dst = j * G::DP + piece<T, D>(j, p) * G::VEC;
      ra::cp16(ra::smem_u32(dk + dst), kb + src, in);
      ra::cp16(ra::smem_u32(dv + dst), vb + src, in);
    }
  };

  // scores: slot qj of the tile, quarter qc of its key row
  const int qj = warp * 8 + (lane >> 2), qc = lane & 3;
  // P.V: chunks of 8 outputs (head pgi, columns d0..d0+7); with fewer
  // chunks than threads, slot groups sg, sg + ngroups, ... of each tile
  const int nchunk = g * G::OUT;
  const int ngroups = nchunk >= NT ? 1 : NT / nchunk;
  const int sg = t / nchunk;
  const bool pv = t < ngroups * nchunk;
  int pgi[2], d0[2];
  bool own[2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int ch = ngroups > 1 ? t - sg * nchunk : t + c * NT;
    own[c] = pv && (c == 0 || ngroups == 1) && ch < nchunk;
    const int hh = own[c] ? ch / G::OUT : 0;
    pgi[c] = hh;
    d0[c] = own[c] ? (ch - hh * G::OUT) * 8 : 0;
  }
  float acc[2][8];
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int u = 0; u < 8; ++u) acc[c][u] = 0.f;

  int issue = cur;
  for (int st = 0; st < G::STAGES - 1; ++st) {
    if (issue < ntiles) {
      load(issue, st);
      issue = next(issue + 1);
    }
    ra::cp_commit();
  }
  for (int it = 0; cur < ntiles; ++it, cur = next(cur + 1)) {
    ra::cp_wait<G::STAGES - 2>();
    __syncthreads();  // tile `it` has landed; tile it - 1 is consumed
    if (issue < ntiles) {
      load(issue, (it + G::STAGES - 1) % G::STAGES);
      issue = next(issue + 1);
    }
    ra::cp_commit();
    const T* ks = kv + (it % G::STAGES) * 2 * G::TILE;
    const T* vs = ks + G::TILE;
    const int base = cur * KT;
    {
      float kf[G::DP / 4];
      const T* kr = ks + qj * G::DP;
#pragma unroll
      for (int u = 0; u < G::PRP / 4; ++u) {
        const int p = qc + 4 * u;
        Vec16<T>::unpack(*reinterpret_cast<const uint4*>(kr + piece<T, D>(qj, p) * G::VEC),
                         kf + u * G::VEC);
      }
      const bool ok = base + qj < n && vis_s[base + qj];
#pragma unroll 4
      for (int gi = 0; gi < g; ++gi) {  // heads are independent: unrolled
        const float* qr = qs + gi * G::DP;
        float d2[2] = {0.f, 0.f};
#pragma unroll
        for (int u = 0; u < G::PRP / 4; ++u) {
          const float4* q4 = reinterpret_cast<const float4*>(qr + (qc + 4 * u) * G::VEC);
#pragma unroll
          for (int w = 0; w < G::VEC / 4; ++w) {
            const float4 a = q4[w];
            const float* kk = kf + u * G::VEC + 4 * w;
            d2[w & 1] += a.x * kk[0] + a.y * kk[1] + a.z * kk[2] + a.w * kk[3];
          }
        }
        float dot = d2[0] + d2[1];
        dot += __shfl_xor_sync(0xffffffffu, dot, 1);
        dot += __shfl_xor_sync(0xffffffffu, dot, 2);
        if (qc == 0) ss[gi * KT + qj] = ok ? dot : NEG_INF;
      }
    }
    __syncthreads();
    for (int gi = warp; gi < g; gi += NT / 32) {  // online softmax, base 2
      const float s = ss[gi * KT + lane];
      const float m_old = m_s[gi];
      const float m_new = fmaxf(m_old, repro::warp_max(s));
      const float corr = m_old == NEG_INF ? 0.f : ra::ex2(m_old - m_new);
      const float p = s == NEG_INF ? 0.f : ra::ex2(s - m_new);
      const float sum = repro::warp_sum(p);
      ss[gi * KT + lane] = p;
      if (lane == 0) {
        l_s[gi] = l_s[gi] * corr + sum;
        m_s[gi] = m_new;
        corr_s[gi] = corr;
      }
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      if (!own[c]) continue;
      const float cr = corr_s[pgi[c]];
#pragma unroll
      for (int u = 0; u < 8; ++u) acc[c][u] *= cr;
#pragma unroll 4
      for (int jj = sg; jj < KT; jj += ngroups) {
        const float p = ss[pgi[c] * KT + jj];
        float vf[8];
#pragma unroll
        for (int w = 0; w < 8 / G::VEC; ++w)
          Vec16<T>::unpack(*reinterpret_cast<const uint4*>(
                               vs + jj * G::DP + piece<T, D>(jj, d0[c] / G::VEC + w) * G::VEC),
                           vf + w * G::VEC);
        // a masked slot (p = 0) adds nothing, whatever v holds
#pragma unroll
        for (int u = 0; u < 8; ++u) acc[c][u] = p != 0.f ? fmaf(p, vf[u], acc[c][u]) : acc[c][u];
      }
    }
  }

  ra::cp_wait<0>();
  __syncthreads();  // the ring is free: sum the slot groups' shares there
  if (t < g) ml[t] = make_float2(m_s[t], l_s[t]);
  if (ngroups == 1) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      if (!own[c]) continue;
      float* out = acc_out + pgi[c] * D + d0[c];  // 8-byte aligned
#pragma unroll
      for (int u = 0; u < 8; u += 2)
        *reinterpret_cast<float2*>(out + u) = make_float2(acc[c][u], acc[c][u + 1]);
    }
    return;
  }
  float* red = reinterpret_cast<float*>(kv);
  if (pv) {
    const int ch = t - sg * nchunk;
#pragma unroll
    for (int u = 0; u < 8; ++u) red[(sg * nchunk + ch) * 8 + u] = acc[0][u];
  }
  __syncthreads();
  for (int e = t; e < g * D; e += NT) {  // e = chunk * 8 + u = gi * D + col
    float a = 0.f;
    for (int s = 0; s < ngroups; ++s) a += red[s * nchunk * 8 + e];
    acc_out[e] = a;
  }
}

// one block per (256 outputs, kv head, sequence): o = sum_s 2^(m_s - M)
// acc_s / sum_s 2^(m_s - M) l_s over the ranges s the split kernel wrote
// (range_live); 0 when none holds a live slot. Wide groups (g * d up to
// 2048) spread over several blocks, so a kv head's merge is not one SM's.
template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_decode_combine_kernel(
    const float* __restrict__ ws, const int* __restrict__ kv_len_dev,
    T* __restrict__ o, int h, int hk, int skv, int kv_len, int window,
    int split) {
  __shared__ float mm[MAXG], ll[MAXG];
  const int g = h / hk;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int e0 = blockIdx.x * 2 * NT, kh = blockIdx.y, bi = blockIdx.z;
  const int g0 = e0 / D, g1 = min(g, (e0 + 2 * NT - 1) / D + 1);  // its heads
  const int nsplit = (skv + split - 1) / split;
  const int q_pos = (kv_len_dev ? *kv_len_dev : kv_len) - 1;
  const long long unit = static_cast<long long>(bi * hk + kh) * nsplit;
  const float2* ml = reinterpret_cast<const float2*>(ws) + unit * g;
  const float* acc = ws + 2LL * gridDim.z * hk * nsplit * g + unit * g * D;
  for (int gi = g0 + warp; gi < g1; gi += NT / 32) {
    float m = NEG_INF;
    for (int s = lane; s < nsplit; s += 32)
      if (split_live(s, split, q_pos, skv, window)) m = fmaxf(m, ml[s * g + gi].x);
    m = repro::warp_max(m);
    float l = 0.f;
    if (m != NEG_INF) {
      for (int s = lane; s < nsplit; s += 32) {
        if (!split_live(s, split, q_pos, skv, window)) continue;
        const float2 r = ml[s * g + gi];
        l += (r.x == NEG_INF ? 0.f : ra::ex2(r.x - m)) * r.y;
      }
    }
    l = repro::warp_sum(l);
    if (lane == 0) {
      mm[gi - g0] = m;
      ll[gi - g0] = l;
    }
  }
  __syncthreads();
  const int e = e0 + 2 * t;  // two outputs a thread
  if (e >= g * D) return;
  const int gi = e / D;
  const float m = mm[gi - g0], l = ll[gi - g0];
  float2 a = make_float2(0.f, 0.f);
  if (m != NEG_INF && l > 0.f) {
    for (int s = 0; s < nsplit; ++s) {
      if (!split_live(s, split, q_pos, skv, window)) continue;
      const float ms = ml[s * g + gi].x;
      const float w = ms == NEG_INF ? 0.f : ra::ex2(ms - m);
      const float2 x = *reinterpret_cast<const float2*>(
          acc + static_cast<long long>(s) * g * D + e);
      a.x += w * x.x;
      a.y += w * x.y;
    }
    a.x /= l;
    a.y /= l;
  }
  T* out = o + (static_cast<long long>(bi) * h + kh * g) * D + e;
  out[0] = repro::from_f32<T>(a.x);
  out[1] = repro::from_f32<T>(a.y);
}

template <typename T, int D>
int split_smem_attr() {  // once per kernel: its shared memory may pass 48 KB
  static const int err = static_cast<int>(cudaFuncSetAttribute(
      flash_decode_split_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes<T, D>(MAXG, MAXL)));
  return err;
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* slot_pos,
           const int* kv_len_dev, void* o, float* ws, int b, int h, int hk,
           int skv, int kv_len, int window, int split, float sm_scale,
           const long long* st, cudaStream_t s) {
  if (const int err = split_smem_attr<T, D>()) return err;
  const int nsplit = (skv + split - 1) / split;
  flash_decode_split_kernel<T, D>
      <<<dim3(nsplit, hk, b), NT, smem_bytes<T, D>(h / hk, split), s>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), slot_pos, kv_len_dev, ws, h, hk, skv,
          kv_len, window, split, sm_scale * ra::LOG2E, st[0], st[1], st[2],
          st[3], st[4], st[5]);
  const int g = h / hk;
  flash_decode_combine_kernel<T, D><<<dim3((g * D + 2 * NT - 1) / (2 * NT), hk, b), NT, 0, s>>>(
      ws, kv_len_dev, static_cast<T*>(o), h, hk, skv, kv_len, window, split);
  return 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; d in {32, 64, 112, 128, 256};
// h / hk <= 16 and (h / hk) * d <= 2048. o is contiguous (b, h, 1, d); q
// takes element strides for its batch and head axes; k and v take them for
// their batch and head axes, their (skv, d) rows contiguous and 16-byte
// aligned. slot_pos is (skv,) i32 or null (slot i holds position i);
// kv_len_dev is one i32 on the device or null (kv_len is used); window <= 0
// means no window. split: slots a block, a multiple of 32 in [32, 512]; ws:
// b * h * ceil(skv / split) * (d + 2) f32 of workspace. Launches the split
// kernel and the combine kernel.
extern "C" int flash_decode(const void* q, const void* k, const void* v,
                            const int* slot_pos, const int* kv_len_dev,
                            void* o, void* ws, int b, int h, int hk, int skv,
                            int d, int dtype, int kv_len, int window,
                            int split, float sm_scale, long long qsb,
                            long long qsh, long long ksb, long long ksh,
                            long long vsb, long long vsh, void* stream) {
  const long long st[6] = {qsb, qsh, ksb, ksh, vsb, vsh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b <= 0 || hk <= 0 || skv <= 0 || h % hk != 0 || h / hk > MAXG ||
      (h / hk) * ((d + 31) / 32 * 32) > MAXGD || split < KT || split > MAXL ||
      split % KT != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  float* w = static_cast<float*>(ws);
  int err;
#define REPRO_DECODE(T, D)                                                    \
  err = launch<T, D>(q, k, v, slot_pos, kv_len_dev, o, w, b, h, hk, skv,      \
                     kv_len, window, split, sm_scale, st, s)
  if (dtype == 0 && d == 32) REPRO_DECODE(float, 32);
  else if (dtype == 0 && d == 64) REPRO_DECODE(float, 64);
  else if (dtype == 0 && d == 112) REPRO_DECODE(float, 112);
  else if (dtype == 0 && d == 128) REPRO_DECODE(float, 128);
  else if (dtype == 0 && d == 256) REPRO_DECODE(float, 256);
  else if (dtype == 1 && d == 32) REPRO_DECODE(__nv_bfloat16, 32);
  else if (dtype == 1 && d == 64) REPRO_DECODE(__nv_bfloat16, 64);
  else if (dtype == 1 && d == 112) REPRO_DECODE(__nv_bfloat16, 112);
  else if (dtype == 1 && d == 128) REPRO_DECODE(__nv_bfloat16, 128);
  else if (dtype == 1 && d == 256) REPRO_DECODE(__nv_bfloat16, 256);
  else return static_cast<int>(cudaErrorInvalidValue);
#undef REPRO_DECODE
  return err ? err : static_cast<int>(cudaGetLastError());
}
