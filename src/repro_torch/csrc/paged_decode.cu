// Paged single-token decode attention for Hopper: split-KV.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py:457
// paged_decode_builder (the flash_decode_paged op, reached through the
// scalar-prefetch pl.pallas_call at src/repro/core/lang.py:1059).
//
// q (b, h, 1, d) attends to its sequence's KV, which lives in shared page
// pools k/v (P, hk, page, d): logical page j of sequence b is pool page
// block_table[b, j]. A slot is visible when its absolute position
// pos_pages[p, s] satisfies 0 <= pos <= q_pos (q_pos = kv_len[b] - 1).
//
// Bound on the H100: bytes. Each step reads every live KV entry once and
// does 4 * g * d FLOPs per (entry, kv head), far below the ~20 FLOP/byte
// the card needs to leave the memory roofline. At decode sizes (a few MB)
// the bound is a few microseconds, so the kernel is latency-bound unless
// the whole card reads at once.
// What the design does about it:
//  - Split-KV. The grid is (split, kv head, sequence): each block takes one
//    range of `split` logical slots (a multiple of the 32-slot tile, fixed
//    by the wrapper from the shapes alone, never from kv_len), so a long
//    sequence is read by many SMs at once. A range that lies past q_pos
//    (cache not wrapped) exits at once, and the merge skips it; a wrapped
//    cache (q_pos >= nsp * page) visits every slot and masks by position.
//  - All g = h / hk query heads of the kv head share each K/V tile, so
//    every byte is read from HBM once.
//  - The block first reads its range's block-table entries and positions
//    (two dependent loads), marks the 32-slot tiles that hold a visible
//    slot, and then streams only those: K and V stay in their dtype in
//    shared memory, arriving by 16-byte cp.async into a 3-stage ring, so
//    the next tiles' loads are in flight during this tile's math. Pools
//    whose base is not 16-byte aligned take the same kernel with plain
//    loads (ALIGNED = false), chosen up front by the entry point.
//  - Scores: 4 lanes a slot, each holding a quarter of the key row in f32
//    registers, q (pre-scaled by sm_scale * log2 e) from shared memory,
//    two shuffles to finish each dot; rows' 16-byte pieces are XOR-swizzled
//    so those reads are free of bank conflicts. The online softmax runs one
//    warp per head in base 2. P.V: each thread owns 8 outputs of one head
//    and a share of the tile's slots; the shares are summed once, at the
//    end.
//  - Merge: each split writes (m, l, acc[g * d]) in f32 into a workspace
//    the wrapper allocates; paged_decode_combine_kernel, launched by the
//    same entry point, rescales and sums them. A range with no visible
//    slot writes m = -inf, l = 0, acc = 0: an exact no-op. Idle slots (len
//    0, table of zeros) give exact 0.
#include "attn_sm90.cuh"  // cp16, cp_commit, cp_wait, ex2, LOG2E, smem_u32
#include "common.cuh"

#include <limits>

namespace {

namespace ra = repro::attn;
using repro::Vec16;

constexpr int NT = 128;      // threads a block (4 warps), both kernels
constexpr int KT = 32;       // slots a tile: one lane each in the softmax
constexpr int STAGES = 3;    // the cp.async ring
constexpr int MAXG = 16;     // query heads per kv head
constexpr int MAXGD = 1024;  // g * d
constexpr int MAXL = 512;    // slots a split
constexpr float NEG_INF = -std::numeric_limits<float>::infinity();

template <typename T, int D>
struct Geo {
  static constexpr int VEC = Vec16<T>::N;        // elements a 16-byte piece
  static constexpr int PR = D / VEC;             // pieces a row: 4 .. 32
  static constexpr int SWZ = PR >= 8 ? 4 : 0;    // odd rows' pieces XOR 4
  static constexpr int TILE = KT * D;            // elements of a K (or V) tile
  static constexpr int KV_BYTES = STAGES * 2 * TILE * static_cast<int>(sizeof(T));
  // kv ring | row_s (i64) | qs | ss | vis_s | m_s, l_s, corr_s | tile_ok
  static constexpr int SMEM = KV_BYTES + MAXL * 8 + (MAXGD + MAXG * KT) * 4 +
                              MAXL * 4 + 3 * MAXG * 4 + (MAXL / KT) * 4;
  static_assert(KV_BYTES >= NT * 8 * 4, "the ring holds the final reduction");
};

// the position of piece p of tile row j
template <typename T, int D>
__device__ __forceinline__ int piece(int j, int p) {
  return p ^ ((j & 1) * Geo<T, D>::SWZ);
}

template <typename T, int D, bool ALIGNED>
__global__ void __launch_bounds__(NT) paged_decode_split_kernel(
    const T* __restrict__ q, const T* __restrict__ kp, const T* __restrict__ vp,
    const int* __restrict__ table, const int* __restrict__ kv_len,
    const int* __restrict__ pos_pages, float* __restrict__ ws, int h, int hk,
    int page, int nsp, int split, float scale2, long long qsb, long long qsh) {
  using G = Geo<T, D>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* kv = reinterpret_cast<T*>(smem);
  long long* row_s = reinterpret_cast<long long*>(smem + G::KV_BYTES);
  float* qs = reinterpret_cast<float*>(row_s + MAXL);
  float* ss = qs + MAXGD;
  int* vis_s = reinterpret_cast<int*>(ss + MAXG * KT);
  float* m_s = reinterpret_cast<float*>(vis_s + MAXL);
  float* l_s = m_s + MAXG;
  float* corr_s = l_s + MAXG;
  int* tile_ok = reinterpret_cast<int*>(corr_s + MAXG);

  const int g = h / hk;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int sp = blockIdx.x, kh = blockIdx.y, bi = blockIdx.z;
  const int nsplit = gridDim.x;
  const int cap = nsp * page;
  const int s0 = sp * split;
  const int n = min(split, cap - s0);  // slots of this range
  const int ntiles = (n + KT - 1) / KT;
  // the table entry of this thread's first slot is read beside kv_len, so
  // the chain to the first K/V tile is three loads deep, not four
  const int pp0 = t < n ? table[bi * nsp + (s0 + t) / page] : 0;
  const int q_pos = kv_len[bi] - 1;
  const long long unit = static_cast<long long>(bi * hk + kh) * nsplit + sp;
  float2* ml = reinterpret_cast<float2*>(ws) + unit * g;
  float* acc_out = ws + 2LL * gridDim.z * hk * nsplit * g + unit * g * D;

  // slot l holds position l while the cache is unwrapped: a range past
  // q_pos writes nothing, and the merge never reads it
  if (q_pos < cap && s0 > q_pos) return;
  for (int e = t; e < g * D; e += NT) {
    const int gi = e / D, dd = e - gi * D;
    qs[e] = repro::to_f32(q[bi * qsb + (kh * g + gi) * qsh + dd]) * scale2;
  }
  if (t < ntiles) tile_ok[t] = 0;
  if (t < g) {
    m_s[t] = NEG_INF;
    l_s[t] = 0.f;
  }
  __syncthreads();
  for (int i = t; i < n; i += NT) {
    const int l = s0 + i;
    const int j = l / page, off = l - j * page;
    const long long pp = i == t ? pp0 : table[bi * nsp + j];
    const int pos = pos_pages[pp * page + off];
    const int ok = pos >= 0 && pos <= q_pos;
    vis_s[i] = ok;
    row_s[i] = (pp * hk + kh) * page + off;
    if (ok) tile_ok[i / KT] = 1;
  }
  __syncthreads();

  // tiles with a visible slot, in order; a tile without one is never loaded
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
    for (int e = t; e < KT * G::PR; e += NT) {
      const int j = e / G::PR, p = e - j * G::PR;
      const int i = base + j;
      const bool in = i < n;
      const long long src = (in ? row_s[i] : 0) * D + p * G::VEC;
      const int dst = j * D + piece<T, D>(j, p) * G::VEC;
      if constexpr (ALIGNED) {
        ra::cp16(ra::smem_u32(dk + dst), kp + src, in);
        ra::cp16(ra::smem_u32(dv + dst), vp + src, in);
      } else {
#pragma unroll
        for (int u = 0; u < G::VEC; ++u) {
          dk[dst + u] = in ? kp[src + u] : repro::from_f32<T>(0.f);
          dv[dst + u] = in ? vp[src + u] : repro::from_f32<T>(0.f);
        }
      }
    }
  };

  // scores: slot qj of the tile, quarter qc of its key row
  const int qj = warp * 8 + (lane >> 2), qc = lane & 3;
  // P.V: 8 outputs (chunk ch: head pgi, columns d0..d0+7), slots sg, sg +
  // ngroups, ... of each tile
  const int nchunk = g * D / 8;
  const int ngroups = NT / nchunk;
  const bool pv = t < ngroups * nchunk;
  const int sg = t / nchunk, ch = t - sg * nchunk;
  const int pgi = ch / (D / 8), d0 = (ch - pgi * (D / 8)) * 8;
  float acc[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) acc[u] = 0.f;

  int issue = cur;
  for (int st = 0; st < STAGES - 1; ++st) {
    if (issue < ntiles) {
      load(issue, st);
      issue = next(issue + 1);
    }
    ra::cp_commit();
  }
  for (int it = 0; cur < ntiles; ++it, cur = next(cur + 1)) {
    ra::cp_wait<STAGES - 2>();
    __syncthreads();  // tile `it` has landed; tile it - 1 is consumed
    if (issue < ntiles) {
      load(issue, (it + STAGES - 1) % STAGES);
      issue = next(issue + 1);
    }
    ra::cp_commit();
    const T* ks = kv + (it % STAGES) * 2 * G::TILE;
    const T* vs = ks + G::TILE;
    const int base = cur * KT;
    {
      float kf[D / 4];
      const T* kr = ks + qj * D;
#pragma unroll
      for (int u = 0; u < G::PR / 4; ++u) {
        const int p = qc + 4 * u;
        Vec16<T>::unpack(*reinterpret_cast<const uint4*>(kr + piece<T, D>(qj, p) * G::VEC),
                         kf + u * G::VEC);
      }
      const bool ok = base + qj < n && vis_s[base + qj];
#pragma unroll 4
      for (int gi = 0; gi < g; ++gi) {  // heads are independent: unrolled
        const float* qr = qs + gi * D;
        float d2[2] = {0.f, 0.f};
#pragma unroll
        for (int u = 0; u < G::PR / 4; ++u) {
          const float4* q4 = reinterpret_cast<const float4*>(qr + (qc + 4 * u) * G::VEC);
#pragma unroll
          for (int v = 0; v < G::VEC / 4; ++v) {
            const float4 a = q4[v];
            const float* kk = kf + u * G::VEC + 4 * v;
            d2[v & 1] += a.x * kk[0] + a.y * kk[1] + a.z * kk[2] + a.w * kk[3];
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
    if (pv) {
      const float cr = corr_s[pgi];
#pragma unroll
      for (int u = 0; u < 8; ++u) acc[u] *= cr;
#pragma unroll 4
      for (int jj = sg; jj < KT; jj += ngroups) {
        const float p = ss[pgi * KT + jj];
        float vf[8];
#pragma unroll
        for (int w = 0; w < 8 / G::VEC; ++w)
          Vec16<T>::unpack(*reinterpret_cast<const uint4*>(
                               vs + jj * D + piece<T, D>(jj, d0 / G::VEC + w) * G::VEC),
                           vf + w * G::VEC);
        // a masked slot (p = 0) adds nothing, whatever v holds
#pragma unroll
        for (int u = 0; u < 8; ++u) acc[u] = p != 0.f ? fmaf(p, vf[u], acc[u]) : acc[u];
      }
    }
  }

  ra::cp_wait<0>();
  __syncthreads();  // the ring is free: sum the slot groups' shares there
  float* red = reinterpret_cast<float*>(kv);
  if (pv) {
#pragma unroll
    for (int u = 0; u < 8; ++u) red[sg * g * D + ch * 8 + u] = acc[u];
  }
  if (t < g) ml[t] = make_float2(m_s[t], l_s[t]);
  __syncthreads();
  for (int e = t; e < g * D; e += NT) {
    float a = 0.f;
    for (int s = 0; s < ngroups; ++s) a += red[s * g * D + e];
    acc_out[e] = a;
  }
}

// one block per (kv head, sequence): o = sum_s 2^(m_s - M) acc_s / sum_s
// 2^(m_s - M) l_s over the ranges s that start at or before q_pos (all of
// them once the cache is wrapped), the ranges the split kernel wrote; 0
// when none holds a visible slot
template <typename T, int D>
__global__ void __launch_bounds__(NT) paged_decode_combine_kernel(
    const float* __restrict__ ws, const int* __restrict__ kv_len,
    T* __restrict__ o, int h, int hk, int nsplit, int split, int cap) {
  __shared__ float mm[MAXG], ll[MAXG];
  const int g = h / hk;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int kh = blockIdx.x, bi = blockIdx.y;
  const int q_pos = kv_len[bi] - 1;
  const int nlive = q_pos >= cap ? nsplit : q_pos < 0 ? 0 : min(nsplit, q_pos / split + 1);
  const long long unit = static_cast<long long>(bi * hk + kh) * nsplit;
  const float2* ml = reinterpret_cast<const float2*>(ws) + unit * g;
  const float* acc = ws + 2LL * gridDim.y * hk * nsplit * g + unit * g * D;
  for (int gi = warp; gi < g; gi += NT / 32) {
    float m = NEG_INF;
    for (int s = lane; s < nlive; s += 32) m = fmaxf(m, ml[s * g + gi].x);
    m = repro::warp_max(m);
    float l = 0.f;
    if (m != NEG_INF) {
      for (int s = lane; s < nlive; s += 32) {
        const float2 r = ml[s * g + gi];
        l += (r.x == NEG_INF ? 0.f : ra::ex2(r.x - m)) * r.y;
      }
    }
    l = repro::warp_sum(l);
    if (lane == 0) {
      mm[gi] = m;
      ll[gi] = l;
    }
  }
  __syncthreads();
  for (int e = 2 * t; e < g * D; e += 2 * NT) {  // two outputs a thread
    const int gi = e / D;
    const float m = mm[gi], l = ll[gi];
    float2 a = make_float2(0.f, 0.f);
    if (m != NEG_INF && l > 0.f) {
#pragma unroll 8
      for (int s = 0; s < nlive; ++s) {
        const float ms = ml[s * g + gi].x;
        const float w = ms == NEG_INF ? 0.f : ra::ex2(ms - m);
        const float2 v = *reinterpret_cast<const float2*>(
            acc + static_cast<long long>(s) * g * D + e);
        a.x += w * v.x;
        a.y += w * v.y;
      }
      a.x /= l;
      a.y /= l;
    }
    T* out = o + (static_cast<long long>(bi) * h + kh * g) * D + e;
    out[0] = repro::from_f32<T>(a.x);
    out[1] = repro::from_f32<T>(a.y);
  }
}

template <typename T, int D, bool ALIGNED>
int split_smem_attr() {  // once per kernel: its shared memory may pass 48 KB
  static const int err = static_cast<int>(cudaFuncSetAttribute(
      paged_decode_split_kernel<T, D, ALIGNED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Geo<T, D>::SMEM));
  return err;
}

template <typename T, int D, bool ALIGNED>
int launch(const void* q, const void* kp, const void* vp, const int* table,
           const int* kv_len, const int* pos, void* o, float* ws, int b, int h,
           int hk, int page, int nsp, int split, float sm_scale, long long qsb,
           long long qsh, cudaStream_t s) {
  if (const int err = split_smem_attr<T, D, ALIGNED>()) return err;
  const int nsplit = (nsp * page + split - 1) / split;
  paged_decode_split_kernel<T, D, ALIGNED>
      <<<dim3(nsplit, hk, b), NT, Geo<T, D>::SMEM, s>>>(
          static_cast<const T*>(q), static_cast<const T*>(kp),
          static_cast<const T*>(vp), table, kv_len, pos, ws, h, hk, page, nsp,
          split, sm_scale * ra::LOG2E, qsb, qsh);
  paged_decode_combine_kernel<T, D><<<dim3(hk, b), NT, 0, s>>>(
      ws, kv_len, static_cast<T*>(o), h, hk, nsplit, split, nsp * page);
  return 0;
}

template <typename T, int D>
int launch_any(bool aligned, const void* q, const void* kp, const void* vp,
               const int* table, const int* kv_len, const int* pos, void* o,
               float* ws, int b, int h, int hk, int page, int nsp, int split,
               float sm_scale, long long qsb, long long qsh, cudaStream_t s) {
  return aligned ? launch<T, D, true>(q, kp, vp, table, kv_len, pos, o, ws, b, h, hk,
                                      page, nsp, split, sm_scale, qsb, qsh, s)
                 : launch<T, D, false>(q, kp, vp, table, kv_len, pos, o, ws, b, h, hk,
                                       page, nsp, split, sm_scale, qsb, qsh, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; d in {32, 64, 128}; h / hk <= 16 and
// (h / hk) * d <= 1024. Pools, table (b, nsp), kv_len (b,), pos_pages
// (P, page) and o (b, h, 1, d) are contiguous; q takes element strides for
// its batch and head axes. split: slots a block, a multiple of 32 in
// [32, 512]; ws: b * h * ceil(nsp * page / split) * (d + 2) f32 of
// workspace. Launches the split kernel and the combine kernel.
extern "C" int paged_decode(const void* q, const void* kp, const void* vp,
                            const int* table, const int* kv_len,
                            const int* pos_pages, void* o, void* ws, int b,
                            int h, int hk, int page, int nsp, int split, int d,
                            int dtype, float sm_scale, long long qsb,
                            long long qsh, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b <= 0 || hk <= 0 || page <= 0 || nsp <= 0 || h % hk != 0 ||
      h / hk > MAXG || (h / hk) * d > MAXGD || split < KT || split > MAXL ||
      split % KT != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool aligned = (reinterpret_cast<uintptr_t>(kp) | reinterpret_cast<uintptr_t>(vp)) % 16 == 0;
  float* w = static_cast<float*>(ws);
  int err;
#define REPRO_PAGED(T, D)                                                        \
  err = launch_any<T, D>(aligned, q, kp, vp, table, kv_len, pos_pages, o, w, b, \
                         h, hk, page, nsp, split, sm_scale, qsb, qsh, s)
  if (dtype == 0 && d == 32) REPRO_PAGED(float, 32);
  else if (dtype == 0 && d == 64) REPRO_PAGED(float, 64);
  else if (dtype == 0 && d == 128) REPRO_PAGED(float, 128);
  else if (dtype == 1 && d == 32) REPRO_PAGED(__nv_bfloat16, 32);
  else if (dtype == 1 && d == 64) REPRO_PAGED(__nv_bfloat16, 64);
  else if (dtype == 1 && d == 128) REPRO_PAGED(__nv_bfloat16, 128);
  else return static_cast<int>(cudaErrorInvalidValue);
#undef REPRO_PAGED
  return err ? err : static_cast<int>(cudaGetLastError());
}
