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
//    shared memory, arriving by 16-byte cp.async into a multi-stage ring
//    (3 stages; 2 when a stage passes 32 KB: f32 at d = 256), so the next
//    tiles' loads are in flight during this tile's math. Pools
//    whose base is not 16-byte aligned take the same kernel with plain
//    loads (ALIGNED = false), chosen up front by the entry point.
//  - Scores: 4 lanes a slot, each holding a quarter of the key row in f32
//    registers, q (pre-scaled by sm_scale * log2 e, held as f32 in shared
//    memory sized at launch: 8 KB at g * d = 2048, paligemma's 8 heads of
//    256) read as float4, two shuffles to finish each dot; rows' 16-byte
//    pieces are XOR-swizzled so those reads are free of bank conflicts.
//    The online softmax runs one warp per head in base 2. P.V: each thread
//    owns 8 outputs of one head (two such chunks when g * d > 1024) and a
//    share of the tile's slots; the shares are summed once, at the end.
//    The design is flash_decode.cu's, over a block table.
//  - Merge: each split writes (m, l, acc[g * d]) in f32 into a workspace
//    the wrapper allocates; paged_decode_combine_kernel, launched by the
//    same entry point, rescales and sums them, 256 outputs a block. A range with no visible
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
constexpr int MAXG = 16;     // query heads per kv head
constexpr int MAXGD = 2048;  // g * d (q as f32 in shared memory: 8 KB)
constexpr int MAXL = 512;    // slots a split
constexpr float NEG_INF = -std::numeric_limits<float>::infinity();

template <typename T, int D>
struct Geo {
  static constexpr int VEC = Vec16<T>::N;        // elements a 16-byte piece
  static constexpr int PR = D / VEC;             // pieces a row: 4 .. 64
  static constexpr int SWZ = PR >= 8 ? 4 : 0;    // odd rows' pieces XOR 4
  static constexpr int OUT = D / 8;              // 8-column output chunks a head
  static constexpr int TILE = KT * D;            // elements of a K (or V) tile
  static constexpr int STAGE_BYTES = 2 * TILE * static_cast<int>(sizeof(T));
  static constexpr int STAGES = STAGE_BYTES > 32768 ? 2 : 3;
  static constexpr int KV_BYTES = STAGES * STAGE_BYTES;
  static_assert(KV_BYTES >= NT * 8 * 4, "the ring holds the final reduction");
};

// shared memory of a launch: kv ring | row_s (split i64) | qs (g * D f32) |
// ss (g * KT f32) | vis_s (split ints) | m_s, l_s, corr_s (g f32 each) |
// tile_ok (split / KT)
template <typename T, int D>
__host__ __device__ constexpr int smem_bytes(int g, int split) {
  return Geo<T, D>::KV_BYTES + split * 8 + (g * D + g * KT + 3 * g) * 4 + split * 4 +
         (split / KT) * 4;
}

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
  const int g = h / hk;
  T* kv = reinterpret_cast<T*>(smem);
  long long* row_s = reinterpret_cast<long long*>(smem + G::KV_BYTES);
  float* qs = reinterpret_cast<float*>(row_s + split);
  float* ss = qs + g * D;
  int* vis_s = reinterpret_cast<int*>(ss + g * KT);
  float* m_s = reinterpret_cast<float*>(vis_s + split);
  float* l_s = m_s + g;
  float* corr_s = l_s + g;
  int* tile_ok = reinterpret_cast<int*>(corr_s + g);

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
  for (int i = t; i < ntiles; i += NT) tile_ok[i] = 0;
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
  // P.V: chunks of 8 outputs (head pgi, columns d0..d0+7); with fewer
  // chunks than threads, slot groups sg, sg + ngroups, ... of each tile;
  // with more (g * d > 1024), two chunks a thread
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
                               vs + jj * D + piece<T, D>(jj, d0[c] / G::VEC + w) * G::VEC),
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
// acc_s / sum_s 2^(m_s - M) l_s over the ranges s that start at or before
// q_pos (all of them once the cache is wrapped), the ranges the split
// kernel wrote; 0 when none holds a visible slot. Wide groups (g * d up to
// 2048) spread over several blocks, as flash_decode.cu's merge: one block
// a (kv head, sequence) left paligemma's 8 x 1 merges on 8 SMs, the
// larger half of the step's paged_decode time on an H100.
template <typename T, int D>
__global__ void __launch_bounds__(NT) paged_decode_combine_kernel(
    const float* __restrict__ ws, const int* __restrict__ kv_len,
    T* __restrict__ o, int h, int hk, int nsplit, int split, int cap) {
  __shared__ float mm[MAXG], ll[MAXG];
  const int g = h / hk;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int e0 = blockIdx.x * 2 * NT, kh = blockIdx.y, bi = blockIdx.z;
  const int g0 = e0 / D, g1 = min(g, (e0 + 2 * NT - 1) / D + 1);  // its heads
  const int q_pos = kv_len[bi] - 1;
  const int nlive = q_pos >= cap ? nsplit : q_pos < 0 ? 0 : min(nsplit, q_pos / split + 1);
  const long long unit = static_cast<long long>(bi * hk + kh) * nsplit;
  const float2* ml = reinterpret_cast<const float2*>(ws) + unit * g;
  const float* acc = ws + 2LL * gridDim.z * hk * nsplit * g + unit * g * D;
  for (int gi = g0 + warp; gi < g1; gi += NT / 32) {
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

template <typename T, int D, bool ALIGNED>
int split_smem_attr() {  // once per kernel: its shared memory may pass 48 KB
  static const int err = static_cast<int>(cudaFuncSetAttribute(
      paged_decode_split_kernel<T, D, ALIGNED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<T, D>(MAXG, MAXL)));
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
      <<<dim3(nsplit, hk, b), NT, smem_bytes<T, D>(h / hk, split), s>>>(
          static_cast<const T*>(q), static_cast<const T*>(kp),
          static_cast<const T*>(vp), table, kv_len, pos, ws, h, hk, page, nsp,
          split, sm_scale * ra::LOG2E, qsb, qsh);
  paged_decode_combine_kernel<T, D>
      <<<dim3(((h / hk) * D + 2 * NT - 1) / (2 * NT), hk, b), NT, 0, s>>>(
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

// dtype: 0 = float32, 1 = bfloat16; d in {32, 64, 128, 256}; h / hk <= 16
// and (h / hk) * d <= 2048. Pools, table (b, nsp), kv_len (b,), pos_pages
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
  else if (dtype == 0 && d == 256) REPRO_PAGED(float, 256);
  else if (dtype == 1 && d == 32) REPRO_PAGED(__nv_bfloat16, 32);
  else if (dtype == 1 && d == 64) REPRO_PAGED(__nv_bfloat16, 64);
  else if (dtype == 1 && d == 128) REPRO_PAGED(__nv_bfloat16, 128);
  else if (dtype == 1 && d == 256) REPRO_PAGED(__nv_bfloat16, 256);
  else return static_cast<int>(cudaErrorInvalidValue);
#undef REPRO_PAGED
  return err ? err : static_cast<int>(cudaGetLastError());
}
