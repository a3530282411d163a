// Paged single-token decode attention for Hopper.
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
// the card needs to leave the memory roofline.
// What the design does about it: one block per (kv head, sequence) computes
// all g = h / hk query heads of the group, so each page is read from HBM
// once (the TPU grid (b, h, nsp) re-reads it per query head). The block reads
// block_table itself (this replaces scalar prefetch), walks pages in logical
// order (the in-order online softmax keeps paged == contiguous), stops at the
// first page past q_pos, and skips any 32-slot chunk whose positions are all
// masked before loading its K/V. Idle slots (len 0, table of zeros) read
// only the null page, whose positions are pinned to -1, and yield exact 0.
#include "common.cuh"

namespace {

constexpr int KC = 32;    // slots per chunk (one warp lane each in softmax)
constexpr int NT = 128;
constexpr int MAXG = 16;  // query heads per kv head
constexpr int PER = 8;    // accumulator elements per thread: g * d <= NT * PER

template <typename T, int D>
__global__ void __launch_bounds__(NT) paged_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ kp, const T* __restrict__ vp,
    const int* __restrict__ table, const int* __restrict__ kv_len,
    const int* __restrict__ pos_pages, T* __restrict__ o, int h, int hk,
    int page, int nsp, float sm_scale, long long qsb, long long qsh) {
  __shared__ float qs[MAXG][D];
  __shared__ float ks[KC][D + 1];
  __shared__ float vs[KC][D];
  __shared__ float ss[MAXG][KC];
  __shared__ int ok_s[KC];
  __shared__ float m_s[MAXG], l_s[MAXG], corr_s[MAXG];
  const int g = h / hk;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int kh = blockIdx.x, bi = blockIdx.y;
  const int q_pos = kv_len[bi] - 1;
  const int cap = nsp * page;

  for (int e = t; e < g * D; e += NT) {
    const int gi = e / D, dd = e % D;
    qs[gi][dd] = repro::to_f32(q[bi * qsb + (long long)(kh * g + gi) * qsh + dd]);
  }
  if (t < g) {
    m_s[t] = -CUDART_INF_F;
    l_s[t] = 0.f;
  }
  float acc[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) acc[i] = 0.f;
  __syncthreads();

  for (int j = 0; j < nsp; ++j) {
    // logical page j holds positions >= j * page while the cache is unwrapped
    if (j * page > q_pos && q_pos < cap) break;
    const long long pp = table[bi * nsp + j];
    const T* kb = kp + (pp * hk + kh) * page * D;
    const T* vb = vp + (pp * hk + kh) * page * D;
    const int* pb = pos_pages + pp * page;
    for (int c0 = 0; c0 < page; c0 += KC) {
      const int n = min(KC, page - c0);
      int ok = 0;
      if (t < KC) {
        const int pos = t < n ? pb[c0 + t] : -1;
        ok = pos >= 0 && pos <= q_pos;
        ok_s[t] = ok;
      }
      // a chunk with no visible slot is an exact no-op of the online softmax
      if (!__syncthreads_or(ok)) continue;
      for (int e = t; e < n * D; e += NT) {
        const int jj = e / D, dd = e % D;
        ks[jj][dd] = repro::to_f32(kb[(c0 + jj) * D + dd]);
        vs[jj][dd] = repro::to_f32(vb[(c0 + jj) * D + dd]);
      }
      __syncthreads();
      for (int e = t; e < g * KC; e += NT) {
        const int gi = e / KC, jj = e % KC;
        float s = -CUDART_INF_F;
        if (jj < n && ok_s[jj]) {
          float dot = 0.f;
#pragma unroll
          for (int dd = 0; dd < D; ++dd) dot += qs[gi][dd] * ks[jj][dd];
          s = dot * sm_scale;
        }
        ss[gi][jj] = s;
      }
      __syncthreads();
      for (int gi = warp; gi < g; gi += NT / 32) {  // one warp per head
        const float s = ss[gi][lane];
        const float m_old = m_s[gi];
        const float m_new = fmaxf(m_old, repro::warp_max(s));
        const float corr = (m_old == -CUDART_INF_F) ? 0.f : expf(m_old - m_new);
        const float p = (s == -CUDART_INF_F) ? 0.f : expf(s - m_new);
        const float sum = repro::warp_sum(p);
        ss[gi][lane] = p;
        if (lane == 0) {
          l_s[gi] = l_s[gi] * corr + sum;
          m_s[gi] = m_new;
          corr_s[gi] = corr;
        }
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int e = t + NT * i;
        if (e < g * D) {
          const int gi = e / D, dd = e % D;
          float a = acc[i] * corr_s[gi];
          for (int jj = 0; jj < n; ++jj) a += ss[gi][jj] * vs[jj][dd];
          acc[i] = a;
        }
      }
      __syncthreads();  // before the next chunk overwrites ok_s/ks/vs/ss
    }
  }
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int e = t + NT * i;
    if (e < g * D) {
      const int gi = e / D, dd = e % D;
      const float l = l_s[gi];
      o[((long long)bi * h + kh * g + gi) * D + dd] =
          repro::from_f32<T>(acc[i] / (l == 0.f ? 1.f : l));
    }
  }
}

template <typename T, int D>
void launch(const void* q, const void* kp, const void* vp, const int* table,
            const int* kv_len, const int* pos, void* o, int b, int h, int hk,
            int page, int nsp, float sm_scale, long long qsb, long long qsh,
            cudaStream_t stream) {
  dim3 grid(hk, b);
  paged_decode_kernel<T, D><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), table, kv_len, pos, static_cast<T*>(o), h, hk,
      page, nsp, sm_scale, qsb, qsh);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; d in {32, 64, 128}; h / hk <= 16 and
// (h / hk) * d <= NT * PER = 1024. Pools, table (b, nsp), kv_len (b,),
// pos_pages (P, page) and o (b, h, 1, d) are contiguous; q takes element
// strides for its batch and head axes.
extern "C" int paged_decode(const void* q, const void* kp, const void* vp,
                            const int* table, const int* kv_len,
                            const int* pos_pages, void* o, int b, int h,
                            int hk, int page, int nsp, int d, int dtype,
                            float sm_scale, long long qsb, long long qsh,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (h % hk != 0 || h / hk > MAXG || (h / hk) * d > NT * PER)
    return static_cast<int>(cudaErrorInvalidValue);
#define REPRO_PAGED(T, D)                                                   \
  launch<T, D>(q, kp, vp, table, kv_len, pos_pages, o, b, h, hk, page, nsp, \
               sm_scale, qsb, qsh, s)
  if (dtype == 0 && d == 32) REPRO_PAGED(float, 32);
  else if (dtype == 0 && d == 64) REPRO_PAGED(float, 64);
  else if (dtype == 0 && d == 128) REPRO_PAGED(float, 128);
  else if (dtype == 1 && d == 32) REPRO_PAGED(__nv_bfloat16, 32);
  else if (dtype == 1 && d == 64) REPRO_PAGED(__nv_bfloat16, 64);
  else if (dtype == 1 && d == 128) REPRO_PAGED(__nv_bfloat16, 128);
  else return static_cast<int>(cudaErrorInvalidValue);
#undef REPRO_PAGED
  return static_cast<int>(cudaGetLastError());
}
