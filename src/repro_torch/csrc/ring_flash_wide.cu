// One step of sequence-parallel ring flash attention for Hopper at the wide
// head dims 112 (zamba2's shared block) and 256 (paligemma): the
// tensor-core forward and backward of ring_flash.cu, instantiated at those
// widths. A source of its own so that nvcc builds it beside ring_flash.cu,
// the slowest of the sources, rather than after it.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py:577
// ring_flash_fwd_builder and kernel.py:690 ring_flash_bwd_builder at those
// head dims, reached through pl.pallas_call at src/repro/core/lang.py:1076.
//
// The kernels are attn_fwd_sm90.cuh's fwd_tc_kernel<D, D, DeviceOffsets>
// and attn_bwd_sm90.cuh's dq_tc_kernel / dkv_tc_kernel<D, D, DeviceOffsets>
// (PR 27 widened them for flash_fwd_tc and flash_bwd_tc: d = 112 rounds its
// tiles up to 128 columns with zeros; at d = 256 the forward keeps O as two
// m64n128 halves and the backward splits dK and dV over twice the blocks).
// Offsets, masks, strides and outputs are ring_flash.cu's: see there.
#include "attn_bwd_sm90.cuh"
#include "attn_fwd_sm90.cuh"
#include "common.cuh"

using repro::attn::Masks;
using repro::attn::Strides;

// bf16 q, k and v with 16-byte aligned bases and strides (elements) that
// are multiples of 8; d in {112, 256}; otherwise as ring_flash.cu's
// ring_flash_fwd_tc.
extern "C" int ring_flash_fwd_tc(const void* q, const void* k, const void* v,
                                 const int* q_start, const int* k_start, void* o,
                                 float* lse, int b, int h, int hk, int sq, int skv, int d,
                                 int causal, int window, int prefix_len, float sm_scale,
                                 long long qsb, long long qsh, long long qss, long long ksb,
                                 long long ksh, long long kss, long long vsb, long long vsh,
                                 long long vss, void* stream) {
  const Strides st{qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, 0, 0, 0};
  const Masks mk{causal, window, prefix_len};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const repro::attn::DeviceOffsets off{q_start, k_start};
#define REPRO_RING_FWD_TC(D) \
  repro::attn::fwd::launch<D, D>(q, k, v, off, o, lse, b, h, hk, sq, skv, mk, sm_scale, st, s)
  cudaError_t e;
  if (d == 112) e = REPRO_RING_FWD_TC(112);
  else if (d == 256) e = REPRO_RING_FWD_TC(256);
  else e = cudaErrorInvalidValue;
#undef REPRO_RING_FWD_TC
  return static_cast<int>(e);
}

// As ring_flash.cu's ring_flash_bwd_tc at d in {112, 256}.
extern "C" int ring_flash_bwd_tc(const void* q, const void* k, const void* v,
                                 const void* dout, const float* lse, const float* delta,
                                 const int* q_start, const int* k_start, void* dq,
                                 float* dk, float* dv, int b, int h, int hk, int sq,
                                 int skv, int d, int causal, int window, int prefix_len,
                                 float sm_scale, long long qsb, long long qsh,
                                 long long qss, long long ksb, long long ksh,
                                 long long kss, long long vsb, long long vsh,
                                 long long vss, long long osb, long long osh,
                                 long long oss, void* stream) {
  const Strides st{qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss};
  const Masks mk{causal, window, prefix_len};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const repro::attn::DeviceOffsets off{q_start, k_start};
#define REPRO_RING_BWD_TC(D)                                                                \
  repro::attn::bwd::launch<D, D>(q, k, v, dout, lse, delta, off, dq, dk, dv, b, h, hk, sq, \
                                 skv, mk, sm_scale, st, s)
  cudaError_t e;
  if (d == 112) e = REPRO_RING_BWD_TC(112);
  else if (d == 256) e = REPRO_RING_BWD_TC(256);
  else e = cudaErrorInvalidValue;
#undef REPRO_RING_BWD_TC
  return static_cast<int>(e);
}
