"""Public attention ops: the CUDA kernels on CUDA tensors, the plain
versions on the CPU (counterparts of ``repro.kernels.flash_attention.ops``).

``flash_attention_fwd`` launches ``csrc/flash_fwd.cu`` (prefill: o and lse);
``flash_attention`` returns its o. ``paged_decode_attention`` launches
``csrc/paged_decode.cu`` (one-token decode through a block table).
"""

from __future__ import annotations

import ctypes

import torch

from .._build import check, load, ptr, stream
from .ref import flash_fwd_ref, paged_decode_ref

__all__ = ["flash_attention", "flash_attention_fwd", "paged_decode_attention"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64)
_MAX_GROUP = 16                # paged decode: query heads per kv head
_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong

_FLASH_SIG = {"flash_fwd": ([_P] * 5 + [_I] * 8 + [_F] + [_L] * 9 + [_P], _I)}
_PAGED_SIG = {"paged_decode": ([_P] * 7 + [_I] * 7 + [_F, _L, _L, _P], _I)}


def _check_cuda(name, *ts):
    dev = ts[0].device
    for t in ts:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name}: every tensor must be on one CUDA "
                             f"device (got {[str(x.device) for x in ts]})")


def _check_qkv(name, q, k, v):
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name}: dtypes {q.dtype}/{k.dtype}/{v.dtype}; "
                         "all three must be float32 or bfloat16")
    d = q.shape[-1]
    if d not in _HEAD_DIMS or k.shape[-1] != d or v.shape[-1] != d:
        raise ValueError(f"{name}: head dims q {d}, k {k.shape[-1]}, "
                         f"v {v.shape[-1]}; the kernel takes equal head dims "
                         f"in {_HEAD_DIMS}")
    for t, n in ((q, "q"), (k, "k"), (v, "v")):
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: the last axis of {n} must be "
                             "contiguous")


def flash_attention_fwd(q, k, v, *, causal=True, sm_scale=None):
    """q (B, H, Sq, D); k, v (B, Hk, Skv, D) -> (o (B, H, Sq, D) in q's
    dtype, lse (B, H, Sq) f32). Queries are aligned to the end of the kv
    stream; ``causal`` masks keys after each query. Any Sq <= Skv."""
    if q.device.type == "cpu":
        return flash_fwd_ref(q, k, v, causal=causal, sm_scale=sm_scale)
    name = "flash_attention"
    _check_cuda(name, q, k, v)
    _check_qkv(name, q, k, v)
    b, h, sq, d = q.shape
    _, hk, skv, _ = k.shape
    if k.shape[0] != b or tuple(v.shape[:3]) != (b, hk, skv) or h % hk:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not agree "
                         "(GQA needs H a multiple of Hk)")
    if sq > skv or sq == 0:
        raise ValueError(f"{name}: need 0 < Sq <= Skv, got {sq}, {skv}")
    if sm_scale is None:
        sm_scale = 1.0 / d ** 0.5
    o = torch.empty((b, h, sq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    lib = load("flash_fwd", _FLASH_SIG)
    err = lib.flash_fwd(ptr(q), ptr(k), ptr(v), ptr(o), ptr(lse), b, h, hk,
                        sq, skv, d, _DTYPE_CODE[q.dtype], int(bool(causal)),
                        float(sm_scale), *q.stride()[:3], *k.stride()[:3],
                        *v.stride()[:3], stream())
    check(lib, err, "flash_fwd")
    flash_attention_fwd.launches += 1
    return o, lse


flash_attention_fwd.launches = 0


def flash_attention(q, k, v, *, causal=True, sm_scale=None):
    """Attention output of :func:`flash_attention_fwd` (lse dropped)."""
    return flash_attention_fwd(q, k, v, causal=causal, sm_scale=sm_scale)[0]


def paged_decode_attention(q, k_pages, v_pages, *, block_table, kv_len,
                           pos_pages, sm_scale=None):
    """q (B, H, 1, D) against page pools k/v (P, Hk, page, D), read through
    ``block_table`` (B, n_seq_pages) i32; ``kv_len`` (B,) i32 puts each
    query at position kv_len - 1; ``pos_pages`` (P, page) i32 holds each
    pool slot's absolute position (-1 = empty). A slot is visible when
    0 <= pos <= kv_len - 1. Returns (B, H, 1, D) in q's dtype."""
    if q.device.type == "cpu":
        return paged_decode_ref(q, k_pages, v_pages, block_table=block_table,
                                kv_len=kv_len, pos_pages=pos_pages,
                                sm_scale=sm_scale)
    name = "paged_decode_attention"
    _check_cuda(name, q, k_pages, v_pages, block_table, kv_len, pos_pages)
    _check_qkv(name, q, k_pages, v_pages)
    b, h, one, d = q.shape
    npages, hk, page, _ = k_pages.shape
    if one != 1:
        raise ValueError(f"{name}: expected one query token, got q "
                         f"{tuple(q.shape)}")
    if tuple(v_pages.shape) != tuple(k_pages.shape):
        raise ValueError(f"{name}: v pool {tuple(v_pages.shape)} != k pool "
                         f"{tuple(k_pages.shape)}")
    if h % hk or h // hk > _MAX_GROUP:
        raise ValueError(f"{name}: {h} query heads over {hk} kv heads; the "
                         f"kernel takes groups of at most {_MAX_GROUP}")
    if block_table.dim() != 2 or block_table.shape[0] != b:
        raise ValueError(f"{name}: block_table {tuple(block_table.shape)} "
                         f"must be ({b}, n_seq_pages)")
    if tuple(kv_len.shape) != (b,):
        raise ValueError(f"{name}: kv_len {tuple(kv_len.shape)} must be "
                         f"({b},)")
    if tuple(pos_pages.shape) != (npages, page):
        raise ValueError(f"{name}: pos_pages {tuple(pos_pages.shape)} must "
                         f"be ({npages}, {page})")
    for t, n in ((block_table, "block_table"), (kv_len, "kv_len"),
                 (pos_pages, "pos_pages")):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name}: {n} must be contiguous int32")
    for t, n in ((k_pages, "k_pages"), (v_pages, "v_pages")):
        if not t.is_contiguous():
            raise ValueError(f"{name}: {n} must be contiguous")
    if sm_scale is None:
        sm_scale = 1.0 / d ** 0.5
    o = torch.empty((b, h, 1, d), dtype=q.dtype, device=q.device)
    lib = load("paged_decode", _PAGED_SIG)
    err = lib.paged_decode(ptr(q), ptr(k_pages), ptr(v_pages),
                           ptr(block_table), ptr(kv_len), ptr(pos_pages),
                           ptr(o), b, h, hk, page, block_table.shape[1], d,
                           _DTYPE_CODE[q.dtype], float(sm_scale),
                           q.stride(0), q.stride(1), stream())
    check(lib, err, "paged_decode")
    paged_decode_attention.launches += 1
    return o


paged_decode_attention.launches = 0
