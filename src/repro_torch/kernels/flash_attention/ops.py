"""Public attention ops: the kernels on CUDA tensors, the plain versions
on the CPU (counterparts of ``repro.kernels.flash_attention.ops``).

``flash_attention_fwd`` launches ``csrc/flash_fwd.cu`` (prefill: o and
lse). ``flash_attention`` is the differentiable op: a
``torch.autograd.Function`` whose forward is ``flash_attention_fwd`` and
whose backward (``flash_attention_bwd``) runs ``flash_delta`` (Triton,
``delta.py``) and then ``flash_bwd`` (``csrc/flash_bwd.cu``), as the JAX
op's ``_bwd`` runs the delta and fused backward kernels. Both devices go
through the same Function; on the CPU each step is its plain version.
``paged_decode_attention`` launches ``csrc/paged_decode.cu`` (one-token
decode through a block table).
"""

from __future__ import annotations

import ctypes

import torch

from .._build import check, load, on_cpu, ptr, stream
from . import delta as delta_kernel
from .ref import (flash_bwd_ref, flash_delta_ref, flash_fwd_ref,
                  paged_decode_ref)

__all__ = ["flash_attention", "flash_attention_fwd", "flash_attention_bwd",
           "flash_delta", "flash_bwd", "paged_decode_attention"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64)
_MAX_GROUP = 16                # paged decode: query heads per kv head
_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong

_FLASH_SIG = {"flash_fwd": ([_P] * 5 + [_I] * 8 + [_F] + [_L] * 9 + [_P], _I)}
_BWD_SIG = {"flash_bwd": ([_P] * 9 + [_I] * 8 + [_F] + [_L] * 12 + [_P], _I)}
_PAGED_SIG = {"paged_decode": ([_P] * 7 + [_I] * 7 + [_F, _L, _L, _P], _I)}


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


def _check_gqa(name, q, k, v):
    b, h = q.shape[:2]
    _, hk, skv, _ = k.shape
    if k.shape[0] != b or tuple(v.shape[:3]) != (b, hk, skv) or h % hk:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not agree "
                         "(GQA needs H a multiple of Hk)")


def _no_grad_asked(name, *ts):
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise RuntimeError(
            f"{name} records no autograd graph; call it under "
            "torch.no_grad() or use the differentiable op")


def flash_attention_fwd(q, k, v, *, causal=True, sm_scale=None):
    """q (B, H, Sq, D); k, v (B, Hk, Skv, D) -> (o (B, H, Sq, D) in q's
    dtype, lse (B, H, Sq) f32). Queries are aligned to the end of the kv
    stream; ``causal`` masks keys after each query. Any Sq <= Skv."""
    name = "flash_attention_fwd"
    _no_grad_asked(name, q, k, v)
    if on_cpu(name, q, k, v):
        return flash_fwd_ref(q, k, v, causal=causal, sm_scale=sm_scale)
    _check_qkv(name, q, k, v)
    _check_gqa(name, q, k, v)
    b, h, sq, d = q.shape
    _, hk, skv, _ = k.shape
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


def flash_delta(do, o):
    """delta = rowsum(do * o) in f32: do, o (B, H, Sq, D) -> (B, H, Sq)."""
    name = "flash_delta"
    _no_grad_asked(name, do, o)
    if on_cpu(name, do, o):
        return flash_delta_ref(do, o)
    if do.shape != o.shape or do.dim() != 4:
        raise ValueError(f"{name}: do {tuple(do.shape)} and o "
                         f"{tuple(o.shape)} must be one (B, H, Sq, D) shape")
    if do.dtype not in _DTYPE_CODE or o.dtype not in _DTYPE_CODE:
        raise ValueError(f"{name}: dtypes {do.dtype}/{o.dtype} must be "
                         "float32 or bfloat16")
    if do.stride(-1) != 1 or o.stride(-1) != 1:
        raise ValueError(f"{name}: the last axes must be contiguous")
    b, h, sq, _ = do.shape
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=do.device)
    delta_kernel.launch(do, o, delta)
    flash_delta.launches += 1
    return delta


flash_delta.launches = 0


def flash_bwd(q, k, v, do, lse, delta, *, causal=True, sm_scale=None):
    """dq (B, H, Sq, D) in q's dtype and dk, dv (B, Hk, Skv, D) f32, summed
    over each kv head's query-head group, from the forward's lse and
    :func:`flash_delta`'s delta (both (B, H, Sq) f32). Queries are aligned
    to the end of the kv stream; any Sq and Skv (a query that sees no key
    contributes nothing)."""
    name = "flash_bwd"
    _no_grad_asked(name, q, k, v, do)
    if on_cpu(name, q, k, v, do, lse, delta):
        return flash_bwd_ref(q, k, v, do, lse, delta, causal=causal,
                             sm_scale=sm_scale)
    _check_qkv(name, q, k, v)
    _check_gqa(name, q, k, v)
    b, h, sq, d = q.shape
    _, hk, skv, _ = k.shape
    if do.shape != q.shape or do.dtype != q.dtype or do.stride(-1) != 1:
        raise ValueError(f"{name}: do {tuple(do.shape)} {do.dtype} must "
                         f"match q {tuple(q.shape)} {q.dtype}, last axis "
                         "contiguous")
    for t, n in ((lse, "lse"), (delta, "delta")):
        if (tuple(t.shape) != (b, h, sq) or t.dtype != torch.float32
                or not t.is_contiguous()):
            raise ValueError(f"{name}: {n} must be contiguous f32 "
                             f"({b}, {h}, {sq}), got {tuple(t.shape)} "
                             f"{t.dtype}")
    if sm_scale is None:
        sm_scale = 1.0 / d ** 0.5
    dev = q.device
    dq = torch.empty((b, h, sq, d), dtype=q.dtype, device=dev)
    dk = torch.empty((b, hk, skv, d), dtype=torch.float32, device=dev)
    dv = torch.empty((b, hk, skv, d), dtype=torch.float32, device=dev)
    lib = load("flash_bwd", _BWD_SIG)
    err = lib.flash_bwd(ptr(q), ptr(k), ptr(v), ptr(do), ptr(lse), ptr(delta),
                        ptr(dq), ptr(dk), ptr(dv), b, h, hk, sq, skv, d,
                        _DTYPE_CODE[q.dtype], int(bool(causal)),
                        float(sm_scale), *q.stride()[:3], *k.stride()[:3],
                        *v.stride()[:3], *do.stride()[:3], stream())
    check(lib, err, "flash_bwd")
    flash_bwd.launches += 1
    return dq, dk, dv


flash_bwd.launches = 0


def flash_attention_bwd(q, k, v, o, do, lse, *, causal=True, sm_scale=None):
    """The backward host path (``kernel.py:317`` of the JAX package): delta,
    then dq/dk/dv; dk and dv come group-summed out of :func:`flash_bwd` and
    are cast to k's and v's dtypes here. Returns (dq, dk, dv)."""
    do = do.to(q.dtype)
    if do.stride(-1) != 1:
        do = do.contiguous()
    delta = flash_delta(do, o)
    dq, dk, dv = flash_bwd(q, k, v, do, lse, delta, causal=causal,
                           sm_scale=sm_scale)
    return dq, dk.to(k.dtype), dv.to(v.dtype)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        o, lse = flash_attention_fwd(q, k, v, causal=causal,
                                     sm_scale=sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do, lse,
                                         causal=ctx.causal,
                                         sm_scale=ctx.sm_scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal=True, sm_scale=None):
    """Differentiable attention: the o of :func:`flash_attention_fwd`, with
    the saved (q, k, v, o, lse) feeding :func:`flash_attention_bwd`."""
    return _FlashAttention.apply(q, k, v, causal, sm_scale)


def paged_decode_attention(q, k_pages, v_pages, *, block_table, kv_len,
                           pos_pages, sm_scale=None):
    """q (B, H, 1, D) against page pools k/v (P, Hk, page, D), read through
    ``block_table`` (B, n_seq_pages) i32; ``kv_len`` (B,) i32 puts each
    query at position kv_len - 1; ``pos_pages`` (P, page) i32 holds each
    pool slot's absolute position (-1 = empty). A slot is visible when
    0 <= pos <= kv_len - 1. Returns (B, H, 1, D) in q's dtype."""
    name = "paged_decode_attention"
    if on_cpu(name, q, k_pages, v_pages, block_table, kv_len, pos_pages):
        return paged_decode_ref(q, k_pages, v_pages, block_table=block_table,
                                kv_len=kv_len, pos_pages=pos_pages,
                                sm_scale=sm_scale)
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
