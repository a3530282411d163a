"""Public attention ops: the kernels on CUDA tensors, the plain versions
on the CPU (counterparts of ``repro.kernels.flash_attention.ops``).

``flash_attention_fwd`` launches ``csrc/flash_fwd.cu`` (prefill: o and
lse; causal and/or a sliding window). ``flash_attention`` is the
differentiable op: a ``torch.autograd.Function`` whose forward is
``flash_attention_fwd`` and whose backward (``flash_attention_bwd``) runs
``flash_delta`` (Triton, ``delta.py``) and then ``flash_bwd``
(``csrc/flash_bwd.cu``), as the JAX op's ``_bwd`` runs the delta and fused
backward kernels. Both devices go through the same Function; on the CPU
each step is its plain version. On the card the backward's CUDA-core
kernel has no window mask and takes head dims up to 64, so
``flash_attention`` raises before the forward when a gradient is asked of
a windowed or d = 128 call whose inputs would take that kernel (f32, or
bf16 the 16-byte copies cannot read); the tensor-core backward takes both.
``flash_decode`` launches
``csrc/flash_decode.cu`` (one-token decode against a contiguous or rotated
rolling cache: the JAX package's ``flash_decode`` op and its
``decode_attention`` entry; ``kv_len`` an int or a one-element int32 tensor
read on the device) and
``paged_decode_attention`` launches ``csrc/paged_decode.cu`` (one-token
decode through a block table). Both are split-KV: the slots cut into
ranges by :func:`decode_split` (:func:`paged_split` for a block table), a
split kernel and a merge kernel from one entry point. ``ring_flash_fwd`` and ``ring_flash_bwd``
launch ``csrc/ring_flash.cu``: one step of ring attention (a query shard
against one kv chunk at absolute offsets read on the device) and its
backward; ``ring.py`` builds the ring schedule on them.

``flash_attention_fwd``, ``flash_bwd``, ``ring_flash_fwd`` and
``ring_flash_bwd`` each have two kernels on the card and pick one up front,
by :func:`route` (dtype and layout alone, never after a failure):
``"wgmma"``, the tensor-core kernel (``flash_fwd_tc``, ``flash_bwd_tc``,
``ring_flash_fwd_tc``, ``ring_flash_bwd_tc``: bf16 operands copied with
cp.async into swizzled shared memory, products on wgmma; the two forwards
share one kernel, ``csrc/attn_fwd_sm90.cuh``, and the two backwards theirs,
``csrc/attn_bwd_sm90.cuh``), or ``"simt"``, the CUDA-core kernel.
``wrapper.routes`` counts the launches by route.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .._build import check, load, on_cpu, ptr, stream
from . import delta as delta_kernel
from .ref import (decode_ref, flash_bwd_ref, flash_delta_ref, flash_fwd_ref,
                  paged_decode_ref, ring_bwd_ref, ring_fwd_ref)

__all__ = ["flash_attention", "flash_attention_fwd", "flash_attention_bwd",
           "flash_delta", "flash_bwd", "flash_decode", "decode_split",
           "paged_decode_attention", "paged_split", "ring_flash_fwd",
           "ring_flash_bwd", "route"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)     # flash_fwd, paged_decode
_DECODE_HEAD_DIMS = (32, 64, 112, 128, 256)    # flash_decode
# flash_bwd by route
_BWD_HEAD_DIMS = {"wgmma": (32, 64, 128), "simt": (32, 64)}
# ring_flash_bwd by route (ring.py reads it): the same kernels' head dims
RING_BWD_HEAD_DIMS = _BWD_HEAD_DIMS
_MAX_GROUP = 16                # decode kernels: query heads per kv head
_MAX_GROUP_DIM = 1024          # paged decode: (query heads per kv head) * d
_DECODE_MAX_GROUP_DIM = 2048   # flash_decode: the same
_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong

_FLASH_SIG = {"flash_fwd": ([_P] * 5 + [_I] * 9 + [_F] + [_L] * 9 + [_P], _I),
              "flash_fwd_tc": ([_P] * 5 + [_I] * 8 + [_F] + [_L] * 9 + [_P],
                               _I)}
_BWD_SIG = {"flash_bwd": ([_P] * 9 + [_I] * 8 + [_F] + [_L] * 12 + [_P], _I),
            "flash_bwd_tc": ([_P] * 9 + [_I] * 8 + [_F] + [_L] * 12 + [_P],
                             _I)}
_DECODE_SIG = {"flash_decode": ([_P] * 7 + [_I] * 9 + [_F] + [_L] * 6 + [_P],
                                _I)}
_DECODE_ENTRY = None           # (library, its flash_decode), bound on first use
_PAGED_SIG = {"paged_decode": ([_P] * 8 + [_I] * 8 + [_F, _L, _L, _P], _I)}
# paged decode's split rule (csrc/paged_decode.cu: KT slots a tile, MAXL a
# split): enough blocks for several on each of the H100's 132 SMs, since a
# decode step's ragged sequences leave the splits past their ends empty
# (16 x 132 gives the serving path's 8 x 8 splits of 64 slots, the fastest
# of 32-512 on the card)
_PAGED_TILE, _PAGED_MAX_SPLIT, _PAGED_BLOCKS = 32, 512, 16 * 132
# flash_decode's (csrc/flash_decode.cu: at most 512 slots a split): ~8 x 132
# blocks, a power of two of at least 64 slots (tools/ab_decode_scan.py
# --splits on the H100: musicgen's 8 x 24 x 576 ran fastest at 128 and 256,
# paligemma's 8 x 1 x 576 at 64; 96 and 192 ran slower than 128)
_DECODE_BLOCKS, _DECODE_MIN_SPLIT, _DECODE_MAX_SPLIT = 8 * 132, 64, 512
_RING_SIG = {
    "ring_flash_fwd": ([_P] * 7 + [_I] * 10 + [_F] + [_L] * 9 + [_P], _I),
    "ring_flash_fwd_tc": ([_P] * 7 + [_I] * 9 + [_F] + [_L] * 9 + [_P], _I),
    "ring_flash_bwd": ([_P] * 11 + [_I] * 10 + [_F] + [_L] * 12 + [_P], _I),
    "ring_flash_bwd_tc": ([_P] * 11 + [_I] * 9 + [_F] + [_L] * 12 + [_P],
                          _I),
}


def route(*ts) -> str:
    """The kernel a CUDA call of :func:`flash_attention_fwd` or
    :func:`ring_flash_fwd` (on q, k, v), :func:`flash_bwd` or
    :func:`ring_flash_bwd` (on q, k, v, do) launches,
    from dtype and layout alone: ``"wgmma"`` (the tensor-core kernel) when
    every tensor is bf16 with its last axis contiguous, its base 16-byte
    aligned and every other stride a multiple of 8 elements (each row a
    whole number of the 16-byte copies the kernel issues), else ``"simt"``
    (the CUDA-core kernel: f32 inputs and other bf16 layouts)."""
    return "wgmma" if all(map(_copyable, ts)) else "simt"


def _copyable(t):
    st = t.stride()
    return (t.dtype == torch.bfloat16 and st[-1] == 1
            and t.data_ptr() % 16 == 0 and not any(x % 8 for x in st[:-1]))


def _check_qkv(name, q, k, v, head_dims=_HEAD_DIMS):
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name}: dtypes {q.dtype}/{k.dtype}/{v.dtype}; "
                         "all three must be float32 or bfloat16")
    d = q.shape[-1]
    if d not in head_dims or k.shape[-1] != d or v.shape[-1] != d:
        raise ValueError(f"{name}: head dims q {d}, k {k.shape[-1]}, "
                         f"v {v.shape[-1]}; the kernel takes equal head dims "
                         f"in {head_dims}")
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


def _check_group(name, h, hk, d, max_gd=_MAX_GROUP_DIM):
    if h % hk or h // hk > _MAX_GROUP or (h // hk) * d > max_gd:
        raise ValueError(f"{name}: {h} query heads over {hk} kv heads at "
                         f"head dim {d}; the kernel takes groups of at most "
                         f"{_MAX_GROUP} heads with group * d <= {max_gd}")


def _grad_asked(*ts):
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _no_grad_asked(name, *ts):
    if _grad_asked(*ts):
        raise RuntimeError(
            f"{name} records no autograd graph; call it under "
            "torch.no_grad() or use the differentiable op")


def _window(name, window):
    if window is None:
        return 0
    if int(window) <= 0:
        raise ValueError(f"{name}: window must be positive, got {window}")
    return int(window)


def flash_attention_fwd(q, k, v, *, causal=True, window=None, sm_scale=None):
    """q (B, H, Sq, D); k, v (B, Hk, Skv, D) -> (o (B, H, Sq, D) in q's
    dtype, lse (B, H, Sq) f32). Queries are aligned to the end of the kv
    stream; ``causal`` masks keys after each query, ``window`` keys at
    q_pos - k_pos >= window. Any Sq <= Skv. On the card the kernel is
    the tensor-core one when :func:`route` says ``"wgmma"``."""
    name = "flash_attention_fwd"
    _no_grad_asked(name, q, k, v)
    if on_cpu(name, q, k, v):
        return flash_fwd_ref(q, k, v, causal=causal, window=window,
                             sm_scale=sm_scale)
    win = _window(name, window)
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
    path = route(q, k, v)
    args = (b, h, hk, sq, skv, d)
    tail = (int(bool(causal)), win, float(sm_scale), *q.stride()[:3],
            *k.stride()[:3], *v.stride()[:3], stream())
    if path == "wgmma":
        err = lib.flash_fwd_tc(ptr(q), ptr(k), ptr(v), ptr(o), ptr(lse),
                               *args, *tail)
    else:
        err = lib.flash_fwd(ptr(q), ptr(k), ptr(v), ptr(o), ptr(lse), *args,
                            _DTYPE_CODE[q.dtype], *tail)
    check(lib, err, f"flash_fwd ({path})")
    flash_attention_fwd.launches += 1
    flash_attention_fwd.routes[path] += 1
    return o, lse


flash_attention_fwd.launches = 0
flash_attention_fwd.routes = {"wgmma": 0, "simt": 0}


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


def flash_bwd(q, k, v, do, lse, delta, *, causal=True, window=None,
              sm_scale=None):
    """dq (B, H, Sq, D) in q's dtype and dk, dv (B, Hk, Skv, D) f32, summed
    over each kv head's query-head group, from the forward's lse and
    :func:`flash_delta`'s delta (both (B, H, Sq) f32). Queries are aligned
    to the end of the kv stream; any Sq and Skv (a query that sees no key
    contributes nothing); ``causal`` and ``window`` as in
    :func:`flash_attention_fwd`. On the card :func:`route` (of q, k, v, do)
    picks the kernel: head dims ``_BWD_HEAD_DIMS[route]``, and a window
    only on the tensor-core route."""
    name = "flash_bwd"
    _no_grad_asked(name, q, k, v, do)
    if on_cpu(name, q, k, v, do, lse, delta):
        return flash_bwd_ref(q, k, v, do, lse, delta, causal=causal,
                             window=window, sm_scale=sm_scale)
    win = _window(name, window)
    if do.shape != q.shape or do.dtype != q.dtype or do.stride(-1) != 1:
        raise ValueError(f"{name}: do {tuple(do.shape)} {do.dtype} must "
                         f"match q {tuple(q.shape)} {q.dtype}, last axis "
                         "contiguous")
    path = route(q, k, v, do)
    _check_qkv(name, q, k, v, _BWD_HEAD_DIMS[path])
    if win and path == "simt":
        raise ValueError(f"{name}: window={window} on the CUDA-core kernel "
                         "(f32, or bf16 rows the 16-byte copies cannot "
                         "read), which has no window mask")
    _check_gqa(name, q, k, v)
    b, h, sq, d = q.shape
    _, hk, skv, _ = k.shape
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
    ptrs = (ptr(q), ptr(k), ptr(v), ptr(do), ptr(lse), ptr(delta), ptr(dq),
            ptr(dk), ptr(dv), b, h, hk, sq, skv, d)
    strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
               *do.stride()[:3])
    if path == "wgmma":
        err = lib.flash_bwd_tc(*ptrs, int(bool(causal)), win,
                               float(sm_scale), *strides, stream())
    else:
        err = lib.flash_bwd(*ptrs, _DTYPE_CODE[q.dtype], int(bool(causal)),
                            float(sm_scale), *strides, stream())
    check(lib, err, f"{name} ({path})")
    flash_bwd.launches += 1
    flash_bwd.routes[path] += 1
    return dq, dk, dv


flash_bwd.launches = 0
flash_bwd.routes = {"wgmma": 0, "simt": 0}


def flash_attention_bwd(q, k, v, o, do, lse, *, causal=True, window=None,
                        sm_scale=None):
    """The backward host path (``kernel.py:317`` of the JAX package): delta,
    then dq/dk/dv; dk and dv come group-summed out of :func:`flash_bwd` and
    are cast to k's and v's dtypes here. The cotangent is taken in q's
    dtype with its last axis contiguous; on the card, where q, k and v take
    the tensor-core route, a cotangent the 16-byte copies cannot read is
    copied first, so the backward's route is theirs (the one
    :func:`flash_attention` checked before the forward). Returns (dq, dk,
    dv)."""
    do = do.to(q.dtype)
    if do.stride(-1) != 1:
        do = do.contiguous()
    if q.is_cuda and route(q, k, v) == "wgmma" and route(do) == "simt":
        do = do.clone(memory_format=torch.contiguous_format)
    delta = flash_delta(do, o)
    dq, dk, dv = flash_bwd(q, k, v, do, lse, delta, causal=causal,
                           window=window, sm_scale=sm_scale)
    return dq, dk.to(k.dtype), dv.to(v.dtype)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, sm_scale):
        o, lse = flash_attention_fwd(q, k, v, causal=causal, window=window,
                                     sm_scale=sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window, ctx.sm_scale = causal, window, sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do, lse,
                                         causal=ctx.causal,
                                         window=ctx.window,
                                         sm_scale=ctx.sm_scale)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal=True, window=None, sm_scale=None):
    """Differentiable attention: the o of :func:`flash_attention_fwd`, with
    the saved (q, k, v, o, lse) feeding :func:`flash_attention_bwd`. On the
    card the backward's route is :func:`route` of q, k and v: when a
    gradient is asked and that route's kernel cannot take the call (the
    CUDA-core backward: head dims 32 and 64, no window), this raises before
    the forward runs instead of returning a wrong gradient or failing late.
    """
    if not _grad_asked(q, k, v):
        return flash_attention_fwd(q, k, v, causal=causal, window=window,
                                   sm_scale=sm_scale)[0]
    if not on_cpu("flash_attention", q, k, v):
        path, d = route(q, k, v), q.shape[-1]
        if d not in _BWD_HEAD_DIMS[path] or (window is not None
                                             and path == "simt"):
            raise NotImplementedError(
                f"flash_attention: no backward kernel for window={window}, "
                f"head dim {d} on the {path!r} route (flash_bwd takes head "
                f"dims {_BWD_HEAD_DIMS['simt']} and no window on the "
                f"CUDA-core route, head dims {_BWD_HEAD_DIMS['wgmma']} and "
                "windows for bf16 inputs with 16-byte rows); call it under "
                "torch.no_grad()")
    return _FlashAttention.apply(q, k, v, causal, window, sm_scale)


def _decode_check(name, q, k, v, kv_len, slot_pos):
    """The wrapper's checks for flash_decode on the card."""
    _check_qkv(name, q, k, v, _DECODE_HEAD_DIMS)
    _check_gqa(name, q, k, v)
    b, h, one, d = q.shape
    _, hk, skv, _ = k.shape
    if one != 1:
        raise ValueError(f"{name}: expected one query token, got q "
                         f"{tuple(q.shape)}")
    _check_group(name, h, hk, d, _DECODE_MAX_GROUP_DIM)
    for t, n in ((k, "k"), (v, "v")):
        if (t.stride(-2) != d or t.data_ptr() % 16
                or (t.stride(0) * t.element_size()) % 16
                or (t.stride(1) * t.element_size()) % 16):
            raise ValueError(f"{name}: the (skv, d) rows of {n} must be "
                             "contiguous and 16-byte aligned")
    if slot_pos is not None and (
            tuple(slot_pos.shape) != (skv,) or slot_pos.dtype != torch.int32
            or not slot_pos.is_contiguous()):
        raise ValueError(f"{name}: slot_pos must be contiguous int32 "
                         f"({skv},), got {tuple(slot_pos.shape)} "
                         f"{slot_pos.dtype}")
    if torch.is_tensor(kv_len) and (kv_len.numel() != 1
                                    or kv_len.dtype != torch.int32):
        raise ValueError(f"{name}: a kv_len tensor must be one int32 "
                         f"element, got {tuple(kv_len.shape)} {kv_len.dtype}")


def _decode_entry():
    global _DECODE_ENTRY
    if _DECODE_ENTRY is None:
        lib = load("flash_decode", _DECODE_SIG)
        _DECODE_ENTRY = (lib, lib.flash_decode)
    return _DECODE_ENTRY


def flash_decode(q, k, v, *, kv_len=None, slot_pos=None, window=None,
                 sm_scale=None):
    """q (B, H, 1, D) against a contiguous cache k, v (B, Hk, S, D) ->
    (B, H, 1, D) in q's dtype. ``kv_len`` (default S) puts the query at
    position kv_len - 1: an int, or a one-element int32 tensor on q's
    device, as the JAX op takes a traced scalar, which the kernel reads on
    the device (the wrapper never reads it on the host). ``slot_pos``
    ((S,) int32, -1 = empty) holds each slot's absolute position (rotated
    rolling-window caches; omitted, slot i holds position i). A slot is
    visible when 0 <= pos <= kv_len - 1 and kv_len - 1 - pos < ``window``;
    a row that sees no slot gives 0 (:func:`decode_ref`). On the card the
    kernel splits the slots by :func:`decode_split` and merges the splits'
    partials (:func:`decode_split_ref` is its plain model). Head dims 32,
    64, 112, 128 and 256, groups of up to 16 query heads with group * d <=
    2048."""
    name = "flash_decode"
    dev_len = torch.is_tensor(kv_len)
    if on_cpu(name, q, k, v, slot_pos, kv_len if dev_len else None):
        return decode_ref(q, k, v, window=window, sm_scale=sm_scale,
                          kv_len=kv_len, slot_pos=slot_pos)
    win = _window(name, window)
    _decode_check(name, q, k, v, kv_len, slot_pos)
    b, h, _, d = q.shape
    hk, skv = k.shape[1], k.shape[2]
    split, nsplit = decode_split(b, hk, skv)
    o = torch.empty((b, h, 1, d), dtype=q.dtype, device=q.device)
    ws = torch.empty(b * h * nsplit * (d + 2), dtype=torch.float32,
                     device=q.device)
    lib, fn = _decode_entry()
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
             None if slot_pos is None else slot_pos.data_ptr(),
             kv_len.data_ptr() if dev_len else None, o.data_ptr(),
             ws.data_ptr(), b, h, hk, skv, d, _DTYPE_CODE[q.dtype],
             0 if dev_len else skv if kv_len is None else int(kv_len), win,
             split, d ** -0.5 if sm_scale is None else sm_scale,
             q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0),
             v.stride(1), stream())
    if err:
        check(lib, err, name)
    flash_decode.launches += 1
    return o


flash_decode.launches = 0


@functools.lru_cache(maxsize=64)
def decode_split(b, hk, skv):
    """(split, nsplit) of flash_decode over ``skv`` slots of each
    (sequence, kv head): each block takes ``split`` consecutive slots, a
    power of two in [64, 512], and the slots make ``nsplit`` ranges. Read
    from the shapes alone (never from ``kv_len``, which may stay on the
    device): ~8 x 132 blocks in all, since the ranges past the query exit
    at once. The workspace holds ``b * h * nsplit * (d + 2)`` f32: (m, l)
    and ``acc[d]`` for each query head of each range."""
    want = -(-_DECODE_BLOCKS // (b * hk))
    split = max(-(-skv // want), _DECODE_MIN_SPLIT)
    split = min(1 << (split - 1).bit_length(), _DECODE_MAX_SPLIT)
    return split, -(-skv // split)


@functools.lru_cache(maxsize=64)
def paged_split(b, hk, nsp, page):
    """(split, nsplit) of paged decode at these shapes: each block of the
    kernel takes ``split`` consecutive logical slots of one (sequence, kv
    head), a multiple of the 32-slot tile in [32, 512], and the
    ``nsp * page`` slots of a block table make ``nsplit`` ranges. Read from
    the shapes alone (never from ``kv_len`` or the table, which stay on the
    device): ~16 x 132 blocks in all, since the ranges past each
    sequence's end exit at once. The workspace holds ``b * h * nsplit * (d + 2)`` f32:
    (m, l) and ``acc[d]`` for each query head of each range."""
    cap = nsp * page
    want = -(-_PAGED_BLOCKS // (b * hk))
    split = -(-cap // want)
    split = -(-split // _PAGED_TILE) * _PAGED_TILE
    split = min(max(split, _PAGED_TILE), _PAGED_MAX_SPLIT)
    return split, -(-cap // split)


def paged_decode_attention(q, k_pages, v_pages, *, block_table, kv_len,
                           pos_pages, sm_scale=None):
    """q (B, H, 1, D) against page pools k/v (P, Hk, page, D), read through
    ``block_table`` (B, n_seq_pages) i32; ``kv_len`` (B,) i32 puts each
    query at position kv_len - 1; ``pos_pages`` (P, page) i32 holds each
    pool slot's absolute position (-1 = empty). A slot is visible when
    0 <= pos <= kv_len - 1. Returns (B, H, 1, D) in q's dtype. On the card
    the kernel splits each sequence's slots by :func:`paged_split` and
    merges the splits' partials (:func:`paged_decode_split_ref` is its
    plain model)."""
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
    if v_pages.shape != k_pages.shape:
        raise ValueError(f"{name}: v pool {tuple(v_pages.shape)} != k pool "
                         f"{tuple(k_pages.shape)}")
    _check_group(name, h, hk, d)
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
    nsp = block_table.shape[1]
    split, nsplit = paged_split(b, hk, nsp, page)
    o = torch.empty((b, h, 1, d), dtype=q.dtype, device=q.device)
    ws = torch.empty(b * h * nsplit * (d + 2), dtype=torch.float32,
                     device=q.device)
    lib = load("paged_decode", _PAGED_SIG)
    err = lib.paged_decode(q.data_ptr(), k_pages.data_ptr(),
                           v_pages.data_ptr(), block_table.data_ptr(),
                           kv_len.data_ptr(), pos_pages.data_ptr(),
                           o.data_ptr(), ws.data_ptr(), b, h, hk, page, nsp,
                           split, d, _DTYPE_CODE[q.dtype], sm_scale,
                           q.stride(0), q.stride(1), stream())
    check(lib, err, "paged_decode")
    paged_decode_attention.launches += 1
    return o


paged_decode_attention.launches = 0


def _check_offsets(name, q_start, k_start):
    for x, n in ((q_start, "q_start"), (k_start, "k_start")):
        if x.numel() != 1 or x.dtype != torch.int32 or not x.is_contiguous():
            raise ValueError(f"{name}: {n} must be one contiguous int32 "
                             f"element, got {tuple(x.shape)} {x.dtype}")


def _ring_masks(name, q, k, window, prefix_len):
    """The kernel's (window, prefix) ints, after the shape checks."""
    if q.shape[2] == 0 or k.shape[2] == 0:
        raise ValueError(f"{name}: empty shard or chunk (Sq {q.shape[2]}, "
                         f"Skv {k.shape[2]})")
    if int(prefix_len) < 0:
        raise ValueError(f"{name}: prefix_len must be >= 0, got {prefix_len}")
    return _window(name, window), int(prefix_len)


def ring_flash_fwd(q, k, v, q_start, k_start, *, causal=True, window=None,
                   sm_scale=None, prefix_len=0):
    """One ring step: q (B, H, Sq, D) at absolute positions ``q_start + i``
    against one kv chunk k, v (B, Hk, Skv, D) at ``k_start + j`` -> (o
    (B, H, Sq, D) in q's dtype, normalised by the chunk's softmax sum; lse
    (B, H, Sq) f32). The offsets are (1, 1) int32 tensors on q's device
    (read there, so no launch waits for the host). Masks: causal,
    ``window``, ``prefix_len`` (keys below it always visible). A row that
    sees no key gives o = 0, lse = -inf. On the card :func:`route` (of q,
    k, v) picks the kernel; both take head dims 32, 64 and 128."""
    name = "ring_flash_fwd"
    _no_grad_asked(name, q, k, v)
    _check_offsets(name, q_start, k_start)
    if on_cpu(name, q, k, v, q_start, k_start):
        return ring_fwd_ref(q, k, v, q_start, k_start, causal=causal,
                            window=window, sm_scale=sm_scale,
                            prefix_len=prefix_len)
    _check_qkv(name, q, k, v)
    _check_gqa(name, q, k, v)
    win, prefix = _ring_masks(name, q, k, window, prefix_len)
    b, h, sq, d = q.shape
    _, hk, skv, _ = k.shape
    if sm_scale is None:
        sm_scale = 1.0 / d ** 0.5
    o = torch.empty((b, h, sq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    lib = load("ring_flash", _RING_SIG)
    path = route(q, k, v)
    ptrs = (ptr(q), ptr(k), ptr(v), ptr(q_start), ptr(k_start), ptr(o),
            ptr(lse), b, h, hk, sq, skv, d)
    tail = (int(bool(causal)), win, prefix, float(sm_scale), *q.stride()[:3],
            *k.stride()[:3], *v.stride()[:3], stream())
    if path == "wgmma":
        err = lib.ring_flash_fwd_tc(*ptrs, *tail)
    else:
        err = lib.ring_flash_fwd(*ptrs, _DTYPE_CODE[q.dtype], *tail)
    check(lib, err, f"{name} ({path})")
    ring_flash_fwd.launches += 1
    ring_flash_fwd.routes[path] += 1
    return o, lse


ring_flash_fwd.launches = 0
ring_flash_fwd.routes = {"wgmma": 0, "simt": 0}


def ring_flash_bwd(q, k, v, do, lse, delta, q_start, k_start, *, causal=True,
                   window=None, sm_scale=None, prefix_len=0):
    """The backward of one ring step at its offsets, from the step's own
    lse and ``delta = rowsum(do * o) - g_lse`` (both (B, H, Sq) f32): dq
    (B, H, Sq, D) in q's dtype and dk, dv (B, Hk, Skv, D) f32 summed over
    each kv head's query-head group. Rows with lse = -inf give nothing.
    On the card :func:`route` (of q, k, v, do) picks the kernel, whose head
    dims are ``RING_BWD_HEAD_DIMS[route]``."""
    name = "ring_flash_bwd"
    _no_grad_asked(name, q, k, v, do)
    _check_offsets(name, q_start, k_start)
    if on_cpu(name, q, k, v, do, lse, delta, q_start, k_start):
        return ring_bwd_ref(q, k, v, do, lse, delta, q_start, k_start,
                            causal=causal, window=window, sm_scale=sm_scale,
                            prefix_len=prefix_len)
    if do.shape != q.shape or do.dtype != q.dtype or do.stride(-1) != 1:
        raise ValueError(f"{name}: do {tuple(do.shape)} {do.dtype} must "
                         f"match q {tuple(q.shape)} {q.dtype}, last axis "
                         "contiguous")
    path = route(q, k, v, do)
    _check_qkv(name, q, k, v, RING_BWD_HEAD_DIMS[path])
    _check_gqa(name, q, k, v)
    win, prefix = _ring_masks(name, q, k, window, prefix_len)
    b, h, sq, d = q.shape
    _, hk, skv, _ = k.shape
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
    lib = load("ring_flash", _RING_SIG)
    ptrs = (ptr(q), ptr(k), ptr(v), ptr(do), ptr(lse), ptr(delta),
            ptr(q_start), ptr(k_start), ptr(dq), ptr(dk), ptr(dv), b, h, hk,
            sq, skv, d)
    tail = (int(bool(causal)), win, prefix, float(sm_scale), *q.stride()[:3],
            *k.stride()[:3], *v.stride()[:3], *do.stride()[:3], stream())
    if path == "wgmma":
        err = lib.ring_flash_bwd_tc(*ptrs, *tail)
    else:
        err = lib.ring_flash_bwd(*ptrs, _DTYPE_CODE[q.dtype], *tail)
    check(lib, err, f"{name} ({path})")
    ring_flash_bwd.launches += 1
    ring_flash_bwd.routes[path] += 1
    return dq, dk, dv


ring_flash_bwd.launches = 0
ring_flash_bwd.routes = {"wgmma": 0, "simt": 0}
