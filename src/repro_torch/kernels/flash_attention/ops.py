"""Public attention ops: the kernels on CUDA tensors, the plain versions
on the CPU (counterparts of ``repro.kernels.flash_attention.ops``).

``flash_attention_fwd`` launches ``csrc/flash_fwd.cu`` (prefill: o and
lse; causal and/or a sliding window and/or a prefix-LM prefix; equal head
dims 32, 64, 112, 128 or 256, or MLA's d_qk = 192 with d_v = 128).
``flash_attention`` is the
differentiable op: a ``torch.autograd.Function`` whose forward is
``flash_attention_fwd`` and whose backward (``flash_attention_bwd``) runs
``flash_delta`` (``csrc/flash_delta.cu``) and then ``flash_bwd``
(``csrc/flash_bwd.cu``), as the JAX op's ``_bwd`` runs the delta and fused
backward kernels. Both devices go through the same Function; on the CPU
each step is its plain version. Both backward kernels take every shape
and mask the forward takes (equal head dims 32-256 or MLA's (192, 128);
causal, window, prefix), so every gradient the forward admits runs on the
card.
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
``wrapper.routes`` counts the launches by route. ``flash_delta`` picks
``"vec"`` (16-byte loads) or ``"scalar"`` by the same kind of rule,
``flash_delta.route``.

The op front end (``repro_torch.core``) declares ``flash_attention_op``,
``flash_decode_op`` and ``flash_decode_paged_op`` under the JAX ops'
names. The two decode ops are tuned over their split length (``split=``,
a multiple of the 32-slot tile in [32, 512]), which the serving step
builders pass on; a decode wrapper called without one takes
:func:`decode_split` / :func:`paged_split`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ...core.cuda import bind_cuda
from ...core.device import default_device, fit_block
from ...core.lang import as_dtype
from ...core.op import OpVJP, define_op
from .._build import check, load, on_cpu, ptr, stream
from .kernel import (flash_decode_builder, flash_fwd_builder,
                     paged_decode_builder)
from .ref import (decode_ref, flash_bwd_ref, flash_delta_ref, flash_fwd_ref,
                  mha_ref, paged_decode_ref, ring_bwd_ref, ring_fwd_ref)

__all__ = ["flash_attention", "flash_attention_fwd", "flash_attention_bwd",
           "flash_delta", "flash_bwd", "flash_decode", "decode_split",
           "paged_decode_attention", "paged_split", "ring_flash_fwd",
           "ring_flash_bwd", "route", "split_refusal", "flash_attention_op",
           "flash_decode_op", "flash_decode_paged_op"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_VEC_ELEMS = (4, 8)            # elements a 16-byte vector, by dtype code
_HEAD_DIMS = (32, 64, 128)     # the ring step kernels (ring_flash.cu)
_WIDE_HEAD_DIMS = (112, 256)   # ... their tensor-core route's (_wide.cu)
_FWD_HEAD_DIMS = (32, 64, 112, 128, 256)  # 112: zamba2, 256: paligemma
_FWD_DIM_PAIRS = ((192, 128),)  # flash_fwd: (d_qk, d_v) besides equal dims
_DECODE_HEAD_DIMS = (32, 64, 112, 128, 256)    # flash_decode
_PAGED_HEAD_DIMS = (32, 64, 128, 256)          # paged_decode
# the ring step kernels by route (ring.py reads them): ring_flash.cu's
# instances, and ring_flash_wide.cu's at 112 and 256 on the tensor cores
# (flash_bwd takes _FWD_HEAD_DIMS and _FWD_DIM_PAIRS on both routes)
RING_FWD_HEAD_DIMS = {"wgmma": (32, 64, 112, 128, 256), "simt": _HEAD_DIMS}
RING_BWD_HEAD_DIMS = {"wgmma": (32, 64, 112, 128, 256), "simt": (32, 64)}
_MAX_GROUP = 16                # decode kernels: query heads per kv head
_MAX_GROUP_DIM = 2048          # decode kernels: (query heads per kv head) * d
_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong

_FLASH_SIG = {"flash_fwd": ([_P] * 5 + [_I] * 11 + [_F] + [_L] * 9 + [_P],
                            _I),
              "flash_fwd_tc": ([_P] * 5 + [_I] * 10 + [_F] + [_L] * 9 + [_P],
                               _I)}
_BWD_SIG = {"flash_bwd": ([_P] * 9 + [_I] * 11 + [_F] + [_L] * 12 + [_P],
                          _I),
            "flash_bwd_tc": ([_P] * 9 + [_I] * 10 + [_F] + [_L] * 12 + [_P],
                             _I)}
_DECODE_SIG = {"flash_decode": ([_P] * 7 + [_I] * 9 + [_F] + [_L] * 6
                                 + [_P] * 2, _I)}
_DECODE_ENTRY = None           # (library, its flash_decode), bound on first use
_DELTA_SIG = {"flash_delta": ([_I] + [_P] * 3 + [_I] * 6 + [_L] * 6 + [_P],
                              _I)}
_DELTA_ENTRY = None            # (library, its flash_delta), bound on first use
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
_RING_WIDE_SIG = {k: _RING_SIG[k] for k in ("ring_flash_fwd_tc",
                                            "ring_flash_bwd_tc")}


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


def _check_qkv(name, q, k, v, head_dims=_HEAD_DIMS, dim_pairs=()):
    """dtypes, head dims (equal ones in ``head_dims``, or a (d_qk, d_v)
    pair of ``dim_pairs``) and contiguous last axes."""
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name}: dtypes {q.dtype}/{k.dtype}/{v.dtype}; "
                         "all three must be float32 or bfloat16")
    d, dv = q.shape[-1], v.shape[-1]
    if k.shape[-1] != d or not ((d in head_dims and dv == d)
                                or (d, dv) in dim_pairs):
        pairs = f" or (d_qk, d_v) in {dim_pairs}" if dim_pairs else ""
        raise ValueError(f"{name}: head dims q {d}, k {k.shape[-1]}, "
                         f"v {dv}; the kernel takes equal head dims "
                         f"in {head_dims}{pairs}")
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


def _check_group(name, h, hk, d):
    if h % hk or h // hk > _MAX_GROUP or (h // hk) * d > _MAX_GROUP_DIM:
        raise ValueError(f"{name}: {h} query heads over {hk} kv heads at "
                         f"head dim {d}; the kernel takes groups of at most "
                         f"{_MAX_GROUP} heads with group * d <= "
                         f"{_MAX_GROUP_DIM}")


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


def _prefix(name, prefix_len):
    """The kernel's prefix int: keys at positions below it are visible to
    every query (the prefix-LM mask); 0 = none."""
    if int(prefix_len) < 0:
        raise ValueError(f"{name}: prefix_len must be >= 0, got {prefix_len}")
    return int(prefix_len)


def flash_attention_fwd(q, k, v, *, causal=True, window=None, sm_scale=None,
                        prefix_len=0):
    """q (B, H, Sq, D); k (B, Hk, Skv, D); v (B, Hk, Skv, Dv) -> (o (B, H,
    Sq, Dv) in q's dtype, lse (B, H, Sq) f32). Queries are aligned to the end of the
    kv stream; ``causal`` masks keys after each query, ``window`` keys at
    q_pos - k_pos >= window, and keys at positions below ``prefix_len``
    are visible to every query whatever those two say (the prefix-LM mask:
    (causal and window) or k_pos < prefix_len). Any Sq <= Skv. On the card
    D = Dv in {32, 64, 112, 128, 256} or (D, Dv) = (192, 128) (MLA), and
    the kernel is the tensor-core one when :func:`route` says
    ``"wgmma"``."""
    name = "flash_attention_fwd"
    _no_grad_asked(name, q, k, v)
    prefix = _prefix(name, prefix_len)
    if on_cpu(name, q, k, v):
        return flash_fwd_ref(q, k, v, causal=causal, window=window,
                             sm_scale=sm_scale, prefix_len=prefix)
    win = _window(name, window)
    _check_qkv(name, q, k, v, _FWD_HEAD_DIMS, _FWD_DIM_PAIRS)
    _check_gqa(name, q, k, v)
    b, h, sq, d = q.shape
    _, hk, skv, _ = k.shape
    dv = v.shape[-1]
    if sq > skv or sq == 0:
        raise ValueError(f"{name}: need 0 < Sq <= Skv, got {sq}, {skv}")
    if sm_scale is None:
        sm_scale = 1.0 / d ** 0.5
    o = torch.empty((b, h, sq, dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    lib = load("flash_fwd", _FLASH_SIG)
    path = route(q, k, v)
    args = (b, h, hk, sq, skv, d, dv)
    tail = (int(bool(causal)), win, prefix, float(sm_scale), *q.stride()[:3],
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


def _delta_vec(d, sd, so, dp, op, dc, oc):
    n = _VEC_ELEMS[dc]                          # elements a 16-byte vector
    return (dc == oc and not (d | sd[0] | sd[1] | sd[2] | so[0] | so[1]
                              | so[2]) % n and not (dp | op) % 16)


def _delta_route(do, o) -> str:
    """The kernel a CUDA call of :func:`flash_delta` launches, from dtype
    and layout alone: ``"vec"`` (a row read as 16-byte vectors by a group
    of lanes) when do and o share a dtype, d and every (b, h, s) stride are
    whole 16-byte vectors and both bases are 16-byte aligned; ``"scalar"``
    (a warp a row, element by element) otherwise."""
    return "vec" if _delta_vec(
        do.shape[-1], do.stride(), o.stride(), do.data_ptr(), o.data_ptr(),
        _DTYPE_CODE[do.dtype], _DTYPE_CODE[o.dtype]) else "scalar"


def _delta_entry():
    global _DELTA_ENTRY
    if _DELTA_ENTRY is None:
        lib = load("flash_delta", _DELTA_SIG)
        _DELTA_ENTRY = (lib, lib.flash_delta)
    return _DELTA_ENTRY


def flash_delta(do, o):
    """delta = rowsum(do * o) in f32: do, o (B, H, Sq, D) -> (B, H, Sq).
    On the card any (b, h, s) strides are read in place (the last axis
    contiguous); the route is :func:`flash_delta.route`'s. The train step
    calls it 16 times, so its card path reads attributes only, binds the C
    function once and passes ints."""
    name = "flash_delta"
    if torch.is_grad_enabled() and (do.requires_grad or o.requires_grad):
        _no_grad_asked(name, do, o)
    if not (do.is_cuda and o.is_cuda and do.get_device() == o.get_device()):
        if on_cpu(name, do, o):
            return flash_delta_ref(do, o)
    shape, sd, so = do.shape, do.stride(), o.stride()
    if shape != o.shape or len(shape) != 4:
        raise ValueError(f"{name}: do {tuple(shape)} and o "
                         f"{tuple(o.shape)} must be one (B, H, Sq, D) shape")
    dc, oc = _DTYPE_CODE.get(do.dtype), _DTYPE_CODE.get(o.dtype)
    if dc is None or oc is None:
        raise ValueError(f"{name}: dtypes {do.dtype}/{o.dtype} must be "
                         "float32 or bfloat16")
    if sd[3] != 1 or so[3] != 1:
        raise ValueError(f"{name}: the last axes must be contiguous")
    b, h, sq, d = shape
    if b > 65535 or h > 65535:
        raise ValueError(f"{name}: B = {b}, H = {h}; the grid takes at "
                         "most 65535 of each")
    if not (b and h and sq and d):
        return torch.zeros((b, h, sq), dtype=torch.float32, device=do.device)
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=do.device)
    dp, op = do.data_ptr(), o.data_ptr()
    vec = _delta_vec(d, sd, so, dp, op, dc, oc)
    lib, fn = _delta_entry()
    err = fn(vec, dp, op, delta.data_ptr(), b, h, sq, d, dc, oc, sd[0], sd[1],
             sd[2], so[0], so[1], so[2], stream())
    if err:
        check(lib, err, name)
    flash_delta.launches += 1
    flash_delta.routes["vec" if vec else "scalar"] += 1
    return delta


flash_delta.launches = 0
flash_delta.routes = {"vec": 0, "scalar": 0}
flash_delta.route = _delta_route


def flash_bwd(q, k, v, do, lse, delta, *, causal=True, window=None,
              sm_scale=None, prefix_len=0):
    """q (B, H, Sq, D), k (B, Hk, Skv, D), v (B, Hk, Skv, Dv) and the
    cotangent do (B, H, Sq, Dv) of o -> dq (B, H, Sq, D) in q's dtype and
    dk (B, Hk, Skv, D), dv (B, Hk, Skv, Dv) f32, summed over each kv head's
    query-head group, from the forward's lse and :func:`flash_delta`'s
    delta (both (B, H, Sq) f32). Queries are aligned to the end of the kv
    stream; any Sq and Skv (a query that sees no key contributes nothing);
    ``causal``, ``window`` and ``prefix_len`` as in
    :func:`flash_attention_fwd`. On the card :func:`route` (of q, k, v, do)
    picks the kernel; both take the forward's head dims and masks."""
    name = "flash_bwd"
    _no_grad_asked(name, q, k, v, do)
    prefix = _prefix(name, prefix_len)
    if on_cpu(name, q, k, v, do, lse, delta):
        return flash_bwd_ref(q, k, v, do, lse, delta, causal=causal,
                             window=window, sm_scale=sm_scale,
                             prefix_len=prefix)
    win = _window(name, window)
    _check_qkv(name, q, k, v, _FWD_HEAD_DIMS, _FWD_DIM_PAIRS)
    _check_gqa(name, q, k, v)
    b, h, sq, d = q.shape
    _, hk, skv, _ = k.shape
    dv_dim = v.shape[-1]
    if (tuple(do.shape) != (b, h, sq, dv_dim) or do.dtype != q.dtype
            or do.stride(-1) != 1):
        raise ValueError(f"{name}: do {tuple(do.shape)} {do.dtype} must "
                         f"match o ({b}, {h}, {sq}, {dv_dim}) {q.dtype}, "
                         "last axis contiguous")
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
    dv = torch.empty((b, hk, skv, dv_dim), dtype=torch.float32, device=dev)
    lib = load("flash_bwd", _BWD_SIG)
    path = route(q, k, v, do)
    ptrs = (ptr(q), ptr(k), ptr(v), ptr(do), ptr(lse), ptr(delta), ptr(dq),
            ptr(dk), ptr(dv), b, h, hk, sq, skv, d, dv_dim)
    masks = (int(bool(causal)), win, prefix, float(sm_scale))
    strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
               *do.stride()[:3])
    if path == "wgmma":
        err = lib.flash_bwd_tc(*ptrs, *masks, *strides, stream())
    else:
        err = lib.flash_bwd(*ptrs, _DTYPE_CODE[q.dtype], *masks, *strides,
                            stream())
    check(lib, err, f"{name} ({path})")
    flash_bwd.launches += 1
    flash_bwd.routes[path] += 1
    return dq, dk, dv


flash_bwd.launches = 0
flash_bwd.routes = {"wgmma": 0, "simt": 0}


def flash_attention_bwd(q, k, v, o, do, lse, *, causal=True, window=None,
                        sm_scale=None, prefix_len=0):
    """The backward host path (``kernel.py:317`` of the JAX package): delta,
    then dq/dk/dv; dk and dv come group-summed out of :func:`flash_bwd` and
    are cast to k's and v's dtypes here. The cotangent is taken in q's
    dtype with its last axis contiguous; on the card, where q, k and v take
    the tensor-core route, a cotangent the 16-byte copies cannot read is
    copied first, so the backward's route is theirs. Returns (dq, dk,
    dv)."""
    do = do.to(q.dtype)
    if do.stride(-1) != 1:
        do = do.contiguous()
    if q.is_cuda and route(q, k, v) == "wgmma" and route(do) == "simt":
        do = do.clone(memory_format=torch.contiguous_format)
    delta = flash_delta(do, o)
    dq, dk, dv = flash_bwd(q, k, v, do, lse, delta, causal=causal,
                           window=window, sm_scale=sm_scale,
                           prefix_len=prefix_len)
    return dq, dk.to(k.dtype), dv.to(v.dtype)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, sm_scale, prefix_len):
        o, lse = flash_attention_fwd(q, k, v, causal=causal, window=window,
                                     sm_scale=sm_scale, prefix_len=prefix_len)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window, ctx.sm_scale = causal, window, sm_scale
        ctx.prefix_len = prefix_len
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do, lse,
                                         causal=ctx.causal,
                                         window=ctx.window,
                                         sm_scale=ctx.sm_scale,
                                         prefix_len=ctx.prefix_len)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, *, causal=True, window=None, sm_scale=None,
                    prefix_len=0):
    """Differentiable attention: the o of :func:`flash_attention_fwd`, with
    the saved (q, k, v, o, lse) feeding :func:`flash_attention_bwd`. On the
    card the backward's route is :func:`route` of q, k and v, and both
    routes take every shape and mask the forward takes; on the CPU each
    step is its plain version."""
    prefix = _prefix("flash_attention", prefix_len)
    if not _grad_asked(q, k, v):
        return flash_attention_fwd(q, k, v, causal=causal, window=window,
                                   sm_scale=sm_scale, prefix_len=prefix)[0]
    return _FlashAttention.apply(q, k, v, causal, window, sm_scale, prefix)


def _decode_check(name, q, k, v, kv_len, slot_pos):
    """The wrapper's checks for flash_decode on the card."""
    _check_qkv(name, q, k, v, _DECODE_HEAD_DIMS)
    _check_gqa(name, q, k, v)
    b, h, one, d = q.shape
    _, hk, skv, _ = k.shape
    if one != 1:
        raise ValueError(f"{name}: expected one query token, got q "
                         f"{tuple(q.shape)}")
    _check_group(name, h, hk, d)
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
                 sm_scale=None, split=None, return_lse=False):
    """q (B, H, 1, D) against a contiguous cache k, v (B, Hk, S, D) ->
    (B, H, 1, D) in q's dtype. ``kv_len`` (default S) puts the query at
    position kv_len - 1: an int, or a one-element int32 tensor on q's
    device, as the JAX op takes a traced scalar, which the kernel reads on
    the device (the wrapper never reads it on the host). ``slot_pos``
    ((S,) int32, -1 = empty) holds each slot's absolute position (rotated
    rolling-window caches; omitted, slot i holds position i). A slot is
    visible when 0 <= pos <= kv_len - 1 and kv_len - 1 - pos < ``window``;
    a row that sees no slot gives 0 (:func:`decode_ref`). On the card the
    kernel cuts the slots into ranges of ``split`` slots and merges the
    ranges' partials (:func:`decode_split_ref` is its plain model);
    ``split`` defaults to :func:`decode_split`'s. Head dims 32, 64, 112,
    128 and 256, groups of up to 16 query heads with group * d <= 2048.
    ``return_lse``: (o, lse (B, H) f32), each row's natural-log softmax
    normaliser, written by the kernel's merge (-inf for a row that sees no
    slot, so that an exact merge of several caches' partials weighs it 0:
    a sequence shard of a cache passes its slots' absolute positions as
    ``slot_pos``)."""
    name = "flash_decode"
    dev_len = torch.is_tensor(kv_len)
    if on_cpu(name, q, k, v, slot_pos, kv_len if dev_len else None):
        return decode_ref(q, k, v, window=window, sm_scale=sm_scale,
                          kv_len=kv_len, slot_pos=slot_pos,
                          return_lse=return_lse)
    win = _window(name, window)
    _decode_check(name, q, k, v, kv_len, slot_pos)
    b, h, _, d = q.shape
    hk, skv = k.shape[1], k.shape[2]
    if split is None:
        split = decode_split(b, hk, skv)[0]
    refused = split_refusal(split)
    if refused:
        raise ValueError(f"{name}: {refused}")
    nsplit = -(-skv // split)
    o = torch.empty((b, h, 1, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h), dtype=torch.float32, device=q.device)
           if return_lse else None)
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
             v.stride(1), stream(), None if lse is None else lse.data_ptr())
    if err:
        check(lib, err, name)
    flash_decode.launches += 1
    return (o, lse) if return_lse else o


flash_decode.launches = 0


def split_refusal(split):
    """Why the decode kernels refuse a split of ``split`` slots (they take
    a multiple of the 32-slot tile in [32, 512]), or None."""
    if (not isinstance(split, int) or split % _PAGED_TILE
            or not _PAGED_TILE <= split <= _PAGED_MAX_SPLIT):
        return (f"split {split!r}: the kernel takes a multiple of "
                f"{_PAGED_TILE} slots in [{_PAGED_TILE}, {_PAGED_MAX_SPLIT}]")
    return None


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
                           pos_pages, sm_scale=None, split=None):
    """q (B, H, 1, D) against page pools k/v (P, Hk, page, D), read through
    ``block_table`` (B, n_seq_pages) i32; ``kv_len`` (B,) i32 puts each
    query at position kv_len - 1; ``pos_pages`` (P, page) i32 holds each
    pool slot's absolute position (-1 = empty). A slot is visible when
    0 <= pos <= kv_len - 1. Returns (B, H, 1, D) in q's dtype. On the card
    the kernel cuts each sequence's slots into ranges of ``split`` slots
    and merges the ranges' partials (:func:`paged_decode_split_ref` is its
    plain model); ``split`` defaults to :func:`paged_split`'s. Head dims
    32, 64, 128 and 256, groups of up to 16 query heads with group * d <=
    2048."""
    name = "paged_decode_attention"
    if on_cpu(name, q, k_pages, v_pages, block_table, kv_len, pos_pages):
        return paged_decode_ref(q, k_pages, v_pages, block_table=block_table,
                                kv_len=kv_len, pos_pages=pos_pages,
                                sm_scale=sm_scale)
    _check_qkv(name, q, k_pages, v_pages, _PAGED_HEAD_DIMS)
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
    if split is None:
        split = paged_split(b, hk, nsp, page)[0]
    refused = split_refusal(split)
    if refused:
        raise ValueError(f"{name}: {refused}")
    nsplit = -(-(nsp * page) // split)
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
    return _window(name, window), _prefix(name, prefix_len)


def _ring_lib(d):
    """ring_flash.cu's library, or ring_flash_wide.cu's at d 112 and 256
    (the tensor-core entries only)."""
    if d in _WIDE_HEAD_DIMS:
        return load("ring_flash_wide", _RING_WIDE_SIG)
    return load("ring_flash", _RING_SIG)


def ring_flash_fwd(q, k, v, q_start, k_start, *, causal=True, window=None,
                   sm_scale=None, prefix_len=0):
    """One ring step: q (B, H, Sq, D) at absolute positions ``q_start + i``
    against one kv chunk k, v (B, Hk, Skv, D) at ``k_start + j`` -> (o
    (B, H, Sq, D) in q's dtype, normalised by the chunk's softmax sum; lse
    (B, H, Sq) f32). The offsets are (1, 1) int32 tensors on q's device
    (read there, so no launch waits for the host). Masks: causal,
    ``window``, ``prefix_len`` (keys below it always visible). A row that
    sees no key gives o = 0, lse = -inf. On the card :func:`route` (of q,
    k, v) picks the kernel, whose head dims are ``RING_FWD_HEAD_DIMS[route]``
    (112 and 256 only on the tensor cores, ``csrc/ring_flash_wide.cu``)."""
    name = "ring_flash_fwd"
    _no_grad_asked(name, q, k, v)
    _check_offsets(name, q_start, k_start)
    if on_cpu(name, q, k, v, q_start, k_start):
        return ring_fwd_ref(q, k, v, q_start, k_start, causal=causal,
                            window=window, sm_scale=sm_scale,
                            prefix_len=prefix_len)
    path = route(q, k, v)
    _check_qkv(name, q, k, v, RING_FWD_HEAD_DIMS[path])
    _check_gqa(name, q, k, v)
    win, prefix = _ring_masks(name, q, k, window, prefix_len)
    b, h, sq, d = q.shape
    _, hk, skv, _ = k.shape
    if sm_scale is None:
        sm_scale = 1.0 / d ** 0.5
    o = torch.empty((b, h, sq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    lib = _ring_lib(d)
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
    lib = _ring_lib(d)
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


# ---------------------------------------------------------------------------
# the op declarations (repro.kernels.flash_attention.ops), over the
# builders of kernel.py; the cuda bindings of their specs follow
# ---------------------------------------------------------------------------

def _dtype_name(dtype):
    return str(dtype).removeprefix("torch.")


def _blocks(name, sq, skv, block_q, block_kv, ncells_of):
    """The JAX ops' fitting: the largest dividing blocks, and a loud error
    when awkward lengths degrade them into a huge grid."""
    bq, bkv = fit_block(block_q, sq), fit_block(block_kv, skv)
    degraded = bq < min(block_q, sq) or bkv < min(block_kv, skv)
    if degraded and ncells_of(bq, bkv) > 1 << 16:
        raise ValueError(
            f"{name}: seq lens ({sq}, {skv}) degraded blocks to ({bq}, "
            f"{bkv}) = {ncells_of(bq, bkv)} grid cells; pad the sequences "
            "or pass block sizes that divide them")
    return bq, bkv


def _attn_defines(name, q, k, v, params):
    """The defines of the prefill and ring specs (JAX's ``_defines``)."""
    b, h, sq, d = q.shape
    _, hk, skv, _ = k.shape
    if h % hk:
        raise ValueError(f"{name}: {h} query heads not a multiple of {hk} "
                         "kv heads")
    if q.dtype != k.dtype or q.dtype != v.dtype:
        raise ValueError(f"{name}: dtypes disagree "
                         f"({q.dtype}/{k.dtype}/{v.dtype})")
    bq, bkv = _blocks(name, sq, skv, params["block_q"], params["block_kv"],
                      lambda bq, bkv: b * h * (sq // bq) * (skv // bkv))
    sm_scale = params["sm_scale"]
    window = params["window"]
    return dict(
        b=int(b), h=int(h), hk=int(hk), sq=int(sq), skv=int(skv), d=int(d),
        dv=int(v.shape[-1]), block_q=bq, block_kv=bkv,
        causal=bool(params["causal"]),
        window=None if window is None else int(window),
        prefix_len=int(params["prefix_len"]),
        sm_scale=float(1.0 / d ** 0.5 if sm_scale is None else sm_scale),
        dtype=_dtype_name(q.dtype))


def _defines(args, params):
    q, k, v = args
    return _attn_defines("flash_attention", q, k, v, params)


def _residuals(outs, args, params):
    o, lse = outs
    q, k, v = args
    return q, k, v, o, lse


def attention_bwd(q, k, v, o, do, lse, *, D, backend, builders=None,
                  starts=()):
    """The backward through the kernel language (JAX's
    ``flash_attention_bwd`` host path): ``flash_delta_builder``, then the
    fused dq/dk/dv builder (``flash_bwd_builder``, or with ``starts`` =
    (q_start, k_start) ``ring_flash_bwd_builder`` and ``delta`` less the
    lse cotangent), built with the forward's defines ``D`` on
    ``backend``; dk and dv come group-summed, cast to k's and v's dtypes
    here. The cotangent is taken as :func:`flash_attention_bwd` takes it
    (q's dtype, last axis contiguous, and on the card a copy the 16-byte
    loads can read when q, k and v take the tensor-core route), so on
    ``cuda`` the launches are the wrapper's own."""
    from .kernel import flash_bwd_builder, flash_delta_builder

    do = do.to(q.dtype)
    if do.stride(-1) != 1:
        do = do.contiguous()
    if q.is_cuda and route(q, k, v) == "wgmma" and route(do) == "simt":
        do = do.clone(memory_format=torch.contiguous_format)
    dev = default_device(backend, q.device)
    delta, = dev.build_kernel(flash_delta_builder, dict(
        b=D["b"], h=D["h"], sq=D["sq"], dv=D["dv"], block_q=D["block_q"],
        dtype=D["dtype"])).run(do, o)
    bwd = builders or flash_bwd_builder
    dq, dk, dv = dev.build_kernel(bwd, D).run(q, k, v, do, lse, delta,
                                              *starts)
    return dq, dk.to(k.dtype), dv.to(v.dtype)


def _bwd(params, res, g):
    q, k, v, o, lse = res
    # re-derived through _defines: forward and backward share one fitting
    return attention_bwd(q, k, v, o, g, lse, D=_defines((q, k, v), params),
                         backend=params["backend"])


def _flash_example(rng):
    q = rng.standard_normal((1, 4, 64, 32)).astype("float32")
    k = rng.standard_normal((1, 2, 64, 32)).astype("float32")
    v = rng.standard_normal((1, 2, 64, 32)).astype("float32")
    return (q, k, v), dict(causal=True)


flash_attention_op = define_op(
    "flash_attention",
    builder=flash_fwd_builder,
    ref=mha_ref,
    derive_defines=_defines,
    vjp=OpVJP(bwd=_bwd, residuals=_residuals),
    public_outputs=1,                       # lse is residual-only
    defaults=dict(causal=True, window=None, sm_scale=None, prefix_len=0,
                  block_q=128, block_kv=128),
    ref_params=("causal", "window", "sm_scale", "prefix_len"),
    sources=("flash_fwd", "flash_delta", "flash_bwd"),
    example=_flash_example,
    doc="""Differentiable flash attention: q (B, H, Sq, Dqk), k (B, Hk, Skv,
    Dqk), v (B, Hk, Skv, Dv); GQA, causal, sliding-window and prefix-LM
    masks. The forward is ``flash_fwd_builder``, the backward the delta
    and fused dq/dk/dv builders, on the forward's backend. ``block_q`` and
    ``block_kv`` tile the torch and loops expansions; the kernels' tiles
    are template constants, so it declares no sweep.""",
)


# -- single-token decode ------------------------------------------------------

def _decode_pre(args, params):
    q, k, v = args
    skv = k.shape[2]
    kv_len = params.get("kv_len")
    if kv_len is None:
        kv_len = skv                         # the full cache valid
    if torch.is_tensor(kv_len):
        kv_len = kv_len.to(torch.int32).reshape(1, 1)
    else:
        kv_len = torch.full((1, 1), int(kv_len), dtype=torch.int32,
                            device=q.device)
    slot_pos = params.get("slot_pos")
    if slot_pos is None:
        # positional: slot i holds absolute position i
        slot_pos = torch.arange(skv, dtype=torch.int32, device=q.device)
    return q, k, v, kv_len, slot_pos.to(torch.int32).reshape(1, skv)


def _check_decode_domain(name, q, k, v, head_dims):
    if q.dim() != 4 or q.shape[2] != 1:
        raise ValueError(f"{name}: expected one query token, got q "
                         f"{tuple(q.shape)}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name}: dtypes {q.dtype}/{k.dtype}/{v.dtype}; "
                         "all three must be float32 or bfloat16")
    d = q.shape[-1]
    if d not in head_dims or k.shape[-1] != d or v.shape[-1] != d:
        raise ValueError(f"{name}: head dim {d}; the kernel takes "
                         f"{head_dims}")
    _check_group(name, q.shape[1], k.shape[1], d)


def _decode_defines(args, params):
    """JAX's ``_decode_defines`` (``block_kv`` fitted to the cache), within
    the kernel's domain (the problem a split winner answers for), and the
    ``split`` knob."""
    q, k, v, kv_len, slot_pos = args
    _check_decode_domain("flash_decode", q, k, v, _DECODE_HEAD_DIMS)
    b, h, _, d = q.shape
    _, hk, skv, _ = k.shape
    if k.shape[0] != b or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"flash_decode: cache k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} for q {tuple(q.shape)}")
    if tuple(slot_pos.shape) != (1, skv):
        raise ValueError(f"flash_decode: slot_pos shape "
                         f"{tuple(slot_pos.shape)} does not match the cache "
                         f"length ({skv} slots)")
    want = params["block_kv"]
    bkv = fit_block(want, skv)
    if bkv < min(want, skv) and b * h * (skv // bkv) > 1 << 16:
        raise ValueError(
            f"flash_decode: cache len {skv} degraded block_kv to {bkv}; pad "
            "the cache or pass a dividing block_kv")
    sm_scale, window = params["sm_scale"], params["window"]
    return dict(b=int(b), h=int(h), hk=int(hk), skv=int(skv), d=int(d),
                dv=int(v.shape[-1]), block_kv=bkv,
                window=None if window is None else int(window),
                sm_scale=float(d ** -0.5 if sm_scale is None else sm_scale),
                dtype=_dtype_name(q.dtype), split=params["split"])


def _decode_tune_ref(args, params):
    q, k, v, kv_len, slot_pos = args
    return decode_ref(q, k, v, window=params["window"],
                      sm_scale=params["sm_scale"], kv_len=kv_len.reshape(()),
                      slot_pos=slot_pos.reshape(-1))


def _split_refusal(d):
    return split_refusal(d["split"])


def _decode_example(rng):
    q = rng.standard_normal((1, 4, 1, 32)).astype("float32")
    k = rng.standard_normal((1, 2, 128, 32)).astype("float32")
    v = rng.standard_normal((1, 2, 128, 32)).astype("float32")
    return (q, k, v), dict(kv_len=100)


flash_decode_op = define_op(
    "flash_decode",
    builder=flash_decode_builder,
    ref=decode_ref,
    derive_defines=_decode_defines,
    pre=_decode_pre,
    defaults=dict(window=None, sm_scale=None, block_kv=512, split=None),
    array_params=("kv_len", "slot_pos"),
    ref_params=("window", "sm_scale", "kv_len", "slot_pos"),
    tune_ref=_decode_tune_ref,
    sweep=dict(split=[64, 128, 256, 512]),
    refusal=_split_refusal,
    sources=("flash_decode",),
    example=_decode_example,
    doc="""One-token decode against a contiguous or rotated cache:
    q (B, H, 1, D), k, v (B, Hk, S, D); ``kv_len`` (int or a one-element
    int32 tensor) puts the query at kv_len - 1, ``slot_pos`` ((S,) int32,
    -1 empty) gives each slot's absolute position. ``split`` slots a range
    of the split-KV kernel (its rule when None); ``block_kv`` tiles the
    torch and loops expansions.""",
)


# -- paged decode -------------------------------------------------------------

def _paged_pre(args, params):
    q, k, v = args
    npages, _, page, _ = k.shape
    b = q.shape[0]
    table = params.get("block_table")
    if table is None:
        raise ValueError(
            "flash_decode_paged: block_table= is required: per-sequence "
            "page indices into the pool, shape (B, n_seq_pages) int32")
    table = table.to(torch.int32).reshape(b, -1)
    nsp = table.shape[-1]
    kv_len = params.get("kv_len")
    if kv_len is None:
        kv_len = nsp * page                  # the full logical capacity
    kv_len = (kv_len if torch.is_tensor(kv_len) else torch.tensor(
        kv_len, device=table.device)).to(torch.int32).reshape(-1)
    kv_len = torch.broadcast_to(kv_len, (b,)).reshape(b, 1)
    pos = params.get("pos_pages")
    if pos is None:
        # positional: logical page j of a sequence holds [j page, (j+1)
        # page); pages no sequence's valid prefix reaches stay -1
        dev = table.device
        logical = torch.arange(nsp * page, dtype=torch.int32,
                               device=dev).reshape(nsp, page)
        valid = (torch.arange(nsp, device=dev) * page)[None, :] < kv_len
        tgt = torch.where(valid, table, npages).reshape(-1).long()
        pos = torch.full((npages + 1, page), -1, dtype=torch.int32,
                         device=dev)
        pos[tgt] = torch.broadcast_to(logical, (b, nsp, page)).reshape(
            -1, page)
        pos = pos[:npages]
    return q, k, v, table, kv_len, pos.to(torch.int32).reshape(npages, page)


def _paged_defines(args, params):
    """JAX's ``_paged_defines`` within the kernel's domain, and the
    ``split`` knob."""
    q, k, v, table, kv_len, pos = args
    _check_decode_domain("flash_decode_paged", q, k, v, _PAGED_HEAD_DIMS)
    b, h, _, d = q.shape
    npages, hk, page, _ = k.shape
    if tuple(v.shape[:3]) != (npages, hk, page):
        raise ValueError(f"flash_decode_paged: v pool {tuple(v.shape)} does "
                         f"not match k pool {tuple(k.shape)}")
    if tuple(pos.shape) != (npages, page):
        raise ValueError(f"flash_decode_paged: pos_pages "
                         f"{tuple(pos.shape)} does not match the pool "
                         f"({npages} pages of {page} slots)")
    sm_scale, window = params["sm_scale"], params["window"]
    return dict(b=int(b), h=int(h), hk=int(hk), d=int(d),
                dv=int(v.shape[-1]), npages=int(npages), page=int(page),
                nseq_pages=int(table.shape[-1]),
                window=None if window is None else int(window),
                sm_scale=float(1.0 / d ** 0.5 if sm_scale is None
                               else sm_scale),
                dtype=_dtype_name(q.dtype), split=params["split"])


def _paged_tune_ref(args, params):
    q, k, v, table, kv_len, pos = args
    return paged_decode_ref(q, k, v, block_table=table,
                            kv_len=kv_len.reshape(-1), pos_pages=pos,
                            sm_scale=params["sm_scale"])


def paged_positions(block_table, kv_len, npages, page):
    """pos_pages (npages, page) int32 for sequences whose logical page j
    holds positions [j page, (j + 1) page) through ``block_table`` (B,
    nsp), up to each ``kv_len``; every other slot -1 (numpy; the JAX op's
    default)."""
    import numpy as np

    pos = np.full((npages, page), -1, np.int32)
    for row, n in zip(np.asarray(block_table), np.asarray(kv_len)):
        for j, p in enumerate(row):
            if j * page < n:
                pos[p] = np.arange(j * page, (j + 1) * page, dtype=np.int32)
    return pos


def _paged_example(rng):
    import numpy as np

    q = rng.standard_normal((1, 4, 1, 32)).astype("float32")
    k = rng.standard_normal((8, 2, 32, 32)).astype("float32")
    v = rng.standard_normal((8, 2, 32, 32)).astype("float32")
    table = np.array([[1, 3, 2, 5]], np.int32)    # non-contiguous pages
    kv_len = np.array([100], np.int32)
    return (q, k, v), dict(block_table=table, kv_len=kv_len,
                           pos_pages=paged_positions(table, kv_len, 8, 32))


flash_decode_paged_op = define_op(
    "flash_decode_paged",
    builder=paged_decode_builder,
    ref=paged_decode_ref,
    derive_defines=_paged_defines,
    pre=_paged_pre,
    defaults=dict(window=None, sm_scale=None, split=None),
    array_params=("block_table", "kv_len", "pos_pages"),
    ref_params=("sm_scale", "block_table", "kv_len", "pos_pages"),
    tune_ref=_paged_tune_ref,
    sweep=dict(split=[32, 64, 128, 256, 512]),
    refusal=_split_refusal,
    sources=("paged_decode",),
    example=_paged_example,
    doc="""One-token decode through a block table over page pools:
    q (B, H, 1, D), pools k, v (P, Hk, page, D), ``block_table`` (B,
    n_seq_pages) int32 read by the spec's index maps at run time,
    ``kv_len`` (B,) int32, ``pos_pages`` (P, page) int32 (-1 empty).
    ``split`` slots a range of the split-KV kernel; the page size stays
    the pool's layout (the engine's), as in the JAX op, whose block is the
    page.""",
)


# ---------------------------------------------------------------------------
# the cuda bindings: each spec of kernel.py launches through its wrapper.
# The kernels fix their own tiles (template constants), so the block
# defines are not launch arguments; the masks and scale are. Each refuses
# at build time what its wrapper would refuse.
# ---------------------------------------------------------------------------

def _dtype_refusal(D):
    if as_dtype(D.dtype) not in _DTYPE_CODE:
        return f"dtype {D.dtype}; the kernels take float32 or bfloat16"
    return None


def _dims_refusal(D, head_dims, pairs=()):
    if (D.d in head_dims and D.dv == D.d) or (D.d, D.dv) in pairs:
        return None
    more = f" or (d_qk, d_v) in {pairs}" if pairs else ""
    return (f"head dims ({D.d}, {D.dv}); the kernel takes equal head dims "
            f"in {head_dims}{more}")


def _mask_refusal(D):
    if D.window is not None and int(D.window) <= 0:
        return f"window {D.window} must be positive"
    if int(D.prefix_len) < 0:
        return f"prefix_len {D.prefix_len} must be >= 0"
    return None


def _group_refusal(D):
    g = D.h // D.hk
    if D.h % D.hk or g > _MAX_GROUP or g * D.d > _MAX_GROUP_DIM:
        return (f"{D.h} query heads over {D.hk} kv heads at head dim "
                f"{D.d}; the kernel takes groups of at most {_MAX_GROUP} "
                f"heads with group * d <= {_MAX_GROUP_DIM}")
    return None


def _prefill_refusal(spec, D):
    if D.sq > D.skv:
        return f"Sq {D.sq} > Skv {D.skv}; the kernel takes 0 < Sq <= Skv"
    return (_dtype_refusal(D) or _dims_refusal(D, _FWD_HEAD_DIMS,
                                               _FWD_DIM_PAIRS)
            or _mask_refusal(D))


def _masks(D):
    return dict(causal=D.causal, window=D.window, sm_scale=D.sm_scale,
                prefix_len=D.prefix_len)


bind_cuda("flash_attention_fwd", wrapper=flash_attention_fwd,
          launch=lambda D, ins, outs: flash_attention_fwd(*ins, **_masks(D)),
          refusal=_prefill_refusal,
          launch_defines=("causal", "window", "sm_scale", "prefix_len"),
          fixed_defines=("block_q", "block_kv"), copies=True)
bind_cuda("flash_delta", wrapper=flash_delta,
          launch=lambda D, ins, outs: (flash_delta(*ins),),
          refusal=lambda spec, D: _dtype_refusal(D), launch_defines=(),
          fixed_defines=("block_q",), copies=True)
bind_cuda("flash_attention_bwd", wrapper=flash_bwd,
          launch=lambda D, ins, outs: flash_bwd(*ins, **_masks(D)),
          refusal=_prefill_refusal,
          launch_defines=("causal", "window", "sm_scale", "prefix_len"),
          fixed_defines=("block_q", "block_kv"), copies=True)


def _decode_launch(D, ins, outs):
    q, k, v, kv_len, slot_pos = ins
    return (flash_decode(q, k, v, kv_len=kv_len, slot_pos=slot_pos.reshape(-1),
                         window=D.window, sm_scale=D.sm_scale,
                         split=getattr(D, "split", None)),)


def _decode_refusal(spec, D):
    split = getattr(D, "split", None)
    return (_dtype_refusal(D) or _dims_refusal(D, _DECODE_HEAD_DIMS)
            or _group_refusal(D)
            or (None if split is None else split_refusal(split)))


bind_cuda("flash_decode", wrapper=flash_decode, launch=_decode_launch,
          refusal=_decode_refusal,
          launch_defines=("window", "sm_scale", "split"),
          fixed_defines=("block_kv",), copies=True)


def _paged_launch(D, ins, outs):
    q, k, v, table, kv_len, pos = ins
    return (paged_decode_attention(
        q, k, v, block_table=table, kv_len=kv_len.reshape(-1),
        pos_pages=pos, sm_scale=D.sm_scale,
        split=getattr(D, "split", None)),)


def _paged_refusal(spec, D):
    split = getattr(D, "split", None)
    if D.window is not None:
        return "window; the paged kernel masks by position only"
    return (_dtype_refusal(D) or _dims_refusal(D, _PAGED_HEAD_DIMS)
            or _group_refusal(D)
            or (None if split is None else split_refusal(split)))


bind_cuda("flash_decode_paged", wrapper=paged_decode_attention,
          launch=_paged_launch, refusal=_paged_refusal,
          launch_defines=("sm_scale", "split"), copies=True)


def _ring_refusal(spec, D, head_dims):
    return (_dtype_refusal(D) or _dims_refusal(D, head_dims)
            or _mask_refusal(D))


def _ring_dims(D, dims):
    # the route follows the layout at launch; at build time a bf16 spec
    # may take the tensor-core route's dims, an f32 one the CUDA cores'
    path = "wgmma" if as_dtype(D.dtype) == torch.bfloat16 else "simt"
    return dims[path]


bind_cuda("ring_flash_fwd", wrapper=ring_flash_fwd,
          launch=lambda D, ins, outs: ring_flash_fwd(*ins, **_masks(D)),
          refusal=lambda spec, D: _ring_refusal(
              spec, D, _ring_dims(D, RING_FWD_HEAD_DIMS)),
          launch_defines=("causal", "window", "sm_scale", "prefix_len"),
          fixed_defines=("block_q", "block_kv", "ring_steps", "mesh_axis"),
          copies=True)
bind_cuda("ring_flash_bwd", wrapper=ring_flash_bwd,
          launch=lambda D, ins, outs: ring_flash_bwd(*ins, **_masks(D)),
          refusal=lambda spec, D: _ring_refusal(
              spec, D, _ring_dims(D, RING_BWD_HEAD_DIMS)),
          launch_defines=("causal", "window", "sm_scale", "prefix_len"),
          fixed_defines=("block_q", "block_kv", "ring_steps", "mesh_axis"),
          copies=True)
