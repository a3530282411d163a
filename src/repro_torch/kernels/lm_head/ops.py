"""Public LM-head ops: the CUDA kernels on CUDA tensors, the plain
versions on the CPU (counterparts of ``repro.kernels.lm_head.ops``).

``lm_head_logits(x, w, vocab=)`` (decode, ``csrc/lm_head.cu``) returns the
masked logits; ``lm_head_logits.raw`` returns (logits, row max,
first-occurrence argmax), all from one pass of the kernel. It has no
backward (nor has the JAX op) and raises when asked for a gradient. On the
card it picks one of two kernels up front by :func:`head_route`: the
tensor-core route (``lm_head_tc``: the product transposed, the vocab rows
of w as the A operand of the ``gemm_sm90.cuh`` TMA + ``wgmma`` mainloop and
the decode rows as a narrow B tile) or the CUDA-core route (``lm_head``,
f32 products); ``lm_head_logits.routes`` counts them.

``lm_head_ce(x, w, labels, vocab=)`` (training, ``csrc/lm_head_ce.cu``) is
a ``torch.autograd.Function`` on both devices: the forward
(``lm_head_ce.raw``) streams each row's lse and label logit out of the
product without keeping the (R, V) logits, the backward
(``lm_head_bwd``) recomputes ``softmax - onehot`` from the saved lse. On
the card each picks one of two kernels up front by :func:`bwd_route`
(dtype and layout alone): the tensor-core route (``lm_head_ce_fwd_tc``: one
TMA + ``wgmma`` product whose epilogue reduces each tile's rows to (max,
sum, gold) partials; ``lm_head_ce_bwd_tc``: three such products, dl kept as
hi/lo bf16 planes) or the CUDA-core route (``lm_head_ce_fwd``,
``lm_head_ce_bwd``: f32 products, dl in f32); :func:`bwd_route` is
:func:`head_route`, the one layout rule of the three.
``lm_head_ce.launches`` and ``lm_head_bwd.launches`` count every call,
``.routes`` counts them by route.

``lm_head_logits_op`` and ``lm_head_ce_op`` declare both for the op front
end (``repro_torch.core``) under the JAX ops' names, over
``kernel.py``'s builders, whose specs this module binds to the wrappers.
The JAX ops sweep their row, vocab and k blocks; the kernels' TMA + wgmma
tiles are template constants, so they declare no sweep.
"""

from __future__ import annotations

import ctypes

import torch

from ...core.cuda import bind_cuda
from ...core.device import default_device, fit_block
from ...core.lang import as_dtype, cdiv
from ...core.op import OpVJP, define_op
from .._build import check, load, on_cpu, ptr, stream, tma_ok
from .kernel import lm_head_bwd_builder, lm_head_builder
from .ref import (lm_head_bwd_ref, lm_head_ce_ref, lm_head_ce_stats_ref,
                  lm_head_logits_ref, masked_logits_ref)

__all__ = ["lm_head_logits", "lm_head_ce", "lm_head_bwd", "head_route",
           "bwd_route", "lm_head_logits_op", "lm_head_ce_op"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIG = {"lm_head": ([_P] * 7 + [_I] * 5 + [_L] * 3 + [_P], _I),
        "lm_head_tc": ([_P] * 7 + [_I] * 4 + [_L] * 3 + [_P], _I),
        "lm_head_partials": ([_I], _I),
        "lm_head_tc_partials": ([_I], _I)}
_CE_SIG = {"lm_head_ce_splits": ([_I], _I),
           "lm_head_ce_tc_tiles": ([_I], _I),
           "lm_head_ce_fwd": ([_P] * 6 + [_I] * 5 + [_L] * 3 + [_P], _I),
           "lm_head_ce_fwd_tc": ([_P] * 6 + [_I] * 4 + [_L] * 3 + [_P], _I),
           "lm_head_ce_bwd": ([_P] * 8 + [_I] * 5 + [_L] * 5 + [_P], _I),
           "lm_head_ce_bwd_tc": ([_P] * 9 + [_I] * 4 + [_L] * 6 + [_P], _I)}


def _check_head(name, x, w):
    """Checks shared by the LM-head kernels on the card; returns (R, d,
    V)."""
    if x.dtype not in _DTYPE_CODE or w.dtype != x.dtype:
        raise ValueError(f"{name}: dtypes {x.dtype}/{w.dtype}; both must be "
                         "float32 or bfloat16")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"{name}: shapes x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)} must be (R, d) and (d, V)")
    if x.stride(1) != 1:
        raise ValueError(f"{name}: the last axis of x must be contiguous")
    return x.shape[0], x.shape[1], w.shape[1]


def _vocab(name, vocab, V, R):
    vocab = V if vocab is None else int(vocab)
    if not 0 < vocab <= V or R == 0:
        raise ValueError(f"{name}: vocab={vocab} outside (0, {V}] or no rows")
    return vocab


def _check_labels(name, labels, x):
    R = x.shape[0]
    if (tuple(labels.shape) != (R, 1) or labels.dtype != torch.int32
            or not labels.is_contiguous() or labels.device != x.device):
        raise ValueError(f"{name}: labels must be contiguous int32 ({R}, 1) "
                         f"on {x.device}, got {tuple(labels.shape)} "
                         f"{labels.dtype} on {labels.device}")


def _raw(x, w, *, vocab=None):
    """x (R, d) @ w (d, V) -> (logits (R, V) f32 with -1e30 on columns
    >= vocab, m (R, 1) f32, arg (R, 1) i32). ``w`` may be any strided view
    (the tied head ``embed.T`` is read in place). On the card the route is
    :func:`head_route`'s, fixed before any launch."""
    name = "lm_head_logits"
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise RuntimeError(
            f"{name} has no backward (nor has the JAX op): call it under "
            "torch.no_grad(), or train through lm_head_ce")
    if on_cpu(name, x, w):
        return lm_head_logits_ref(x, w, vocab=vocab)
    R, d, V = _check_head(name, x, w)
    vocab = _vocab(name, vocab, V, R)
    lib = load("lm_head", _SIG)
    path = head_route(x, w)
    nblk = (lib.lm_head_tc_partials(V) if path == "wgmma"
            else lib.lm_head_partials(V))
    dev = x.device
    logits = torch.empty((R, V), dtype=torch.float32, device=dev)
    m = torch.empty((R, 1), dtype=torch.float32, device=dev)
    arg = torch.empty((R, 1), dtype=torch.int32, device=dev)
    part_m = torch.empty((nblk, R), dtype=torch.float32, device=dev)
    part_arg = torch.empty((nblk, R), dtype=torch.int32, device=dev)
    ptrs = (ptr(x), ptr(w), ptr(logits), ptr(m), ptr(arg), ptr(part_m),
            ptr(part_arg), R, d, V, vocab)
    strides = (x.stride(0), w.stride(0), w.stride(1), stream())
    if path == "wgmma":
        err = lib.lm_head_tc(*ptrs, *strides)
    else:
        err = lib.lm_head(*ptrs, _DTYPE_CODE[x.dtype], *strides)
    check(lib, err, f"lm_head ({path})")
    lm_head_logits.launches += 1
    lm_head_logits.routes[path] += 1
    return logits, m, arg


def lm_head_logits(x, w, *, vocab=None):
    """The masked logits of :func:`lm_head_logits.raw`."""
    return _raw(x, w, vocab=vocab)[0]


lm_head_logits.raw = _raw
lm_head_logits.launches = 0
lm_head_logits.routes = {"wgmma": 0, "simt": 0}


def _ce_raw(x, w, labels, *, vocab=None):
    """x (R, d) @ w (d, V) -> (lse (R, 1) f32 over the true vocab, gold
    (R, 1) f32 = each row's label logit). ``w`` may be any strided view
    (the tied head ``embed.T`` is read in place); labels (R, 1) int32. On
    the card the route is :func:`bwd_route`'s, fixed before any launch: the
    tensor-core route reads x and w as the backward's logits pass does."""
    name = "lm_head_ce"
    if on_cpu(name, x, w):
        return lm_head_ce_stats_ref(x, w, labels, vocab=vocab)
    R, d, V = _check_head(name, x, w)
    vocab = _vocab(name, vocab, V, R)
    _check_labels(name, labels, x)
    lib = load("lm_head_ce", _CE_SIG)
    path = bwd_route(x, w)
    dev = x.device
    lse = torch.empty((R, 1), dtype=torch.float32, device=dev)
    gold = torch.empty((R, 1), dtype=torch.float32, device=dev)
    args = (R, d, V, vocab)
    strides = (x.stride(0), w.stride(0), w.stride(1), stream())
    if path == "wgmma":                 # partials per 256-column tile
        part = torch.empty((3, lib.lm_head_ce_tc_tiles(V), R),
                           dtype=torch.float32, device=dev)
        err = lib.lm_head_ce_fwd_tc(ptr(x), ptr(w), ptr(labels), ptr(lse),
                                    ptr(gold), ptr(part), *args, *strides)
    else:                               # partials per vocab chunk
        part = torch.empty((3, lib.lm_head_ce_splits(V), R),
                           dtype=torch.float32, device=dev)
        err = lib.lm_head_ce_fwd(ptr(x), ptr(w), ptr(labels), ptr(lse),
                                 ptr(gold), ptr(part), *args,
                                 _DTYPE_CODE[x.dtype], *strides)
    check(lib, err, f"lm_head_ce_fwd ({path})")
    lm_head_ce.launches += 1
    lm_head_ce.routes[path] += 1
    return lse, gold


def head_route(x, w) -> str:
    """The kernel a CUDA call of :func:`lm_head_logits` (and of the CE
    head's, ``lm_head_ce.raw`` and :func:`lm_head_bwd`) launches, from
    dtype and layout alone: ``"wgmma"`` (the tensor-core route) when x and
    w are bf16, TMA can read x row by row and w either as the tied head's
    transposed view (``w.T`` rows contiguous) or by its own contiguous rows
    (``tma_ok``); else ``"simt"`` (the CUDA-core route: f32 inputs, whose
    exact f32 products it keeps, and bf16 views with unaligned rows)."""
    rows = w if w.stride(1) == 1 else w.T
    return "wgmma" if tma_ok(x) and tma_ok(rows) else "simt"


# the CE head's forward and backward read x and w as the decode head does
bwd_route = head_route


def lm_head_bwd(x, w, labels, lse, g, *, vocab=None):
    """The CE backward: (dx (R, d) f32, dw (d, V) f32) for the per-row NLL
    cotangent ``g`` (R, 1) f32, recomputed from the forward's ``lse``. On
    the card dw is written in w's memory layout: for the tied head
    ``embed.T`` it is the transposed view of an (V, d) tensor, so the
    embedding's gradient needs no transpose copy. The route
    (:func:`bwd_route`) is fixed before any launch: the tensor-core route
    keeps dl = g (p - onehot) as two bf16 planes hi + lo (the function of
    :func:`.ref.lm_head_bwd_split_ref`), the CUDA-core route as f32."""
    name = "lm_head_bwd"
    if on_cpu(name, x, w):
        return lm_head_bwd_ref(x, w, labels, lse, g, vocab=vocab)
    R, d, V = _check_head(name, x, w)
    vocab = _vocab(name, vocab, V, R)
    _check_labels(name, labels, x)
    for t, n in ((lse, "lse"), (g, "g")):
        if (tuple(t.shape) != (R, 1) or t.dtype != torch.float32
                or not t.is_contiguous() or t.device != x.device):
            raise ValueError(f"{name}: {n} must be contiguous f32 ({R}, 1) "
                             f"on {x.device}")
    dev = x.device
    dx = torch.empty((R, d), dtype=torch.float32, device=dev)
    if w.stride(0) == 1 and w.stride(1) != 1:
        dw = torch.empty((V, d), dtype=torch.float32, device=dev).T
    else:
        dw = torch.empty((d, V), dtype=torch.float32, device=dev)
    lib = load("lm_head_ce", _CE_SIG)
    path = bwd_route(x, w)
    if path == "wgmma":
        ld = -(-V // 8) * 8                 # TMA: rows 16-byte aligned
        planes = torch.empty((2, R, ld), dtype=torch.bfloat16, device=dev)
        err = lib.lm_head_ce_bwd_tc(
            ptr(x), ptr(w), ptr(labels), ptr(lse), ptr(g), ptr(planes[0]),
            ptr(planes[1]), ptr(dx), ptr(dw), R, d, V, vocab, ld,
            x.stride(0), w.stride(0), w.stride(1), dw.stride(0),
            dw.stride(1), stream())
        check(lib, err, "lm_head_ce_bwd_tc")
    else:
        dl = torch.empty((R, V), dtype=torch.float32, device=dev)
        err = lib.lm_head_ce_bwd(ptr(x), ptr(w), ptr(labels), ptr(lse),
                                 ptr(g), ptr(dl), ptr(dx), ptr(dw), R, d, V,
                                 vocab, _DTYPE_CODE[x.dtype], x.stride(0),
                                 w.stride(0), w.stride(1), dw.stride(0),
                                 dw.stride(1), stream())
        check(lib, err, "lm_head_ce_bwd")
    lm_head_bwd.launches += 1
    lm_head_bwd.routes[path] += 1
    return dx, dw


lm_head_bwd.launches = 0
lm_head_bwd.routes = {"wgmma": 0, "simt": 0}


class _LMHeadCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, labels, vocab):
        lse, gold = _ce_raw(x, w, labels, vocab=vocab)
        ctx.save_for_backward(x, w, labels, lse)
        ctx.vocab = vocab
        return (lse - gold)[:, 0]

    @staticmethod
    def backward(ctx, g):
        x, w, labels, lse = ctx.saved_tensors
        dx, dw = lm_head_bwd(x, w, labels, lse,
                             g.float().reshape(-1, 1).contiguous(),
                             vocab=ctx.vocab)
        return dx.to(x.dtype), dw.to(w.dtype), None, None


def lm_head_ce(x, w, labels, *, vocab=None):
    """Fused LM-head cross-entropy: x (R, d) @ w (d, V) -> per-row NLL
    ``lse - gold`` (R,) f32, with padded columns >= ``vocab`` excluded.
    labels (R, 1) int32. Differentiable in x and w."""
    return _LMHeadCE.apply(x, w, labels, vocab)


lm_head_ce.raw = _ce_raw
lm_head_ce.launches = 0
lm_head_ce.routes = {"wgmma": 0, "simt": 0}


# ---------------------------------------------------------------------------
# the op declarations (repro.kernels.lm_head.ops), over kernel.py's
# builders; the cuda bindings of their specs follow
# ---------------------------------------------------------------------------

def _row_padding(R: int, block_r) -> int:
    """Rows to append so the row block tiles exactly (JAX's pre hooks pad
    R = B (S - 1) up to a block multiple rather than let ``fit_block``
    degrade to an awkward divisor; the post hooks slice them off)."""
    br = min(int(block_r), int(R))
    return (-int(R)) % br if br > 0 else 0


def _pad_rows(a, pad: int, fill=0):
    if pad == 0:
        return a
    return torch.cat([a, a.new_full((pad,) + tuple(a.shape[1:]), fill)])


def _base_defines(x, w, params, *, op_name):
    R, d = x.shape
    d2, V = w.shape
    if d != d2:
        raise ValueError(f"{op_name}: inner dims disagree ({d} vs {d2})")
    if x.dtype != w.dtype:
        raise ValueError(f"{op_name}: dtypes disagree ({x.dtype} vs "
                         f"{w.dtype})")
    vocab = params["vocab"]
    vocab = V if vocab is None else int(vocab)
    if not 0 < vocab <= V:
        raise ValueError(f"{op_name}: vocab={vocab} outside (0, {V}] "
                         f"(w has {V} padded columns)")
    want = (params["block_r"], params["block_v"], params["block_k"])
    br, bv, bk = (fit_block(want[0], R), fit_block(want[1], V),
                  fit_block(want[2], d))
    ncells = (R // br) * (V // bv) * (d // bk)
    # the degradation guard keys on grid blowup, not on any shrink
    want_cells = (cdiv(R, min(want[0], R)) * cdiv(V, min(want[1], V))
                  * cdiv(d, min(want[2], d)))
    if ncells > 1 << 16 and ncells > 8 * want_cells:
        raise ValueError(
            f"{op_name}: shapes ({R}x{d}x{V}) degraded the requested blocks "
            f"to ({br},{bv},{bk}) = {ncells} grid cells "
            f"(~{want_cells} requested); pad the operands or pass block "
            "sizes that divide the shapes")
    return dict(R=int(R), d=int(d), V=int(V), vocab=vocab, block_r=br,
                block_v=bv, block_k=bk,
                dtype=str(x.dtype).removeprefix("torch."))


def _ce_defines(args, params):
    x, w, labels = args[:3]
    D = _base_defines(x, w, params, op_name="lm_head_ce")
    if tuple(labels.shape) != (D["R"], 1):
        raise ValueError(
            f"lm_head_ce: labels shape {tuple(labels.shape)} != "
            f"({D['R']}, 1): one gold token id per row")
    if labels.dtype != torch.int32:
        raise ValueError(f"lm_head_ce: labels must be int32, got "
                         f"{labels.dtype}")
    D["emit_logits"] = 0
    return D


def _logits_defines(args, params):
    x, w = args
    D = _base_defines(x, w, params, op_name="lm_head_logits")
    D["emit_logits"] = 1
    return D


def _ce_pre(args, params):
    # rows padded to a block multiple (labels with 0, a valid id: the
    # padded rows' NLL is sliced off by the post hook, zeroed in the bwd)
    x, w, labels = args
    pad = _row_padding(x.shape[0], params["block_r"])
    return _pad_rows(x, pad), w, _pad_rows(labels, pad)


def _ce_post(outs, args, params):
    lse, gold = outs                            # padded rows' stats
    return (lse - gold)[:args[0].shape[0], 0]   # per-row NLL, (R,) f32


def _ce_residuals(outs, args, params):
    lse, _ = outs                               # lse over the padded rows
    x, w, labels = args
    return x, w, labels, lse


def _fit_bwd_smem(bdef: dict) -> dict:
    """The backward's working set carries f32 dx and dw blocks beside x
    and w: shrink the vocab block (largest divisor of V first) until the
    spec's footprint fits the shared-memory budget, or keep the smallest
    and let the build report it (JAX's ``_fit_bwd_vmem``). Not on the
    cuda backend, whose kernel fixes its tiles (and at the train head's
    d = 2048 no vocab block fits: the search would end at one column)."""
    from types import SimpleNamespace

    from ...core import analyze as _an

    budget = _an.smem_budget()
    V, bv = int(bdef["V"]), int(bdef["block_v"])
    while True:
        spec = lm_head_bwd_builder(SimpleNamespace(**dict(bdef, block_v=bv)))
        if _an.smem_footprint(spec)[0] <= budget:
            break
        smaller = next((b for b in range(bv // 2, 0, -1) if V % b == 0), None)
        if smaller is None:
            break
        bv = smaller
    return dict(bdef, block_v=bv)


def _ce_bwd(params, res, g):
    x, w, labels, lse = res
    R = x.shape[0]
    # the forward's padding and fitting; padded rows get a zero cotangent
    pad = _row_padding(R, params["block_r"])
    xp, labp = _pad_rows(x, pad), _pad_rows(labels, pad)
    D = _ce_defines((xp, w, labp), params)
    bdef = {k: D[k] for k in ("R", "d", "V", "vocab", "block_r", "block_v",
                              "dtype")}
    if params["backend"] != "cuda":      # the kernel fixes its own tiles
        bdef = _fit_bwd_smem(bdef)
    kern = default_device(params["backend"], x.device).build_kernel(
        lm_head_bwd_builder, bdef)
    g2 = _pad_rows(g.float().reshape(-1, 1).contiguous(), pad)
    dx, dw = kern.run(xp, w, labp, lse, g2)
    return dx[:R].to(x.dtype), dw.to(w.dtype), None


def _ce_example(rng):
    x = rng.standard_normal((24, 16)).astype("float32")
    w = rng.standard_normal((16, 64)).astype("float32")
    labels = rng.randint(0, 50, (24, 1)).astype("int32")
    return (x, w, labels), dict(vocab=50)


_BLOCKS = dict(block_r=256, block_v=512, block_k=512)

lm_head_ce_op = define_op(
    "lm_head_ce",
    builder=lm_head_builder,
    ref=lm_head_ce_ref,
    derive_defines=_ce_defines,
    pre=_ce_pre,
    post=_ce_post,
    vjp=OpVJP(bwd=_ce_bwd, residuals=_ce_residuals),
    defaults=dict(vocab=None, **_BLOCKS),
    ref_params=("vocab",),
    sources=("lm_head_ce",),
    example=_ce_example,
    doc="""Fused LM-head cross-entropy: per-row NLL (R,) f32 of x (R, d) @
    w (d, V) against labels (R, 1) int32 over the true ``vocab``, in one
    pass (``raw``: (lse, gold)); the backward recomputes softmax - onehot
    through ``lm_head_bwd_builder`` on the forward's backend. The blocks
    tile the torch and loops expansions; the kernels' TMA + wgmma tiles are
    template constants, so it declares no sweep.""",
)


def _logits_pre(args, params):
    x, w = args
    return _pad_rows(x, _row_padding(x.shape[0], params["block_r"])), w


def _logits_post(outs, args, params):
    logits, = outs                              # the public output
    return logits[:args[0].shape[0]]


def _logits_example(rng):
    x = rng.standard_normal((8, 16)).astype("float32")
    w = rng.standard_normal((16, 64)).astype("float32")
    return (x, w), dict(vocab=50)


lm_head_logits_op = define_op(
    "lm_head_logits",
    builder=lm_head_builder,
    ref=masked_logits_ref,
    derive_defines=_logits_defines,
    pre=_logits_pre,
    post=_logits_post,
    public_outputs=1,                           # m and arg via .raw
    defaults=dict(vocab=None, **_BLOCKS),
    ref_params=("vocab",),
    sources=("lm_head",),
    example=_logits_example,
    doc="""Decode-head logits: x (R, d) @ w (d, V), f32, columns >= ``vocab``
    masked; ``raw`` gives (logits, row max, first-occurrence argmax) from
    the same pass.""",
)


# ---------------------------------------------------------------------------
# the cuda bindings: the kernels fix their own tiles (template constants);
# the true vocab is a launch argument
# ---------------------------------------------------------------------------

def _head_refusal(spec, D):
    if as_dtype(D.dtype) not in _DTYPE_CODE:
        return f"dtype {D.dtype}; the kernels take float32 or bfloat16"
    return None


_TILES = ("block_r", "block_v", "block_k")
bind_cuda("lm_head_logits", wrapper=lm_head_logits,
          launch=lambda D, ins, outs: _raw(*ins, vocab=D.vocab),
          refusal=_head_refusal, launch_defines=("vocab",),
          fixed_defines=_TILES + ("emit_logits",), copies=True)
bind_cuda("lm_head_ce", wrapper=lm_head_ce,
          launch=lambda D, ins, outs: _ce_raw(*ins, vocab=D.vocab),
          refusal=_head_refusal, launch_defines=("vocab",),
          fixed_defines=_TILES + ("emit_logits",), copies=True)
bind_cuda("lm_head_ce_bwd", wrapper=lm_head_bwd,
          launch=lambda D, ins, outs: lm_head_bwd(*ins, vocab=D.vocab),
          refusal=_head_refusal, launch_defines=("vocab",),
          fixed_defines=("block_r", "block_v"), copies=True)
