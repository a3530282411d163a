"""Public selective-scan ops: the ``csrc/ssm_scan.cu`` kernel on CUDA
tensors, the plain version on the CPU (counterpart of
``repro.kernels.ssm_scan.ops``).

``ssm_scan_fwd`` launches the kernel: it returns (y, hT), the kernel's two
outputs, and records no gradient. ``ssm_scan_state`` is the differentiable
state-returning form (the JAX package's ``ssm_scan_pallas``) a prefill
needs, and ``ssm_scan`` its y: a ``torch.autograd.Function`` whose forward
is ``ssm_scan_fwd`` and whose backward is autograd through the plain
version's time loop (on the card faster than the associative form's
backward, ``tools/ab_scan_bwd.py``). Both devices go through the same
Function. The op's ``OpVJP`` differentiates :func:`selective_scan_assoc`,
as the JAX op's does: the same gradient.

``ssm_scan_op`` declares the scan for the op front end
(``repro_torch.core``) under the JAX op's name, over ``kernel.py``'s
builder, whose spec this module binds to ``ssm_scan_fwd`` (``raw``:
(y, hT)). The JAX op sweeps chunk and d_block; the kernel's runs and
channel blocks are template constants, so it declares no sweep.
"""

from __future__ import annotations

import ctypes

import torch

from ...core.cuda import bind_cuda
from ...core.device import fit_block
from ...core.op import OpVJP, define_op
from .._build import check, load, on_cpu, ptr, stream
from .kernel import ssm_scan_builder
from .ref import selective_scan_assoc, selective_scan_ref

__all__ = ["ssm_scan", "ssm_scan_fwd", "ssm_scan_state", "ssm_scan_op"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_STATES = (4, 8, 16, 64)
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIG = {"ssm_scan": ([_P] * 9 + [_I] * 5 + [_P], _I)}


def _check(name, x, delta, A, B, C, D, h0):
    if x.dim() != 3 or delta.shape != x.shape:
        raise ValueError(f"{name}: x {tuple(x.shape)} and delta "
                         f"{tuple(delta.shape)} must be one (Bt, L, Dm) "
                         "shape")
    bt, L, dm = x.shape
    n = A.shape[-1]
    if (tuple(A.shape) != (dm, n) or tuple(B.shape) != (bt, L, n)
            or C.shape != B.shape or tuple(D.shape) != (dm,)
            or (h0 is not None and tuple(h0.shape) != (bt, dm, n))):
        raise ValueError(f"{name}: shapes A {tuple(A.shape)}, B "
                         f"{tuple(B.shape)}, C {tuple(C.shape)}, D "
                         f"{tuple(D.shape)} do not fit x {tuple(x.shape)}")
    if n not in _STATES:
        raise ValueError(f"{name}: state size {n}; the kernel takes "
                         f"{_STATES}")
    if (x.dtype not in _DTYPE_CODE or B.dtype != x.dtype
            or C.dtype != x.dtype):
        raise ValueError(f"{name}: dtypes x {x.dtype}, B {B.dtype}, C "
                         f"{C.dtype}; x, B and C share one of "
                         "float32/bfloat16")
    for t, nm in ((delta, "delta"), (A, "A"), (D, "D"), (h0, "h0")):
        if t is not None and t.dtype != torch.float32:
            raise ValueError(f"{name}: {nm} must be float32, got {t.dtype}")
    for t, nm in ((x, "x"), (delta, "delta"), (A, "A"), (B, "B"), (C, "C"),
                  (D, "D"), (h0, "h0")):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name}: {nm} must be contiguous")
    if L == 0 or dm == 0 or bt == 0:
        raise ValueError(f"{name}: empty input {tuple(x.shape)}")


def ssm_scan_fwd(x, delta, A, B, C, D, *, h0=None):
    """x, delta (Bt, L, Dm); A (Dm, N) f32; B, C (Bt, L, N); D (Dm,) f32;
    h0 (Bt, Dm, N) f32 or None -> (y (Bt, L, Dm) in x's dtype, hT
    (Bt, Dm, N) f32). ``delta`` is f32 (mamba's softplus output): rounding
    it to bf16 would move exp(delta A), so a bf16 one raises. No gradient:
    use :func:`ssm_scan_state` or :func:`ssm_scan`."""
    name = "ssm_scan"
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, delta, A, B, C, D, h0)):
        raise RuntimeError(f"{name}_fwd records no autograd graph; call it "
                           "under torch.no_grad() or use ssm_scan_state")
    if delta.dtype != torch.float32:
        raise ValueError(f"{name}: delta must be float32, got {delta.dtype}")
    if on_cpu(name, x, delta, A, B, C, D, h0):
        return selective_scan_ref(x, delta, A, B, C, D, h0=h0)
    _check(name, x, delta, A, B, C, D, h0)
    bt, L, dm = x.shape
    n = A.shape[1]
    y = torch.empty_like(x)
    hT = torch.empty((bt, dm, n), dtype=torch.float32, device=x.device)
    lib = load("ssm_scan", _SIG)
    err = lib.ssm_scan(ptr(x), ptr(delta), ptr(A), ptr(B), ptr(C), ptr(D),
                       ptr(h0) if h0 is not None else None, ptr(y), ptr(hT),
                       bt, L, dm, n, _DTYPE_CODE[x.dtype], stream())
    check(lib, err, name)
    ssm_scan_fwd.launches += 1
    return y, hT


ssm_scan_fwd.launches = 0


class _SSMScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, delta, A, B, C, D, h0):
        y, hT = ssm_scan_fwd(x, delta, A, B, C, D, h0=h0)
        ctx.save_for_backward(x, delta, A, B, C, D, h0)
        return y, hT

    @staticmethod
    def backward(ctx, gy, ghT):
        inputs = ctx.saved_tensors
        need = [t is not None and req
                for t, req in zip(inputs, ctx.needs_input_grad)]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(r) if t is not None else None
                      for t, r in zip(inputs, need)]
            outs = selective_scan_ref(*leaves[:6], h0=leaves[6])
            wrt = [t for t, r in zip(leaves, need) if r]
            got = iter(torch.autograd.grad(outs, wrt, (gy, ghT))
                       if wrt else ())
        return tuple(next(got) if r else None for r in need)


def ssm_scan_state(x, delta, A, B, C, D, *, h0=None):
    """Differentiable (y, hT) of :func:`ssm_scan_fwd` (the kernel on the
    card); its backward is autograd through the plain version."""
    return _SSMScan.apply(x, delta, A, B, C, D, h0)


def ssm_scan(x, delta, A, B, C, D, *, h0=None):
    """Differentiable selective scan: the y of :func:`ssm_scan_state`."""
    return ssm_scan_state(x, delta, A, B, C, D, h0=h0)[0]


# ---------------------------------------------------------------------------
# the op declaration (repro.kernels.ssm_scan.ops.ssm_scan) over
# kernel.py's builder, and the cuda binding of its spec
# ---------------------------------------------------------------------------

def _pre(args, params):
    x, delta, A, B, C, D = args
    bt, L, dm = x.shape
    h0 = params.get("h0")
    if h0 is None:
        h0 = torch.zeros((bt, dm, A.shape[1]), dtype=torch.float32,
                         device=x.device)
    return x, delta, A, B, C, D.reshape(1, dm), h0


def _defines(args, params):
    """JAX's ``_defines``: chunk and d_block fitted to divide."""
    x, delta, A, B, C, D2, h0 = args
    bt, L, dm = x.shape
    n = A.shape[1]
    want_chunk = params["chunk"]
    want_dblk = params["d_block"] or min(dm, 512)
    chunk, d_block = fit_block(want_chunk, L), fit_block(want_dblk, dm)
    degraded = chunk < min(want_chunk, L) or d_block < min(want_dblk, dm)
    if degraded and bt * (dm // d_block) * (L // chunk) > 1 << 16:
        raise ValueError(
            f"ssm_scan: (L={L}, dm={dm}) degraded blocks to (chunk={chunk}, "
            f"d_block={d_block}); pad the operands or pass chunk/d_block "
            "that divide the shapes")
    return dict(bt=int(bt), L=int(L), dm=int(dm), n=int(n), chunk=chunk,
                d_block=d_block, dtype=str(x.dtype).removeprefix("torch."))


def _scan_y_ref(x, delta, A, B, C, D):
    return selective_scan_assoc(x, delta, A, B, C, D)[0]


def _bwd(params, res, g):
    _, pullback = torch.func.vjp(lambda *a: selective_scan_assoc(*a)[0],
                                 *res)
    return pullback(g)


def _example(rng):
    import numpy as np

    bt, L, dm, n = 1, 64, 16, 4
    x = rng.standard_normal((bt, L, dm)).astype("float32")
    delta = (np.log1p(np.exp(rng.standard_normal((bt, L, dm)))) * 0.1
             ).astype("float32")
    A = -(np.abs(rng.standard_normal((dm, n))) + 0.1).astype("float32")
    B = rng.standard_normal((bt, L, n)).astype("float32")
    C = rng.standard_normal((bt, L, n)).astype("float32")
    D = rng.standard_normal((dm,)).astype("float32")
    return (x, delta, A, B, C, D), dict(chunk=16)


ssm_scan_op = define_op(
    "ssm_scan",
    builder=ssm_scan_builder,
    ref=_scan_y_ref,
    derive_defines=_defines,
    pre=_pre,
    vjp=OpVJP(bwd=_bwd),
    public_outputs=1,                       # hT via .raw (a prefill's state)
    defaults=dict(chunk=64, d_block=None),
    array_params=("h0",),
    sources=("ssm_scan",),
    example=_example,
    doc="""Differentiable selective scan y: x, delta (Bt, L, Dm); A (Dm, N);
    B, C (Bt, L, N); D (Dm,); ``raw`` gives (y, hT) (with ``h0=``). The
    backward differentiates :func:`selective_scan_assoc`. ``chunk`` and
    ``d_block`` tile the torch and loops expansions; the kernel's runs
    and channel blocks are template constants, so it declares no
    sweep.""",
)


def _spec_refusal(spec, D):
    x, delta, A, B, C, Dskip, h0 = spec.inputs
    if x.dtype not in _DTYPE_CODE:
        return f"x in {x.dtype}; the kernel takes float32 or bfloat16"
    if D.n not in _STATES:
        return f"state size {D.n}; the kernel takes {_STATES}"
    return None


def _spec_launch(D, ins, outs):
    x, delta, A, B, C, Dskip, h0 = ins
    return ssm_scan_fwd(x, delta, A, B, C, Dskip.reshape(-1), h0=h0)


bind_cuda("ssm_scan", wrapper=ssm_scan_fwd, launch=_spec_launch,
          refusal=_spec_refusal, launch_defines=(),
          fixed_defines=("chunk", "d_block"), copies=True)
