"""One leapfrog step of the FD wave app: the CUDA kernel (``csrc/fd2d.cu``)
on CUDA tensors, the plain version on the CPU (the counterpart of
``repro.kernels.apps.ops.fd2d`` and its ``_fd_defines``).

``fd2d(u1, u2, weights=, dx=, dt=)`` returns
``u3 = 2 u1 - u2 + dt^2 (u_xx + u_yy)`` on the periodic (h, w) f32 field,
with the order-2r central stencil ``weights``. ``out=`` writes into a
preallocated tensor (FDWave's swap chain), so a step allocates nothing.

The kernel streams rows: a block walks its (bh, bw) tile top to bottom,
u1's rows arriving in a shared ring. It has two routes of one source,
picked up front by :func:`route` and counted in ``fd2d.routes``:
``"vec"`` (16-byte copies and accesses) when the width and the tile's
width are multiples of 4 floats and the three bases are 16-byte aligned,
``"scalar"`` (4-byte ones) otherwise. Both give every output the same
chain of f32 roundings, :func:`fd2d_stream_ref`'s, whatever the tile.

``fd2d_op`` declares it for the op front end (``repro_torch.core``) under
the JAX op's name, over ``repro_torch.apps.fd2d.fd2d_builder`` and tuned
over the tile (bh, bw); the module also binds the kernel language's
``fd2d`` spec to it for the cuda backend (``core.cuda``).
"""

from __future__ import annotations

import ctypes

import torch

from ...core.cuda import bind_cuda
from ...core.lang import as_dtype
from ...core.device import fit_block
from ...core.op import define_op, oracle_vjp
from ...core.tune import Tolerance
from .._build import check, load, stream
from ._common import SMEM_MAX, app_builder, app_on_cpu

__all__ = ["fd2d", "fd2d_op", "fd2d_ref", "fd2d_stream_ref", "route",
           "DEFAULT_BLOCK", "MAX_RADIUS", "tile_refusal"]

DEFAULT_BLOCK = (32, 256)  # (bh, bw): the JAX op's defaults
MAX_RADIUS = 8
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIG = {"fd2d": ([_I] + [_P] * 3 + [_I] * 3 + [_P, _F, _F, _I, _I, _P], _I)}
_STAGES, _MAX_NT = 4, 256   # csrc/fd2d.cu: rows in flight, threads a block
_ENTRY = None               # (library, its fd2d function), bound on first use


def _smem(r, bw):
    """Shared bytes of a block of the kernel for radius r and a tile bw
    columns wide: u1's ring of r + 1 + 4 rows, each a strip of 4 columns a
    thread plus r halo columns a side rounded up to 4, and u2's of 5 rows
    of the strip."""
    nt = min(_MAX_NT, (bw + 127) // 128 * 32)     # a thread per 4 columns
    return 4 * ((r + 1 + _STAGES) * (4 * nt + 2 * ((r + 3) & ~3))
                + (_STAGES + 1) * 4 * nt)


def tile_refusal(r, bh, bw):
    """Why the kernel refuses the tile (bh, bw) at radius r (after the
    wrapper clips it to the field), or None."""
    smem = _smem(r, bw)
    if bh < 1 or bw < 1 or smem > SMEM_MAX:
        return (f"tile ({bh}, {bw}) with radius {r} needs {smem} B of "
                f"shared memory (at most {SMEM_MAX})")
    return None


def route(u1, u2, out, bw) -> str:
    """The route a CUDA call launches: ``"vec"`` when the width and the
    tile's width ``bw`` are multiples of 4 floats and u1, u2 and out start
    16-byte aligned, ``"scalar"`` otherwise."""
    ok = (u1.shape[1] % 4 == 0 and bw % 4 == 0
          and all(t.data_ptr() % 16 == 0 for t in (u1, u2, out)))
    return "vec" if ok else "scalar"


def _entry():
    global _ENTRY
    if _ENTRY is None:
        lib = load("fd2d", _SIG)
        _ENTRY = (lib, lib.fd2d)
    return _ENTRY


def fd2d_ref(u1, u2, weights, dx, dt):
    """Plain PyTorch leapfrog step: the torch mirror of the JAX oracle
    ``repro.apps.fd2d.reference_step`` (periodic via ``torch.roll``)."""
    lap = torch.zeros_like(u1)
    r = (len(weights) - 1) // 2
    for k in range(-r, r + 1):
        wk = weights[k + r]
        lap = lap + wk * (torch.roll(u1, -k, 0) + torch.roll(u1, -k, 1))
    lap = lap / (dx * dx)
    return 2.0 * u1 - u2 + dt * dt * lap


def fd2d_stream_ref(u1, u2, weights, dx, dt):
    """Plain model of the kernel's arithmetic, for the tests: f32 with a
    rounding after every operation, per k the vertical term and then the
    horizontal one, lap times 1/dx^2 and dt^2 each rounded to f32 (as the
    wrapper passes them). On the same f32 values the kernel gives these
    bits on either route."""
    f32 = torch.float32
    inv_dx2 = float(torch.tensor(1.0 / (dx * dx), dtype=f32))
    dt2 = float(torch.tensor(dt * dt, dtype=f32))
    lap = torch.zeros_like(u1)
    r = (len(weights) - 1) // 2
    for k in range(-r, r + 1):
        wk = float(torch.tensor(weights[k + r], dtype=f32))
        lap = lap + wk * torch.roll(u1, -k, 0)       # vertical
        lap = lap + wk * torch.roll(u1, -k, 1)       # horizontal
    return (2.0 * u1 - u2) + dt2 * (lap * inv_dx2)


def fd2d(u1, u2, *, weights, dx, dt, block=DEFAULT_BLOCK, out=None):
    """u1, u2 (h, w) f32: the fields at t_n and t_{n-1}. ``block`` is the
    kernel's (bh, bw) output tile (0 = the full extent; the ragged edge is
    masked, so it need not divide the field). Returns u3 (``out`` if
    given; it must not alias u1)."""
    name = "fd2d"
    dx, dt = float(dx), float(dt)
    r = (len(weights) - 1) // 2
    if len(weights) != 2 * r + 1 or not 1 <= r <= MAX_RADIUS:
        raise ValueError(f"{name}: {len(weights)} weights; need 2r + 1 with "
                         f"1 <= r <= {MAX_RADIUS}")
    ts = (u1, u2) if out is None else (u1, u2, out)
    if app_on_cpu(name, *ts):
        u3 = fd2d_ref(u1, u2, weights, dx, dt)
        return u3 if out is None else out.copy_(u3)
    if u1.dim() != 2 or u2.shape != u1.shape or (
            out is not None and out.shape != u1.shape):
        raise ValueError(f"{name}: u1 {tuple(u1.shape)}, u2 "
                         f"{tuple(u2.shape)} must be one (h, w) shape"
                         + ("" if out is None else
                            f", out {tuple(out.shape)} too"))
    h, w = u1.shape
    bh, bw = min(block[0] or h, h), min(block[1] or w, w)
    refused = tile_refusal(r, bh, bw)
    if refused:
        raise ValueError(f"{name}: {refused}")
    if out is None:
        out = torch.empty_like(u1)
    elif out.data_ptr() == u1.data_ptr():
        raise ValueError(f"{name}: out must not alias u1")
    path = route(u1, u2, out, bw)
    lib, fn = _entry()
    wts = (ctypes.c_float * len(weights))(*weights)
    err = fn(path == "vec", u1.data_ptr(), u2.data_ptr(), out.data_ptr(), h,
             w, r, wts, 1.0 / (dx * dx), dt * dt, bh, bw, stream())
    if err:
        check(lib, err, name)
    fd2d.launches += 1
    fd2d.routes[path] += 1
    return out


fd2d.launches = 0
fd2d.routes = {"vec": 0, "scalar": 0}


# ---------------------------------------------------------------------------
# the op declaration (repro.kernels.apps.ops.fd2d)
# ---------------------------------------------------------------------------

def _fd2d_plain(u1, u2, *, weights, dx, dt):
    return fd2d_ref(u1, u2, weights, float(dx), float(dt))


def _fd_defines(args, params):
    """JAX's ``_fd_defines``: the tile (bh, bw) fitted to divide the
    field."""
    u1, u2 = args
    if u1.dim() != 2 or tuple(u2.shape) != tuple(u1.shape):
        raise ValueError(f"fd2d: u1 {tuple(u1.shape)}, u2 "
                         f"{tuple(u2.shape)} must be one (h, w) shape")
    h, w = (int(n) for n in u1.shape)
    weights = tuple(float(x) for x in params["weights"])
    return dict(w=w, h=h, r=(len(weights) - 1) // 2, weights=weights,
                dt=float(params["dt"]), dx=float(params["dx"]),
                bh=fit_block(params["bh"], h), bw=fit_block(params["bw"], w),
                dtype=str(u1.dtype).removeprefix("torch."))


def _fd_tune_ref(args, params):
    return _fd2d_plain(*args, weights=params["weights"], dx=params["dx"],
                       dt=params["dt"])


def _fd_tile(d):
    return min(d["bh"] or d["h"], d["h"]), min(d["bw"] or d["w"], d["w"])


def _fd_smem(d):
    return _smem(d["r"], _fd_tile(d)[1])


def _fd_refusal(d):
    return tile_refusal(d["r"], *_fd_tile(d))


def _fd_example(rng):
    u1 = rng.standard_normal((32, 32)).astype("float32")
    u2 = rng.standard_normal((32, 32)).astype("float32")
    return (u1, u2), dict(weights=(1.0, -2.0, 1.0), dx=2.0 / 32, dt=0.02,
                          bh=16, bw=32)


fd2d_op = define_op(
    "fd2d",
    builder=app_builder("fd2d", "fd2d_builder"),
    ref=_fd2d_plain,
    derive_defines=_fd_defines,
    vjp=oracle_vjp(_fd2d_plain, params=("weights", "dx", "dt")),
    defaults=dict(weights=(1.0, -2.0, 1.0), dx=1.0, dt=0.1,
                  bh=DEFAULT_BLOCK[0], bw=DEFAULT_BLOCK[1]),
    ref_params=("weights", "dx", "dt"),
    tune_ref=_fd_tune_ref,
    sweep=dict(bh=[8, 16, 32, 64, 128], bw=[32, 64, 128, 256]),
    smem=_fd_smem,
    refusal=_fd_refusal,
    tolerance=Tolerance(f32=(2e-5, 2e-5)),
    sources=("fd2d",),
    exact_knobs=True,
    example=_fd_example,
    doc="""One leapfrog step u3 = 2 u1 - u2 + dt^2 (u_xx + u_yy) on the
    periodic (h, w) f32 field; ``bh``/``bw`` the kernel's output tile.""",
)


# ---------------------------------------------------------------------------
# the cuda binding of the kernel language's "fd2d" spec (apps/fd2d.py's
# fd2d_builder): the halo tile is the kernel's own row ring
# ---------------------------------------------------------------------------

def _spec_refusal(spec, D):
    if as_dtype(D.dtype) != torch.float32:
        return f"dtype {D.dtype}; the kernel takes float32"
    r = (len(D.weights) - 1) // 2
    if len(D.weights) != 2 * r + 1 or r != D.r or not 1 <= r <= MAX_RADIUS:
        return (f"{len(D.weights)} weights at r = {D.r}; the kernel takes "
                f"2r + 1 with 1 <= r <= {MAX_RADIUS}")
    return tile_refusal(r, min(D.bh, D.h), min(D.bw, D.w))


def _spec_launch(D, ins, outs):
    return (fd2d(ins[0], ins[1], weights=D.weights, dx=D.dx, dt=D.dt,
                 block=(D.bh, D.bw), out=None if outs is None else outs[0]),)


bind_cuda("fd2d", wrapper=fd2d, launch=_spec_launch, refusal=_spec_refusal,
          launch_defines=("weights", "dx", "dt", "bh", "bw"))
