"""One leapfrog step of the FD wave app: the CUDA kernel (``csrc/fd2d.cu``)
on CUDA tensors, the plain version on the CPU (the counterpart of
``repro.kernels.apps.ops.fd2d`` and its ``_fd_defines``).

``fd2d(u1, u2, weights=, dx=, dt=)`` returns
``u3 = 2 u1 - u2 + dt^2 (u_xx + u_yy)`` on the periodic (h, w) f32 field,
with the order-2r central stencil ``weights``. ``out=`` writes into a
preallocated tensor (FDWave's swap chain), so a step allocates nothing.
"""

from __future__ import annotations

import ctypes

import torch

from .._build import check, load, ptr, stream
from ._common import SMEM_MAX, app_on_cpu

__all__ = ["fd2d", "fd2d_ref", "DEFAULT_BLOCK", "MAX_RADIUS"]

DEFAULT_BLOCK = (32, 256)  # (bh, bw): the JAX op's defaults
MAX_RADIUS = 8
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIG = {"fd2d": ([_P] * 3 + [_I] * 3 + [_P, _F, _F, _I, _I, _P], _I)}


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
    smem = 4 * (bh + 2 * r) * (bw + 2 * r)
    if bh < 1 or bw < 1 or smem > SMEM_MAX:
        raise ValueError(f"{name}: tile ({bh}, {bw}) with radius {r} needs "
                         f"{smem} B of shared memory (at most {SMEM_MAX})")
    if out is None:
        out = torch.empty_like(u1)
    elif out.data_ptr() == u1.data_ptr():
        raise ValueError(f"{name}: out must not alias u1")
    lib = load("fd2d", _SIG)
    wts = (ctypes.c_float * len(weights))(*weights)
    err = lib.fd2d(ptr(u1), ptr(u2), ptr(out), h, w, r, wts,
                   1.0 / (dx * dx), dt * dt, bh, bw, stream())
    check(lib, err, name)
    fd2d.launches += 1
    return out


fd2d.launches = 0
