"""2-D finite-difference acoustic wave equation (the paper's FD app) in
the kernel language: the counterpart of ``repro.apps.fd2d``.

u_tt = u_xx + u_yy on the periodic square [-1,1]^2; leapfrog in time with
an order-2r central stencil in space. Mirrors the paper's code listings
8-9: :func:`fd2d_builder` is the kernel (fd2d.occa) and ``FDWave`` the host
code (``malloc``, ``build_kernel`` with defines, ``swap``). With
``block=None`` it adopts the ``fd2d`` op's persisted tune winner for its
field (:func:`fd_probe` is the shape ``tune_cli --apps`` tunes).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import Device, Spec, Tile, as_dtype, resolve_model
from ..device import fit_block
from ..kernels.apps.fd2d import DEFAULT_BLOCK, fd2d_op
from ..kernels.apps.fd2d import fd2d_ref as reference_step
from .numerics import fd_second_derivative_weights

__all__ = ["FDWave", "fd2d_builder", "reference_step", "fd_flops_per_step",
           "fd_probe"]


def fd2d_builder(D):
    """Kernel builder (the paper's fd2d.occa). Defines: w, h, bh, bw, r,
    dt, dx, weights, dtype.

    Each grid cell owns a ``(bh, bw)`` block of the field and reads it
    through a halo tile: the block plus its r-point periodic fringe on
    every side, the ``(bh + 2r, bw + 2r)`` window. The sum runs in the JAX
    builder's order (per k the vertical term, then the horizontal one)."""
    weights = tuple(D.weights)
    inv_dx2 = 1.0 / (D.dx * D.dx)
    dt2 = D.dt * D.dt
    dtype = as_dtype(D.dtype)
    r, bh, bw, w, h = D.r, D.bh, D.bw, D.w, D.h

    def body(ctx, u1, u2, u3):
        win = ctx.cache(u1)                  # (bh+2r, bw+2r) haloed window
        ctx.barrier()                        # halo cached ("shared")
        inner = win[r:r + bh, r:r + bw]
        lap = torch.zeros((bh, bw), dtype=torch.float32, device=win.device)
        for k in range(-r, r + 1):           # unrolled radius loop
            wk = weights[k + r]
            lap = lap + wk * win[r + k:r + k + bh, r:r + bw]    # vertical
            lap = lap + wk * win[r:r + bh, r + k:r + k + bw]    # horizontal
        lap = lap * inv_dx2
        u3[...] = (2.0 * inner - u2[...] + dt2 * lap).to(dtype)

    return Spec(
        "fd2d",
        grid=(h // bh, w // bw),
        inputs=[
            Tile("u1", (h, w), dtype, block=(bh, bw), halo=(r, r), wrap=True),
            Tile("u2", (h, w), dtype, block=(bh, bw)),
        ],
        outputs=[Tile("u3", (h, w), dtype, block=(bh, bw))],
        body=body,
    )


def fd_probe(width: int, height: int, radius: int, cfl: float = 0.5):
    """The ``fd2d`` op's probe at an FD wave's shapes: ((u1, u2) as meta
    tensors, params), as :class:`FDWave` looks its winner up."""
    u = torch.empty((height, width), dtype=torch.float32, device="meta")
    dx = 2.0 / width
    weights = tuple(float(x) for x in fd_second_derivative_weights(radius))
    return (u, u), dict(weights=weights, dx=dx, dt=cfl * dx / np.sqrt(2.0))


def fd_flops_per_step(w: int, h: int, r: int) -> int:
    # per node: (2r+1) * (2 rolls * 1 mul + 2 add) ~= 4*(2r+1) + 5 update ops
    return w * h * (4 * (2 * r + 1) + 5)


class FDWave:
    """Host driver mirroring the paper's listing 9.

    ``model``: the backend its kernel is built for (``"cuda"``, the
    hand-written kernel; ``"torch"`` or ``"loops"``, the language's
    expansions); None takes ``"cuda"`` on the card and ``"torch"`` with
    ``device="cpu"``. Runs on the CUDA card unless ``device="cpu"``.
    ``block=None`` takes the ``fd2d`` op's persisted tune winner for this
    field on this device (``fd2d_op.cached_winner``), else the default tile
    (32, 256); an explicit ``block=(bh, bw)`` pins it (0 means the full
    extent). The tile is fitted to divide the field (``fit_block``), as the
    JAX driver's defines are. ``self.tuned`` is the winner taken, or
    None."""

    def __init__(self, *, model: str | None = None, width: int = 128,
                 height: int = 128, radius: int = 1, cfl: float = 0.5,
                 block: tuple[int, int] | None = None, device=None):
        self.model, dev = resolve_model(model, device)
        self.occa = Device(self.model, device=dev)
        self.device = dev
        self.w, self.h, self.r = width, height, radius
        self.dx = 2.0 / width
        self.dt = cfl * self.dx / np.sqrt(2.0)
        self.dtype = np.dtype("float32")
        self.tuned = None
        if block is None:
            args, params = fd_probe(width, height, radius, cfl)
            self.tuned = fd2d_op.cached_winner(args, device=dev, **params)
        if self.tuned:
            block = (self.tuned["bh"], self.tuned["bw"])
        elif block is None:
            block = DEFAULT_BLOCK
        self.block = (fit_block(block[0] or height, height),
                      fit_block(block[1] or width, width))
        self.current_time = 0.0
        self.weights = tuple(float(x)
                             for x in fd_second_derivative_weights(radius))
        self._setup_solver()

    # paper: setupSolver()
    def _setup_solver(self):
        w, h = self.w, self.h
        x = np.linspace(-1, 1, w, endpoint=False)
        y = np.linspace(-1, 1, h, endpoint=False)
        X, Y = np.meshgrid(x, y)
        # standing wave initial condition: u = cos(pi x) cos(pi y) cos(omega t)
        self.omega = np.pi * np.sqrt(2.0)
        u0 = (np.cos(np.pi * X) * np.cos(np.pi * Y)).astype(self.dtype)
        # second initial slice at t = -dt (exact): cos(omega * -dt) factor
        um1 = (u0 * np.cos(self.omega * self.dt)).astype(self.dtype)

        self.o_u1 = self.occa.malloc(u0)     # u at t_n
        self.o_u2 = self.occa.malloc(um1)    # u at t_{n-1}
        self.o_u3 = self.occa.malloc((h, w))
        defines = dict(w=w, h=h, r=self.r, weights=self.weights,
                       dx=float(self.dx), dt=float(self.dt),
                       bh=self.block[0], bw=self.block[1], dtype="float32")
        self.fd2d = self.occa.build_kernel(fd2d_builder, defines)

    @property
    def u1(self):
        return self.o_u1.data

    @property
    def u2(self):
        return self.o_u2.data

    @property
    def u3(self):
        return self.o_u3.data

    # paper: timestep()
    def timestep(self):
        self.current_time += self.dt
        self.fd2d(self.o_u1, self.o_u2, self.o_u3)
        # rotate solutions (the paper's swap chain): u1 <- u_{n+1},
        # u2 <- u_n, and u3 takes u_{n-1}'s memory for the next step
        self.o_u2.swap(self.o_u3)
        self.o_u1.swap(self.o_u2)

    def run(self, nsteps: int):
        for _ in range(nsteps):
            self.timestep()
        self.occa.synchronize()
        return self

    @property
    def solution(self) -> np.ndarray:
        return self.o_u1.to_host()  # u at current_time (after rotation)

    def analytic(self) -> np.ndarray:
        x = np.linspace(-1, 1, self.w, endpoint=False)
        y = np.linspace(-1, 1, self.h, endpoint=False)
        X, Y = np.meshgrid(x, y)
        return (np.cos(np.pi * X) * np.cos(np.pi * Y)
                * np.cos(self.omega * self.current_time)).astype(self.dtype)
