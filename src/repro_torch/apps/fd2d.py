"""2-D finite-difference acoustic wave equation (the paper's FD app) through
the ``fd2d`` kernel: the counterpart of ``repro.apps.fd2d``.

u_tt = u_xx + u_yy on the periodic square [-1,1]^2; leapfrog in time with
an order-2r central stencil in space. ``FDWave`` keeps the paper's host
code (setup, timestep, swap chain) with explicit tensors where the JAX
driver uses the OCCA host API.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import fit_block, resolve_device
from ..kernels.apps.fd2d import DEFAULT_BLOCK, fd2d
from ..kernels.apps.fd2d import fd2d_ref as reference_step
from .numerics import fd_second_derivative_weights

__all__ = ["FDWave", "reference_step", "fd_flops_per_step"]


def fd_flops_per_step(w: int, h: int, r: int) -> int:
    # per node: (2r+1) * (2 rolls * 1 mul + 2 add) ~= 4*(2r+1) + 5 update ops
    return w * h * (4 * (2 * r + 1) + 5)


class FDWave:
    """Host driver mirroring the paper's listing 9.

    ``block=None`` takes the op's default tile (32, 256) fitted to the
    field with ``fit_block``; an explicit ``block=(bh, bw)`` pins the
    kernel's tile (0 means the full extent; the kernel masks a ragged
    edge). Runs on the CUDA card unless ``device="cpu"``."""

    def __init__(self, *, width: int = 128, height: int = 128,
                 radius: int = 1, cfl: float = 0.5,
                 block: tuple[int, int] | None = None, device=None):
        self.device = resolve_device(device)
        self.w, self.h, self.r = width, height, radius
        self.dx = 2.0 / width
        self.dt = cfl * self.dx / np.sqrt(2.0)
        self.dtype = np.dtype("float32")
        if block is None:
            self.block = (fit_block(DEFAULT_BLOCK[0], height),
                          fit_block(DEFAULT_BLOCK[1], width))
        else:
            self.block = (block[0] or height, block[1] or width)
        self.current_time = 0.0
        self.weights = tuple(float(x)
                             for x in fd_second_derivative_weights(radius))
        self._setup_solver()

    # paper: setupSolver()
    def _setup_solver(self):
        x = np.linspace(-1, 1, self.w, endpoint=False)
        y = np.linspace(-1, 1, self.h, endpoint=False)
        X, Y = np.meshgrid(x, y)
        # standing wave initial condition: u = cos(pi x) cos(pi y) cos(omega t)
        self.omega = np.pi * np.sqrt(2.0)
        u0 = (np.cos(np.pi * X) * np.cos(np.pi * Y)).astype(self.dtype)
        # second initial slice at t = -dt (exact): cos(omega * -dt) factor
        um1 = (u0 * np.cos(self.omega * self.dt)).astype(self.dtype)
        self.u1 = torch.from_numpy(u0).to(self.device)    # u at t_n
        self.u2 = torch.from_numpy(um1).to(self.device)   # u at t_{n-1}
        self.u3 = torch.zeros_like(self.u1)

    # paper: timestep()
    def timestep(self):
        self.current_time += self.dt
        fd2d(self.u1, self.u2, weights=self.weights, dx=self.dx, dt=self.dt,
             block=self.block, out=self.u3)
        # rotate the three buffers (the paper's swap chain): u1 <- u_{n+1},
        # u2 <- u_n, and u3 takes u_{n-1}'s memory for the next step
        self.u1, self.u2, self.u3 = self.u3, self.u1, self.u2

    def run(self, nsteps: int):
        for _ in range(nsteps):
            self.timestep()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self

    @property
    def solution(self) -> np.ndarray:
        return self.u1.cpu().numpy()  # u at current_time (after rotation)

    def analytic(self) -> np.ndarray:
        x = np.linspace(-1, 1, self.w, endpoint=False)
        y = np.linspace(-1, 1, self.h, endpoint=False)
        X, Y = np.meshgrid(x, y)
        return (np.cos(np.pi * X) * np.cos(np.pi * Y)
                * np.cos(self.omega * self.current_time)).astype(self.dtype)
