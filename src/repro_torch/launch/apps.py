"""The paper's three apps end to end: the counterparts of
``examples/fd_wave.py`` and ``examples/sem_solve.py``, and a run of the DG
shallow-water solver.

  PYTHONPATH=src python -m repro_torch.launch.apps fd  [--size 256] [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.apps sem [--n 4 --elems 3] [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.apps swe [--nx 8 --n 3] [--device cpu]

Each runs on the CUDA card unless ``--device cpu`` is given, prints the
examples' lines and asserts what they assert: the FD wave within 5e-2 of
the analytic standing wave, the SEM solve within 0.05 of the manufactured
solution, and the SWE run finite, with h in (0.9, 1.2) and the water mass
conserved to 1e-5 relative.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..apps.dg_swe import (SWESolver, dg_flops_per_element,
                           dg_surface_flops_per_element, stable_dt)
from ..apps.fd2d import FDWave
from ..apps.sem import SEMOperator, gather, make_box_mesh, scatter_add

__all__ = ["pcg", "fd_wave", "sem_solve", "swe_run", "main"]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _require(ok, msg):
    """The examples' assertions, kept under ``python -O`` too."""
    if not ok:
        raise AssertionError(msg)


def pcg(apply_A, b, M_inv, *, tol=1e-8, maxiter=200):
    """Preconditioned conjugate gradients (``examples/sem_solve.py``'s):
    returns (x, iterations); stops when |r| < tol |b|."""
    x = torch.zeros_like(b)
    r = b - apply_A(x)
    z = M_inv * r
    p = z
    rz = torch.vdot(r, z)
    bnorm = float(torch.linalg.norm(b))
    for it in range(maxiter):
        Ap = apply_A(p)
        alpha = rz / torch.vdot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        if float(torch.linalg.norm(r)) < tol * bnorm:
            return x, it + 1
        z = M_inv * r
        rz_new = torch.vdot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
    return x, maxiter


def fd_wave(*, size=256, steps=200, device=None, log=print):
    """The FD acoustic wave against the analytic standing wave, at the
    example's radius 2 and cfl 0.3 (``examples/fd_wave.py``). Returns the
    app and its numbers."""
    app = FDWave(width=size, height=size, radius=2, cfl=0.3, device=device)
    _sync(app.device)
    t0 = time.perf_counter()
    app.run(steps)
    wall = time.perf_counter() - t0
    err = float(np.abs(app.solution - app.analytic()).max())
    mnodes = size * size * steps / wall / 1e6
    log(f"[fd] {app.device.type}: {size}x{size}, radius 2, {steps} "
        f"steps, t={app.current_time:.3f} max|err|={err:.2e}  "
        f"{mnodes:8.1f} MNodes/s")
    _require(err < 5e-2, f"FD wave diverged from the analytic solution "
             f"({err:.3e})")
    return dict(app=app, err=err, mnodes_s=mnodes, wall_s=wall)


def sem_solve(*, n=4, elems=3, device=None, log=print):
    """-div(grad u) + u = f on [-1,1]^3 with homogeneous Neumann BC and the
    manufactured solution u* = cos(pi x) cos(pi y) cos(pi z), solved by PCG
    on the assembled SEM operator (``examples/sem_solve.py``)."""
    e = elems
    op = SEMOperator(ex=e, ey=e, ez=e, n=n, deform=0.0, alpha=1.0,
                     device=device)
    dev = op.device
    (x, y, z), _, _ = make_box_mesh(e, e, e, n, deform=0.0)
    u_star = np.cos(np.pi * x) * np.cos(np.pi * y) * np.cos(np.pi * z)
    f = (3 * np.pi ** 2 + 1.0) * u_star

    # rhs = M f (lumped mass), assembled to global dofs
    rhs_loc = torch.from_numpy((op.mass * f).astype(np.float32)).to(dev)
    rhs = scatter_add(rhs_loc, op.gid_t, op.nglob)
    # Jacobi preconditioner from the assembled lumped mass
    diag = scatter_add(torch.from_numpy(op.mass.astype(np.float32)).to(dev),
                       op.gid_t, op.nglob)
    M_inv = 1.0 / diag

    _sync(dev)
    t0 = time.perf_counter()
    u, iters = pcg(op.apply_global, rhs, M_inv, tol=1e-7)
    _sync(dev)
    wall = time.perf_counter() - t0
    u_loc = gather(u, op.gid_t).cpu().numpy()
    err = float(np.abs(u_loc - u_star).max())
    log(f"[sem] {dev.type}: N={n}, E={op.E}, dofs={op.nglob}: PCG converged "
        f"in {iters} iters, max|u - u*| = {err:.3e} ({wall:.3f}s)")
    _require(err < 0.05, "SEM solve did not converge to the manufactured "
             f"solution ({err:.3e})")
    return dict(op=op, u=u, iters=iters, err=err, wall_s=wall)


def swe_run(*, nx=8, n=3, steps=50, device=None, log=print):
    """The DG shallow-water solver from a Gaussian hump at rest, between
    reflective walls (the state of ``test_swe_timestepping_stable_and_
    conservative``), stepped by :func:`stable_dt` of the start state.
    Returns the solver, the final state and its numbers."""
    sol = SWESolver(nx=nx, ny=nx, n=n, jitter=0.0, device=device)
    dev = sol.device
    x, y = sol.mesh["x"], sol.mesh["y"]
    h0 = 1.0 + 0.1 * np.exp(-20 * (x ** 2 + y ** 2))
    Q = torch.from_numpy(np.stack([h0, 0 * h0, 0 * h0], -1).astype(
        np.float32)).to(dev)
    dt = stable_dt(sol, Q)
    m0 = sol.mass(Q)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(steps):
        Q = sol.step(Q, dt)
    _sync(dev)
    wall = time.perf_counter() - t0
    m1 = sol.mass(Q)
    drift = abs(m1 - m0) / m0
    hmin, hmax = float(Q[..., 0].min()), float(Q[..., 0].max())
    flops = 5 * steps * sol.E * (dg_flops_per_element(sol.np_)
                                 + dg_surface_flops_per_element(sol.np_,
                                                                sol.nfp3))
    log(f"[swe] {dev.type}: N={n}, E={sol.E}, {steps} LSERK steps of "
        f"dt={dt:.4e}: {1e3 * wall / steps:.3f} ms/step, "
        f"{flops / wall / 1e9:.2f} GFLOP/s (kernel FLOPs), mass drift "
        f"{drift:.2e}, h in [{hmin:.4f}, {hmax:.4f}]")
    _require(bool(torch.isfinite(Q).all()), "SWE state went non-finite")
    _require(0.9 < hmin and hmax < 1.2, f"h left (0.9, 1.2): {hmin}, {hmax}")
    _require(drift < 1e-5, f"water mass not conserved: {drift:.3e} relative")
    return dict(solver=sol, Q=Q, dt=dt, steps=steps, drift=drift, hmin=hmin,
                hmax=hmax, wall_s=wall, ms_per_step=1e3 * wall / steps)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.apps",
                                 description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="app", required=True)
    fd = sub.add_parser("fd", help="FD acoustic wave vs the analytic one")
    fd.add_argument("--size", type=int, default=256)
    fd.add_argument("--steps", type=int, default=200)
    sem = sub.add_parser("sem", help="SEM screened-Coulomb PCG solve")
    sem.add_argument("--n", type=int, default=4)
    sem.add_argument("--elems", type=int, default=3)
    swe = sub.add_parser("swe", help="DG shallow water with walls")
    swe.add_argument("--nx", type=int, default=8)
    swe.add_argument("--n", type=int, default=3)
    swe.add_argument("--steps", type=int, default=50)
    for p in (fd, sem, swe):
        p.add_argument("--device", default=None,
                       help="cpu runs the plain PyTorch versions (default: "
                            "the CUDA card)")
    args = ap.parse_args(argv)
    if args.app == "fd":
        return fd_wave(size=args.size, steps=args.steps, device=args.device)
    if args.app == "sem":
        return sem_solve(n=args.n, elems=args.elems, device=args.device)
    return swe_run(nx=args.nx, n=args.n, steps=args.steps,
                   device=args.device)


if __name__ == "__main__":
    main()
