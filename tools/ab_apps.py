#!/usr/bin/env python3
"""fd2d's and dg_volume's times in several checkouts, side by side on one
card.

    python3 tools/ab_apps.py ROOT [ROOT ...]
    python3 tools/ab_apps.py --tiles

Each ROOT is a tree that holds ``chip_smoke.py`` and ``src/repro_torch``
(this checkout, or another commit unpacked with ``git archive``). The
``fd2d`` and ``dg`` libraries of every ROOT are built first, one ``nvcc``
each, all at once. Then each ROOT in the order given runs in a process of
its own, on the same seeded inputs:

- ``fd2d`` at the FD app's main-path shape (u 8192x8192 f32, r = 4), at
  the tile the tree's ``FDWave`` picks for that field;
- ``dg_volume`` at the DG app's (the unjittered 256 x 256 mesh's 131072
  triangles at N = 5, np 21, eb 64, its geometric factors and derivative
  matrices) on a seeded state (h = 1.5 + 0.1 N(0,1), momenta 0.3 N(0,1))
  and a seeded bathymetry gradient (50 N(0,1)).

It prints one JSON line per ROOT: ms per call from CUDA events around
back-to-back calls (``ms``, the call's clock), the sum of
``torch.profiler``'s device rows per call (``device_ms``, the kernels
alone), each device row (``rows``), a SHA-1 of fd2d's output and
dg_volume's largest error against the plain version in f64 relative to
the summed |terms| bound. A last line says whether fd2d's output is
bit-equal across the ROOTs. Give the trees as A B B A to see the drift
between runs. ``--tiles`` times this checkout's fd2d at the same inputs
with the tile (bh, bw) set to each of TILES in turn, and dg_volume with
eb set to each of EBS, every output held against the default's (fd2d:
bit-equal; dg_volume: within 2e-4 of max|ref|). Needs one card.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys

FD_SIZE, FD_RADIUS = 8192, 4
DG_NX, DG_N = 256, 5
TILES = ((32, 256), (64, 256), (128, 256), (256, 256), (64, 128),
         (128, 128), (128, 512), (64, 1024), (512, 256))
EBS = (16, 32, 64, 128)


def _build(roots):
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from repro_torch.kernels import _build; "
            "_build.build_all(('fd2d', 'dg'))")
    procs = [subprocess.Popen([sys.executable, "-c", code,
                               os.path.join(r, "src")])
             for r in dict.fromkeys(roots)]
    for p in procs:
        if p.wait() != 0:
            raise SystemExit(f"ab_apps: build failed ({p.args[-1]})")


def _time(fn, iters):
    """(ms, device ms, device rows) per call of fn."""
    import chip_smoke as cs
    import torch
    from torch.profiler import ProfilerActivity, profile

    ms = cs.cuda_ms(fn, iters=iters, warmup=3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = [(t, n, key[:100]) for t, n, key in cs.device_rows(prof, iters)]
    return dict(ms=ms, device_ms=sum(r[0] for r in rows), rows=rows)


def _fd_inputs(dev):
    """u1, u2 and the stencil of the FD app's main path, u1 and u2 seeded
    N(0,1) fields, and the tile the tree's FDWave picks."""
    import torch

    from repro_torch.apps.fd2d import FDWave

    fd = FDWave(width=FD_SIZE, height=FD_SIZE, radius=FD_RADIUS, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    u1 = torch.randn((FD_SIZE, FD_SIZE), generator=gen, device=dev)
    u2 = torch.randn((FD_SIZE, FD_SIZE), generator=gen, device=dev)
    return u1, u2, fd.weights, fd.dx, fd.dt, fd.block


def _dg_inputs(dev):
    """The DG app's volume inputs on a seeded state and bathymetry."""
    import torch

    from repro_torch.apps.dg_swe import DGVolume

    sol = DGVolume(nx=DG_NX, ny=DG_NX, n=DG_N, jitter=0.0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    q = torch.randn((sol.E, sol.np_, 3), generator=gen,
                    device=dev) * torch.tensor([0.1, 0.3, 0.3], device=dev)
    q[..., 0] += 1.5
    db = 50 * torch.randn(sol.db.shape, generator=gen, device=dev)
    return (q, sol.geom, db, sol.dr, sol.ds), sol.eb


def _rounding_share(got, args):
    """max over outputs of |got - f64 plain| / ((np + 16) 2^-24 x summed
    |terms|): <= 1 is within chip_smoke.check_rounding's bound."""
    import chip_smoke as cs

    from repro_torch.kernels.apps import GRAV, volume_ref

    a64 = [t.double() for t in args]
    bound = (args[0].shape[1] + 16) * 2.0 ** -24 * cs._volume_terms_abs(
        *a64, GRAV)
    return float(((got.double() - volume_ref(*a64)).abs() / bound).max())


def _one(root):
    sys.path[:0] = [root, os.path.join(root, "src")]
    import torch

    from repro_torch.kernels.apps import dg_volume, fd2d

    dev = torch.device("cuda")
    out = {"root": root}
    with torch.no_grad():
        u1, u2, wts, dx, dt, block = _fd_inputs(dev)
        u3 = torch.empty_like(u1)

        def step():
            return fd2d(u1, u2, weights=wts, dx=dx, dt=dt, block=block,
                        out=u3)

        out["fd2d"] = dict(block=block, **_time(step, 50))
        step()
        out["fd2d"]["sha1"] = hashlib.sha1(
            u3.cpu().numpy().tobytes()).hexdigest()
        del u1, u2, u3
        args, eb = _dg_inputs(dev)
        out["dg_volume"] = dict(eb=eb, **_time(
            lambda: dg_volume(*args, eb=eb), 100))
        out["dg_volume"]["rounding_share"] = _rounding_share(
            dg_volume(*args, eb=eb), args)
    print(json.dumps(out), flush=True)


def _tiles(root):
    sys.path[:0] = [root, os.path.join(root, "src")]
    import torch

    import chip_smoke as cs
    from repro_torch.kernels.apps import dg_volume, fd2d, volume_ref

    dev = torch.device("cuda")
    with torch.no_grad():
        u1, u2, wts, dx, dt, default = _fd_inputs(dev)
        want = fd2d(u1, u2, weights=wts, dx=dx, dt=dt, block=default)
        u3 = torch.empty_like(u1)
        for block in TILES:
            def step(block=block):
                return fd2d(u1, u2, weights=wts, dx=dx, dt=dt, block=block,
                            out=u3)
            res = _time(step, 30)
            step()
            print(json.dumps(dict(kernel="fd2d", block=block,
                                  default=default,
                                  bit_equal=bool(torch.equal(u3, want)),
                                  **res)), flush=True)
        del u1, u2, u3, want
        args, default = _dg_inputs(dev)
        ref = volume_ref(*args)
        for eb in EBS:
            err = cs.check_rel(f"dg_volume eb={eb}", dg_volume(*args, eb=eb),
                               ref, 2e-4, quiet=True)
            print(json.dumps(dict(kernel="dg_volume", eb=eb, default=default,
                                  max_abs_err=err, **_time(
                                      lambda eb=eb: dg_volume(*args, eb=eb),
                                      100))), flush=True)


def _card():
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"[card] {card}", flush=True)


def main(argv):
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if len(argv) == 2 and argv[0] == "--one":
        _one(os.path.abspath(argv[1]))
        return 0
    if argv == ["--tiles"]:
        _card()
        _build([here])
        _tiles(here)
        return 0
    if not argv or argv[0].startswith("-"):
        print(__doc__, file=sys.stderr)
        return 2
    roots = [os.path.abspath(r) for r in argv]
    _card()
    _build(roots)
    sums = []
    for root in roots:
        run = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one", root], check=True, text=True,
                             stdout=subprocess.PIPE)
        print(run.stdout, end="", flush=True)
        sums.append(json.loads(run.stdout.splitlines()[-1])["fd2d"]["sha1"])
    print(json.dumps(dict(fd2d_bit_equal_across_roots=len(set(sums)) == 1,
                          sha1=sums)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
