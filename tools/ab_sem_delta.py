#!/usr/bin/env python3
"""sem_apply's and flash_delta's times in several checkouts, side by side on
one card.

    python3 tools/ab_sem_delta.py ROOT [ROOT ...]
    python3 tools/ab_sem_delta.py --ebs

Each ROOT is a tree that holds ``chip_smoke.py`` and ``src/repro_torch``
(this checkout, or another commit unpacked with ``git archive``). The
``sem`` library of every ROOT, and its ``flash_delta`` library where the
tree has ``csrc/flash_delta.cu`` (before, the delta was a Triton kernel,
compiled at its first call), are built first, one ``nvcc`` each, all at
once. Then each ROOT in the order given runs in a process of its own, on
the same seeded inputs:

- ``sem_apply`` at the SEM app's main path (E = 32768 elements of N = 7,
  nq 8, at the eb the tree's ``SEMOperator`` picks there: fit_block of
  its ``DEFAULT_EB``; u and geo seeded N(0,1), dmat the GLL derivative
  matrix);
- ``flash_delta`` at the train step's shape (do and o 4x32x1024x64 bf16,
  do a transposed view of a 4x1024x32x64 tensor, as the step passes it).

It prints one JSON line per ROOT: ms per call from CUDA events around
back-to-back calls (``ms``, the call's clock), the sum of
``torch.profiler``'s device rows per call (``device_ms``, the kernels
alone), each device row (``rows``), and each output's largest error
against its plain version (sem relative to max|ref|). Give the trees as
A B B A to see the drift between runs. ``--ebs`` times this checkout's
``sem_apply`` with eb set to each of EBS at E = 32768 and at E = 512 (the
PCG solve's 8^3 mesh), each output held against the plain version within
2e-4 of max|ref|. Needs one card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

SEM_E, SEM_N = 32768, 7
SOLVE_E = 512
DELTA_SHAPE = (4, 32, 1024, 64)      # B, H, S, D of the train step
EBS = (8, 16, 32, 64, 128)


def _build(roots):
    code = ("import os, sys; sys.path.insert(0, sys.argv[1]); "
            "from repro_torch.kernels import _build; "
            "_build.build_all(tuple(n for n in ('sem', 'flash_delta') "
            "if os.path.exists(os.path.join(_build.CSRC, n + '.cu'))))")
    procs = [subprocess.Popen([sys.executable, "-c", code,
                               os.path.join(r, "src")])
             for r in dict.fromkeys(roots)]
    for p in procs:
        if p.wait() != 0:
            raise SystemExit(f"ab_sem_delta: build failed ({p.args[-1]})")


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


def _sem_inputs(dev, E):
    """u and geo seeded N(0,1) on E elements of N = 7, dmat the GLL
    derivative matrix."""
    import torch

    from repro_torch.apps.numerics import dmatrix_1d

    nq = SEM_N + 1
    gen = torch.Generator(device=dev).manual_seed(11 + E)
    u = torch.randn((E, nq, nq, nq), generator=gen, device=dev)
    geo = torch.randn((E, 7, nq, nq, nq), generator=gen, device=dev)
    dmat = torch.as_tensor(dmatrix_1d(SEM_N), dtype=torch.float32,
                           device=dev)
    return u, geo, dmat


def _sem_err(got, u, geo, dmat):
    from repro_torch.kernels.apps import apply_ref

    ref = apply_ref(u, geo, dmat)
    return float((got - ref).abs().max() / ref.abs().max())


def _delta_inputs(dev):
    import torch

    b, h, s, d = DELTA_SHAPE
    gen = torch.Generator(device=dev).manual_seed(12)
    do = torch.randn((b, s, h, d), generator=gen, device=dev).to(
        torch.bfloat16).transpose(1, 2)
    o = torch.randn((b, h, s, d), generator=gen, device=dev).to(
        torch.bfloat16)
    return do, o


def _one(root):
    sys.path[:0] = [root, os.path.join(root, "src")]
    import torch

    from repro_torch.device import fit_block
    from repro_torch.kernels.apps import sem_apply
    from repro_torch.kernels.apps.sem import DEFAULT_EB
    from repro_torch.kernels.flash_attention import (flash_delta,
                                                     flash_delta_ref)

    dev = torch.device("cuda")
    out = {"root": root}
    eb = fit_block(DEFAULT_EB, SEM_E)
    with torch.no_grad():
        u, geo, dmat = _sem_inputs(dev, SEM_E)
        out["sem_apply"] = dict(
            E=SEM_E, nq=SEM_N + 1, eb=eb,
            routes=getattr(sem_apply, "routes", None),
            max_rel_err=_sem_err(sem_apply(u, geo, dmat, eb=eb), u, geo,
                                 dmat),
            **_time(lambda: sem_apply(u, geo, dmat, eb=eb), 50))
        del u, geo
        do, o = _delta_inputs(dev)
        out["flash_delta"] = dict(
            shape=list(DELTA_SHAPE), do_strides=list(do.stride()),
            max_abs_err=float((flash_delta(do, o) - flash_delta_ref(do, o))
                              .abs().max()),
            **_time(lambda: flash_delta(do, o), 100))
        out["flash_delta"]["routes"] = getattr(flash_delta, "routes", None)
    print(json.dumps(out), flush=True)


def _ebs(root):
    sys.path[:0] = [root, os.path.join(root, "src")]
    import torch

    from repro_torch.kernels.apps import sem_apply

    dev = torch.device("cuda")
    with torch.no_grad():
        for E in (SEM_E, SOLVE_E):
            u, geo, dmat = _sem_inputs(dev, E)
            for eb in EBS:
                err = _sem_err(sem_apply(u, geo, dmat, eb=eb), u, geo, dmat)
                if not err <= 2e-4:
                    raise SystemExit(f"sem_apply E={E} eb={eb}: max rel err "
                                     f"{err:.3e} > 2e-4")
                print(json.dumps(dict(kernel="sem_apply", E=E, eb=eb,
                                      max_rel_err=err, **_time(
                                          lambda eb=eb: sem_apply(
                                              u, geo, dmat, eb=eb),
                                          50 if E == SEM_E else 200))),
                      flush=True)
            del u, geo


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
    if argv == ["--ebs"]:
        _card()
        _build([here])
        _ebs(here)
        return 0
    if not argv or argv[0].startswith("-"):
        print(__doc__, file=sys.stderr)
        return 2
    roots = [os.path.abspath(r) for r in argv]
    _card()
    _build(roots)
    for root in roots:
        run = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one", root], check=True, text=True,
                             stdout=subprocess.PIPE)
        print(run.stdout, end="", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
