#!/usr/bin/env python3
"""The tensor-core attention backward's time in several checkouts, side by
side on one card.

    python3 tools/ab_attn_bwd.py ROOT [ROOT ...]

Each ROOT is a tree that holds ``chip_smoke.py`` and ``src/repro_torch``
(this checkout, or another commit unpacked with ``git archive``). The
``ring_flash`` and ``flash_bwd`` libraries of every ROOT are built first,
one ``nvcc`` each, all at once. Then each ROOT in the order given runs in a
process of its own, with ``chip_smoke.py``'s own inputs:

- ``ring_flash_bwd`` over the 16 (rank, step) pairs of the replayed 4-rank
  ring (q 1x32x4096x64 against a chunk 1x8x4096x64, bf16, causal);
- ``flash_bwd`` at the train step's shape (q 4x32x1024x64, k/v
  4x8x1024x64, the projections' views, causal).

It prints one JSON line per ROOT: ms per launch from CUDA events around
back-to-back calls (``ms``), the sum of ``torch.profiler``'s device rows per
launch (``device_ms``) and each device row (``rows``: ms per launch, calls
per launch, kernel). Give the trees as A B B A to see the drift between
runs. Needs one card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

ITERS = 10


def _build(roots):
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from repro_torch.kernels import _build; "
            "_build.build_all(('ring_flash', 'flash_bwd'))")
    procs = [subprocess.Popen([sys.executable, "-c", code,
                               os.path.join(r, "src")])
             for r in dict.fromkeys(roots)]
    for p in procs:
        if p.wait() != 0:
            raise SystemExit(f"ab_attn_bwd: build failed ({p.args[-1]})")


def _time(fn, per):
    """(ms, device ms, device rows) per launch of fn, which makes ``per``
    launches."""
    import chip_smoke as cs
    import torch
    from torch.profiler import ProfilerActivity, profile

    ms = cs.cuda_ms(fn, iters=ITERS, warmup=2) / per
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(ITERS):
            fn()
        torch.cuda.synchronize()
    rows = [(t / per, n / per, key[:100])
            for t, n, key in cs.device_rows(prof, ITERS)]
    return dict(ms=ms, device_ms=sum(r[0] for r in rows), rows=rows)


def _one(root):
    sys.path[:0] = [root, os.path.join(root, "src")]
    import chip_smoke as cs
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import (flash_attention_fwd,
                                                     flash_bwd, flash_delta,
                                                     ring_flash_bwd,
                                                     ring_flash_fwd)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(42)
    n = cs.RING_STEPS
    c = cs.RING_SEQ // n
    q, k, v, do = cs._ring_inputs(dev, gen, cs.RING_SEQ)

    def part(x, j):
        return x[:, :, j * c:(j + 1) * c]

    ring = []
    for i, _, j, qs, ks in cs._replay_pairs(n, c, c):
        qq, kc, vc = part(q, i), part(k, j), part(v, j)
        dd = part(do, i).contiguous()
        offs = cs._offsets(dev, qs, ks)
        o, lse = ring_flash_fwd(qq, kc, vc, *offs)
        ring.append((qq, kc, vc, dd, lse, flash_delta(dd, o), *offs))

    cfg = get_config("llama3_2_1b")
    b, s, hd = cs.TRAIN_BATCH, cs.TRAIN_SEQ, cfg.resolved_head_dim
    fq, fk, fv, fdo = (cs._proj(gen, b, s, heads, hd)
                       for heads in (cfg.n_heads, cfg.n_kv_heads,
                                     cfg.n_kv_heads, cfg.n_heads))
    with torch.no_grad():
        fo, flse = flash_attention_fwd(fq, fk, fv, causal=True)
    fdelta = flash_delta(fdo, fo)

    def ring_bwd():
        for r in ring:
            ring_flash_bwd(*r)

    out = {"root": root,
           "ring_flash_bwd": _time(ring_bwd, len(ring)),
           "flash_bwd": _time(lambda: flash_bwd(fq, fk, fv, fdo, flse, fdelta,
                                                causal=True), 1)}
    print(json.dumps(out), flush=True)


def main(argv):
    if len(argv) == 2 and argv[0] == "--one":
        _one(os.path.abspath(argv[1]))
        return 0
    if not argv or argv[0].startswith("-"):
        print(__doc__, file=sys.stderr)
        return 2
    roots = [os.path.abspath(r) for r in argv]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"[card] {card}", flush=True)
    _build(roots)
    for root in roots:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one",
                        root], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
