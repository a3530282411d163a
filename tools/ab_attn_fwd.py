#!/usr/bin/env python3
"""The tensor-core attention forward's time in several checkouts, side by
side on one card.

    python3 tools/ab_attn_fwd.py [--paligemma] ROOT [ROOT ...]

Each ROOT is a tree that holds ``chip_smoke.py`` and ``src/repro_torch``
(this checkout, or another commit unpacked with ``git archive``). The
``flash_fwd`` and ``ring_flash`` libraries of every ROOT are built first,
one ``nvcc`` each, all at once. Then each ROOT in the order given runs in a
process of its own, with ``chip_smoke.py``'s own inputs:

- ``flash_attention_fwd`` at an admission prefill (q 1x32x1000x64) and at
  the train step's shape (q 4x32x1024x64, k/v 4x8x1024x64), the
  projections' views, causal;
- ``ring_flash_fwd`` over the 16 (rank, step) pairs of the replayed 4-rank
  ring (q 1x32x4096x64 against a chunk 1x8x4096x64, bf16, causal);

or, with ``--paligemma``, only ``flash_attention_fwd`` at paligemma_3b's
prefix-LM prefill (q 4x8x768x256 over one kv head, the projections'
views, causal with a 256-token prefix), which trees from before head dim
256 and the prefix do not take.

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

ITERS = 20


def _build(roots):
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from repro_torch.kernels import _build; "
            "_build.build_all(('flash_fwd', 'ring_flash'))")
    procs = [subprocess.Popen([sys.executable, "-c", code,
                               os.path.join(r, "src")])
             for r in dict.fromkeys(roots)]
    for p in procs:
        if p.wait() != 0:
            raise SystemExit(f"ab_attn_fwd: build failed ({p.args[-1]})")


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


def _one(root, paligemma=False):
    sys.path[:0] = [root, os.path.join(root, "src")]
    import chip_smoke as cs
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import (flash_attention_fwd,
                                                     ring_flash_fwd)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(42)
    out = {"root": root}
    if paligemma:
        cfg = get_config("paligemma_3b")
        p, b = cfg.num_prefix_embeddings, cs.PG_BATCH
        s, d = p + cs.PG_PROMPT, cfg.resolved_head_dim
        fq, fk, fv = (cs._proj(gen, b, s, heads, d)
                      for heads in (cfg.n_heads, 1, 1))
        with torch.no_grad():
            out["flash_fwd@paligemma"] = _time(
                lambda: flash_attention_fwd(fq, fk, fv, causal=True,
                                            prefix_len=p), 1)
        print(json.dumps(out), flush=True)
        return
    n = cs.RING_STEPS
    c = cs.RING_SEQ // n
    q, k, v, _ = cs._ring_inputs(dev, gen, cs.RING_SEQ)

    def part(x, j):
        return x[:, :, j * c:(j + 1) * c]

    ring = [(part(q, i), part(k, j), part(v, j), *cs._offsets(dev, qs, ks))
            for i, _, j, qs, ks in cs._replay_pairs(n, c, c)]

    cfg = get_config("llama3_2_1b")
    h, hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    shapes = {"flash_fwd@prefill": (1, 1000),
              "flash_fwd@train": (cs.TRAIN_BATCH, cs.TRAIN_SEQ)}
    with torch.no_grad():
        for name, (b, s) in shapes.items():
            fq, fk, fv = (cs._proj(gen, b, s, heads, hd)
                          for heads in (h, hk, hk))
            out[name] = _time(lambda: flash_attention_fwd(fq, fk, fv,
                                                          causal=True), 1)

        def ring_fwd():
            for r in ring:
                ring_flash_fwd(*r)

        out["ring_flash_fwd"] = _time(ring_fwd, len(ring))
    print(json.dumps(out), flush=True)


def main(argv):
    if argv[:1] == ["--one"]:
        _one(os.path.abspath(argv[1]), argv[2:] == ["--paligemma"])
        return 0
    flags = ["--paligemma"] if argv[:1] == ["--paligemma"] else []
    argv = argv[len(flags):]
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
                        root, *flags], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
