#!/usr/bin/env python3
"""rmsnorm's and paged decode's times in several checkouts, side by side on
one card.

    python3 tools/ab_norm_paged.py ROOT [ROOT ...]
    python3 tools/ab_norm_paged.py --splits

Each ROOT is a tree that holds ``chip_smoke.py`` and ``src/repro_torch``
(this checkout, or another commit unpacked with ``git archive``). The
``rmsnorm`` (where the tree has it as a CUDA source) and ``paged_decode``
libraries of every ROOT are built first, one ``nvcc`` each, all at once.
Then each ROOT in the order given runs in a process of its own, with
``chip_smoke.py``'s own inputs:

- ``rmsnorm`` at the decode step's shape (x 8x1x2048 bf16, w f32) and at
  the train step's (x 4096x2048 bf16), and ``F.rms_norm`` at the decode
  shape (bf16 weight) beside it;
- ``paged_decode_attention`` at phase 8's decode step (q 8x32x1x64 bf16,
  pools 33x8x512x64, the first 8 requests' lengths + 16), cycling the 16
  layers' pools as a step does.

It prints one JSON line per ROOT: ms per call from CUDA events around
back-to-back calls (``ms``, the call's clock), the sum of
``torch.profiler``'s device rows per call (``device_ms``, the kernels
alone) and each device row (``rows``: ms per call, launches per call,
kernel). Give the trees as A B B A to see the drift between runs.
``--splits`` times this checkout's paged decode at the same inputs with the
split length forced to each of 32, 64, 128, 256 and 512 slots in turn (the
data behind ``paged_split``'s rule), its output held against the plain
version. Needs one card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

ITERS = 100


def _build(roots):
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from repro_torch.kernels import _build; "
            "_build.build_all([n for n in ('rmsnorm', 'paged_decode') "
            "if n in _build.SOURCES])")
    procs = [subprocess.Popen([sys.executable, "-c", code,
                               os.path.join(r, "src")])
             for r in dict.fromkeys(roots)]
    for p in procs:
        if p.wait() != 0:
            raise SystemExit(f"ab_norm_paged: build failed ({p.args[-1]})")


def _time(fn):
    """(ms, device ms, device rows) per call of fn."""
    import chip_smoke as cs
    import torch
    from torch.profiler import ProfilerActivity, profile

    ms = cs.cuda_ms(fn, iters=ITERS, warmup=5)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(ITERS):
            fn()
        torch.cuda.synchronize()
    rows = [(t, n, key[:100]) for t, n, key in cs.device_rows(prof, ITERS)]
    return dict(ms=ms, device_ms=sum(r[0] for r in rows), rows=rows)


def _one(root, splits=False):
    sys.path[:0] = [root, os.path.join(root, "src")]
    import chip_smoke as cs
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import paged_decode_attention
    from repro_torch.kernels.rmsnorm import rmsnorm

    dev = torch.device("cuda")
    bf = torch.bfloat16
    cfg = get_config("llama3_2_1b")
    d, h, hd, eps = cfg.d_model, cfg.n_heads, cfg.resolved_head_dim, \
        cfg.norm_eps
    gen = torch.Generator(device=dev).manual_seed(3)
    out = {"root": root}

    w = torch.ones(d, device=dev)
    for name, rows in (("rmsnorm@decode", 8), ("rmsnorm@train",
                                                cs.TRAIN_BATCH
                                                * cs.TRAIN_SEQ)):
        x = torch.randn((rows, 1, d), generator=gen, device=dev).to(bf)
        out[name] = _time(lambda: rmsnorm(x, w, eps=eps))
    x = torch.randn((8, 1, d), generator=gen, device=dev).to(bf)
    wb = w.to(bf)
    out["F.rms_norm@decode"] = _time(lambda: F.rms_norm(x, (d,), wb, eps))

    page, num_pages, slots = 512, 8 * 4 + 1, 8
    reqs = cs.traffic(0, 16, cfg.vocab_size)
    lens = [len(p) + 16 for p, _ in reqs[:slots]]
    nl = cfg.n_layers
    pools, table, kv_len, pos = cs.paged_state(dev, cfg, lens, page,
                                               num_pages, nl, bf, gen)
    qd = torch.randn((slots, h, 1, hd), generator=gen, device=dev).to(bf)
    it = iter(range(1 << 30))

    def paged():
        kp, vp = pools[next(it) % nl]
        return paged_decode_attention(qd, kp, vp, block_table=table,
                                      kv_len=kv_len, pos_pages=pos)

    if splits:
        from repro_torch.kernels.flash_attention import ops, paged_decode_ref

        ref = paged_decode_ref(qd, *pools[0], block_table=table,
                               kv_len=kv_len, pos_pages=pos).float()
        rule = ops.paged_split
        try:
            for split in (32, 64, 128, 256, 512):
                ops.paged_split = (lambda b, hk, nsp, page, s=split:
                                   (s, -(-nsp * page // s)))
                o = paged_decode_attention(qd, *pools[0], block_table=table,
                                           kv_len=kv_len, pos_pages=pos)
                err = float((o.float() - ref).abs().max())
                if not err < 2e-2:
                    raise SystemExit(f"ab_norm_paged: split {split}: max "
                                     f"|err| {err} against the plain version")
                print(json.dumps(dict(split=split, max_abs_err=err,
                                      rule=rule(slots, cfg.n_kv_heads,
                                                table.shape[1], page)[0],
                                      **_time(paged))),
                      flush=True)
        finally:
            ops.paged_split = rule
        return
    out["paged_decode"] = _time(paged)
    out["paged_decode"]["lens"] = lens
    print(json.dumps(out), flush=True)


def _card():
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"[card] {card}", flush=True)


def main(argv):
    if len(argv) == 2 and argv[0] == "--one":
        _one(os.path.abspath(argv[1]))
        return 0
    if argv == ["--splits"]:
        _card()
        _one(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
             splits=True)
        return 0
    if not argv or argv[0].startswith("-"):
        print(__doc__, file=sys.stderr)
        return 2
    roots = [os.path.abspath(r) for r in argv]
    _card()
    _build(roots)
    for root in roots:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one",
                        root], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
