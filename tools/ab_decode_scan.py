#!/usr/bin/env python3
"""flash_decode's and ssm_scan's times in several checkouts, side by side on
one card.

    python3 tools/ab_decode_scan.py ROOT [ROOT ...]
    python3 tools/ab_decode_scan.py --splits

Each ROOT is a tree that holds ``chip_smoke.py`` and ``src/repro_torch``
(this checkout, or another commit unpacked with ``git archive``). The
``flash_decode`` and ``ssm_scan`` libraries of every ROOT are built first,
one ``nvcc`` each, all at once. Then each ROOT in the order given runs in a
process of its own, on the same seeded inputs:

- ``flash_decode`` at musicgen_medium's decode step (q 8x24x1x64 bf16,
  caches 8x24x576x64, kv_len 576 as an int), cycling 8 layers' caches
  (226 MB, past the 50 MB L2) as a step does;
- ``ssm_scan_fwd`` at falcon_mamba_7b's forward (x 1x2048x8192 bf16, delta
  f32, B/C 1x2048x16 bf16) and at its prefill (4x512x8192).

It prints one JSON line per ROOT: ms per call from CUDA events around
back-to-back calls (``ms``, the call's clock), the sum of
``torch.profiler``'s device rows per call (``device_ms``, the kernels
alone) and each device row (``rows``: ms per call, launches per call,
kernel). Give the trees as A B B A to see the drift between runs.
``--splits`` times this checkout's ``flash_decode`` at the same inputs, and
at paligemma_3b's d = 256, g = 8 (q 8x8x1x256, caches 8x1x576x256, 24
layers), with the split length forced to each of 32, 64, 96, 128, 192, 256
and 512 slots in turn (the data behind ``decode_split``'s rule), its output held
against the plain version. Needs one card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

ITERS = 100
BATCH, CACHE = 8, 576                # musicgen: 8 prompts of 512, 64 new
MUSICGEN = (24, 24, 64, 8)           # h, hk, d, layers cycled
PALIGEMMA = (8, 1, 256, 24)
SCANS = {"ssm_scan@forward": (1, 2048), "ssm_scan@prefill": (4, 512)}
D_INNER, STATE = 8192, 16            # falcon_mamba_7b


def _build(roots):
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from repro_torch.kernels import _build; "
            "_build.build_all(('flash_decode', 'ssm_scan'))")
    procs = [subprocess.Popen([sys.executable, "-c", code,
                               os.path.join(r, "src")])
             for r in dict.fromkeys(roots)]
    for p in procs:
        if p.wait() != 0:
            raise SystemExit(f"ab_decode_scan: build failed ({p.args[-1]})")


def _time(fn, iters=ITERS):
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


def _decode(dev, shape, seed):
    """q and the cycled caches of one decode shape, and a call of the
    tree's flash_decode over them."""
    import torch

    from repro_torch.kernels.flash_attention import flash_decode

    h, hk, d, nl = shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    bf = torch.bfloat16
    q = torch.randn((BATCH, h, 1, d), generator=gen, device=dev).to(bf)
    kv = [(torch.randn((BATCH, hk, CACHE, d), generator=gen,
                       device=dev).to(bf),
           torch.randn((BATCH, hk, CACHE, d), generator=gen,
                       device=dev).to(bf)) for _ in range(nl)]
    it = iter(range(1 << 30))

    def call():
        k, v = kv[next(it) % nl]
        return flash_decode(q, k, v, kv_len=CACHE)

    return q, kv, call


def _scan_args(dev, bt, L, seed):
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    bf = torch.bfloat16
    x = torch.randn((bt, L, D_INNER), generator=gen, device=dev).to(bf)
    delta = torch.nn.functional.softplus(
        torch.randn((bt, L, D_INNER), generator=gen, device=dev) - 4)
    A = -torch.arange(1, STATE + 1, dtype=torch.float32,
                      device=dev).expand(D_INNER, STATE).contiguous()
    B = torch.randn((bt, L, STATE), generator=gen, device=dev).to(bf)
    C = torch.randn((bt, L, STATE), generator=gen, device=dev).to(bf)
    return x, delta, A, B, C, torch.ones(D_INNER, device=dev)


def _one(root):
    sys.path[:0] = [root, os.path.join(root, "src")]
    import torch

    from repro_torch.kernels.ssm_scan import ssm_scan_fwd

    dev = torch.device("cuda")
    out = {"root": root}
    with torch.no_grad():
        out["flash_decode"] = _time(_decode(dev, MUSICGEN, 3)[2])
        for name, (bt, L) in SCANS.items():
            args = _scan_args(dev, bt, L, 4)
            out[name] = _time(lambda: ssm_scan_fwd(*args), iters=20)
            del args
    print(json.dumps(out), flush=True)


def _splits(root):
    sys.path[:0] = [root, os.path.join(root, "src")]
    import torch

    from repro_torch.kernels.flash_attention import decode_ref, ops

    dev = torch.device("cuda")
    rule = ops.decode_split
    try:
        for tag, shape in (("musicgen", MUSICGEN), ("paligemma d256",
                                                    PALIGEMMA)):
            q, kv, call = _decode(dev, shape, 5)
            ref = decode_ref(q, *kv[0], kv_len=CACHE).float()
            want = rule(BATCH, shape[1], CACHE)[0]
            for split in (32, 64, 96, 128, 192, 256, 512):
                ops.decode_split = (lambda b, hk, skv, s=split:
                                    (s, -(-skv // s)))
                o = ops.flash_decode(q, *kv[0], kv_len=CACHE)
                err = float((o.float() - ref).abs().max())
                if not err < 2e-2:
                    raise SystemExit(f"ab_decode_scan: {tag} split {split}: "
                                     f"max |err| {err} against the plain "
                                     "version")
                print(json.dumps(dict(shape=tag, split=split, rule=want,
                                      max_abs_err=err, **_time(call))),
                      flush=True)
            del q, kv
    finally:
        ops.decode_split = rule


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
    if argv == ["--splits"]:
        _card()
        _build([here])
        _splits(here)
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
