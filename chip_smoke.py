#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
GPU: builds the port's eight hand-written Hopper kernels from ``src/``,
holds each against its plain PyTorch version, serves ``llama3_2_1b``
through the continuous-batching engine, trains it through ``TrainLoop``,
and times each kernel.

  python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

1. build: one nvcc per CUDA source, all in parallel, plus the Triton
   rmsnorm and flash-delta kernels;
2. kernels vs plain versions on the card: f32 at small shapes (tolerance
   1e-4), bf16 at the main paths' full-width shapes (tolerances stated
   beside each check);
3. llama3_2_1b at full width with 2 layers in f32, one set of weights on
   the card (kernels) and on the CPU (plain versions): prefill logits and
   the first 8 greedy tokens must agree; the training loss and every
   parameter's gradient must agree;
4. the serving path: the full 16-layer bf16 llama3_2_1b through ``Engine``
   (8 slots, max_len 2048, page 512, 16 requests of 33-1000 prompt tokens
   and 32-64 new tokens). Launch counts are zeroed just before and read just
   after; every serving kernel must have launched, every request complete,
   every logit be finite;
5. where the serving time goes: eight decode steps of a full engine on the
   host clock and under ``torch.profiler`` (device busy share, top device
   ops), and one admission prefill;
6. the training path: the full 16-layer bf16 llama3_2_1b through
   ``TrainLoop`` (global batch 4, seq_len 1024, 6 steps, a checkpoint every
   3 steps). Launch counts are zeroed just before and read just after;
   every training kernel (and rmsnorm, flash_fwd) must have launched, every
   loss be finite, and the latest checkpoint must restore bit-equal to the
   parameters and optimizer state saved;
7. where the training time goes: one train step on the host clock and
   under ``torch.profiler``;
8. per-kernel times at the main paths' shapes beside their bound, the
   plain version's time and one library call's time.

The last three lines of standard output are the card's name and power
limit, a JSON object with one entry per kernel, and the result line.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, bf16 tensor-core
# FLOP/s, f32 FLOP/s outside the tensor cores
HBM_BPS = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

KERNEL_INFO = {
    "rmsnorm": ("triton", "src/repro_torch/kernels/rmsnorm/kernel.py",
                "src/repro/kernels/rmsnorm/kernel.py:21"),
    "flash_fwd": ("cuda", "src/repro_torch/csrc/flash_fwd.cu",
                  "src/repro/kernels/flash_attention/kernel.py:51"),
    "paged_decode": ("cuda", "src/repro_torch/csrc/paged_decode.cu",
                     "src/repro/kernels/flash_attention/kernel.py:457"),
    "lm_head": ("cuda", "src/repro_torch/csrc/lm_head.cu",
                "src/repro/kernels/lm_head/kernel.py:64"),
    "lm_head_ce": ("cuda", "src/repro_torch/csrc/lm_head_ce.cu",
                   "src/repro/kernels/lm_head/kernel.py:64"),
    "lm_head_bwd": ("cuda", "src/repro_torch/csrc/lm_head_ce.cu",
                    "src/repro/kernels/lm_head/kernel.py:185"),
    "flash_delta": ("triton",
                    "src/repro_torch/kernels/flash_attention/delta.py",
                    "src/repro/kernels/flash_attention/kernel.py:180"),
    "flash_bwd": ("cuda", "src/repro_torch/csrc/flash_bwd.cu",
                  "src/repro/kernels/flash_attention/kernel.py:210"),
}
SERVE_KERNELS = ("rmsnorm", "flash_fwd", "paged_decode", "lm_head")
TRAIN_KERNELS = ("lm_head_ce", "lm_head_bwd", "flash_delta", "flash_bwd")
# the training main path: llama3_2_1b at global batch 4 x seq_len 1024
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 1024, 6


def log(msg):
    print(msg, flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check_close(name, got, ref, *, atol, rtol):
    import torch

    got, ref = got.float(), ref.float()
    if got.shape != ref.shape:
        fail(f"{name}: shape {tuple(got.shape)} != {tuple(ref.shape)}")
    if not torch.isfinite(got).all():
        fail(f"{name}: non-finite values")
    err = (got - ref).abs()
    bad = err > atol + rtol * ref.abs()
    worst = float(err.max()) if err.numel() else 0.0
    if bad.any():
        fail(f"{name}: {int(bad.sum())} of {err.numel()} elements outside "
             f"atol={atol} rtol={rtol} (max |err| {worst:.3e})")
    log(f"[check] {name}: max|err| {worst:.3e} (atol {atol}, rtol {rtol})")
    return worst


def check_rel(name, got, ref, rel):
    """check_close with atol = rel * max|ref| and rtol = rel: for outputs
    whose error is a sum-order effect that scales with their magnitude."""
    scale = float(ref.float().abs().max())
    return check_close(name, got, ref, atol=rel * scale, rtol=rel)


def check_argmax(name, arg, logits_ref, vocab, gap_tol):
    """The kernel's argmax must equal the plain one wherever the plain
    top-2 gap exceeds ``gap_tol`` (closer rows may flip on sum order)."""
    import torch

    live = logits_ref[:, :vocab].float()
    top2 = torch.topk(live, 2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > gap_tol
    ref_arg = torch.argmax(live, dim=-1)
    wrong = decided & (arg.reshape(-1).long() != ref_arg)
    if wrong.any():
        fail(f"{name}: argmax differs on {int(wrong.sum())} decided rows")
    log(f"[check] {name}: argmax agrees on {int(decided.sum())}/"
        f"{decided.numel()} rows with top-2 gap > {gap_tol}")


# ---------------------------------------------------------------------------
# phase 2a: f32, small shapes, edge cases, tolerance 1e-4
# ---------------------------------------------------------------------------

def small_f32_checks(dev):
    import torch

    from repro_torch.kernels.flash_attention import (flash_attention_fwd,
                                                     flash_fwd_ref,
                                                     paged_decode_attention,
                                                     paged_decode_ref)
    from repro_torch.kernels.lm_head import lm_head_logits, lm_head_logits_ref
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_ref

    tol = dict(atol=1e-4, rtol=1e-4)
    g = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev)

    x, w = rnd(7, 3, 128), rnd(128)
    check_close("rmsnorm f32 (7,3,128)", rmsnorm(x, w, eps=1e-5),
                rmsnorm_ref(x, w, eps=1e-5), **tol)

    for sq, skv, h, hk, d in ((5, 5, 4, 2, 32), (9, 9, 4, 1, 64),
                              (3, 3, 4, 4, 32), (7, 7, 8, 2, 64),
                              (70, 70, 4, 2, 64), (4, 11, 4, 2, 32),
                              (130, 200, 8, 2, 64)):
        # q as a transposed view (B, S, H, D) -> (B, H, S, D): strided input
        q = rnd(2, sq, h, d).transpose(1, 2)
        k, v = rnd(2, hk, skv, d), rnd(2, hk, skv, d)
        for causal in (True, False):
            o, lse = flash_attention_fwd(q, k, v, causal=causal)
            ro, rlse = flash_fwd_ref(q, k, v, causal=causal)
            tag = f"flash f32 sq={sq} skv={skv} h={h}/{hk} d={d} c={causal}"
            check_close(tag + " o", o, ro, **tol)
            check_close(tag + " lse", lse, rlse, **tol)

    for gq, page in ((1, 4), (2, 8), (4, 5), (4, 352)):
        b, hk, d, nsp = 3, 2, 64, 4
        npages = b * nsp + 1
        q = rnd(b, hk * gq, 1, d)
        kp, vp = rnd(npages, hk, page, d), rnd(npages, hk, page, d)
        perm = torch.randperm(npages - 1, generator=torch.Generator()
                              .manual_seed(page)) + 1
        table = perm[:b * nsp].reshape(b, nsp).to(torch.int32)
        table[2] = 0                                    # idle slot
        kv_len = torch.tensor([3 * page + 2, max(page - 1, 1), 1],
                              dtype=torch.int32)
        pos = torch.full((npages, page), -1, dtype=torch.int32)
        for bi in range(2):
            for j in range(nsp):
                p = torch.arange(j * page, (j + 1) * page, dtype=torch.int32)
                pos[table[bi, j]] = torch.where(p < kv_len[bi], p, -1)
        table, kv_len, pos = table.to(dev), kv_len.to(dev), pos.to(dev)
        o = paged_decode_attention(q, kp, vp, block_table=table,
                                   kv_len=kv_len, pos_pages=pos)
        ro = paged_decode_ref(q, kp, vp, block_table=table, kv_len=kv_len,
                              pos_pages=pos)
        check_close(f"paged f32 g={gq} page={page}", o, ro, **tol)
        if not (o[2] == 0).all():
            fail("paged decode: the idle slot must yield exactly 0")

    # exact ties within one 64-column block (9, 12) and across blocks (130)
    x, emb = rnd(5, 64).abs(), rnd(300, 64)
    emb[9] = emb[12] = emb[130] = 3.0
    for vocab in (300, 250):
        lg, m, arg = lm_head_logits.raw(x, emb.T, vocab=vocab)
        rlg, rm, rarg = lm_head_logits_ref(x, emb.T, vocab=vocab)
        check_close(f"lm_head f32 logits vocab={vocab}", lg, rlg, **tol)
        check_close(f"lm_head f32 max vocab={vocab}", m, rm, **tol)
        if not torch.equal(arg, rarg) or not (arg == 9).all():
            fail(f"lm_head: first-occurrence argmax {arg.flatten().tolist()}"
                 f" != {rarg.flatten().tolist()}")
    w = rnd(64, 300)                                    # contiguous (d, V)
    lg, m, arg = lm_head_logits.raw(x, w, vocab=299)
    rlg, rm, rarg = lm_head_logits_ref(x, w, vocab=299)
    check_close("lm_head f32 contiguous w", lg, rlg, **tol)
    if not torch.equal(arg, rarg):
        fail("lm_head: argmax differs (contiguous w)")
    x20 = rnd(20, 64)                                   # R > 16: row passes
    check_close("lm_head f32 R=20", lm_head_logits(x20, w, vocab=299),
                lm_head_logits_ref(x20, w, vocab=299)[0], **tol)
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# the main path's shapes
# ---------------------------------------------------------------------------

def traffic(seed, n, vocab):
    import numpy as np

    rng = np.random.RandomState(seed)
    plens = rng.randint(33, 1001, n)
    plens[0] = 1000                                     # the longest prompt
    news = rng.randint(32, 65, n)
    return [(rng.randint(1, vocab, p).tolist(), int(m))
            for p, m in zip(plens, news)]


def paged_state(dev, cfg, lens, page, num_pages, nlayers, dtype, gen):
    """KV pools of ``nlayers`` layers and a block table holding sequences of
    ``lens`` tokens on shuffled pages, as the engine lays them out."""
    import torch

    hk, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    b = len(lens)
    nsp = -(-2048 // page)
    pools = [(torch.randn((num_pages, hk, page, hd), generator=gen,
                          device=dev).to(dtype),
              torch.randn((num_pages, hk, page, hd), generator=gen,
                          device=dev).to(dtype)) for _ in range(nlayers)]
    perm = (torch.randperm(num_pages - 1, generator=torch.Generator()
                           .manual_seed(1)) + 1).tolist()
    table = torch.zeros((b, nsp), dtype=torch.int32)
    pos = torch.full((num_pages, page), -1, dtype=torch.int32)
    for i, n in enumerate(lens):
        for j in range(-(-n // page)):
            p = perm.pop()
            table[i, j] = p
            ar = torch.arange(j * page, (j + 1) * page, dtype=torch.int32)
            pos[p] = torch.where(ar < n, ar, -1)
    kv_len = torch.tensor(lens, dtype=torch.int32)
    return pools, table.to(dev), kv_len.to(dev), pos.to(dev)


def full_width_bf16_checks(dev, cfg, params, sq, lens, page, num_pages):
    """Each kernel against its plain version at the main path's shapes, in
    bf16: a prefill of ``sq`` tokens, a decode step over slots holding
    ``lens`` tokens. Returns {kernel: max |err|}."""
    import torch

    from repro_torch.kernels.flash_attention import (flash_attention_fwd,
                                                     flash_fwd_ref,
                                                     paged_decode_attention,
                                                     paged_decode_ref)
    from repro_torch.kernels.lm_head import lm_head_logits, lm_head_logits_ref
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_ref

    bf = torch.bfloat16
    d, h, hk, hd = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                    cfg.resolved_head_dim)
    gen = torch.Generator(device=dev).manual_seed(2)
    errs = {}

    # rmsnorm: both sides round one f32 result to bf16, so they may differ
    # by one bf16 ulp (2^-8 relative): rtol 2^-7
    w = 1 + 0.1 * torch.randn(d, generator=gen, device=dev)
    errs["rmsnorm"] = 0.0
    for rows in (8, 1000):
        x = torch.randn((rows, 1, d), generator=gen, device=dev).to(bf)
        errs["rmsnorm"] = max(errs["rmsnorm"], check_close(
            f"rmsnorm bf16 ({rows},1,{d})", rmsnorm(x, w, eps=cfg.norm_eps),
            rmsnorm_ref(x, w, eps=cfg.norm_eps), atol=1e-6, rtol=2 ** -7))

    # attention: the plain version rounds p to bf16 before p@v (2^-9
    # relative per term), the kernels keep p in f32, and both round the
    # output to bf16: 2e-2 absolute + relative covers both at |o| <~ 4
    q = torch.randn((1, sq, h, hd), generator=gen, device=dev).to(bf)
    q = q.transpose(1, 2)                  # the projection's strided view
    k = torch.randn((1, hk, sq, hd), generator=gen, device=dev).to(bf)
    v = torch.randn((1, hk, sq, hd), generator=gen, device=dev).to(bf)
    o, lse = flash_attention_fwd(q, k, v, causal=True)
    ro, rlse = flash_fwd_ref(q, k, v, causal=True)
    errs["flash_fwd"] = check_close(f"flash bf16 sq={sq} h={h}/{hk}", o, ro,
                                    atol=2e-2, rtol=2e-2)
    check_close("flash bf16 lse", lse, rlse, atol=1e-3, rtol=1e-4)

    pools, table, kv_len, pos = paged_state(dev, cfg, lens, page, num_pages,
                                            1, bf, gen)
    qd = torch.randn((len(lens), h, 1, hd), generator=gen,
                     device=dev).to(bf)
    o = paged_decode_attention(qd, *pools[0], block_table=table,
                               kv_len=kv_len, pos_pages=pos)
    ro = paged_decode_ref(qd, *pools[0], block_table=table, kv_len=kv_len,
                          pos_pages=pos)
    errs["paged_decode"] = check_close(
        f"paged bf16 b={len(lens)} page={page} lens={lens}", o, ro,
        atol=2e-2, rtol=2e-2)

    # LM head: bf16 products are exact in f32; the two sum d=2048 of them
    # in different orders: |err| <= d * 2^-24 * sum|x w| ~ 4e-3 at these
    # magnitudes
    x = rmsnorm_ref(torch.randn((len(lens), d), generator=gen, device=dev),
                    torch.ones(d, device=dev), eps=cfg.norm_eps).to(bf)
    head = params["embed"].T
    lg, m, arg = lm_head_logits.raw(x, head, vocab=cfg.vocab_size)
    rlg, rm, rarg = lm_head_logits_ref(x, head, vocab=cfg.vocab_size)
    errs["lm_head"] = check_close(
        f"lm_head bf16 ({len(lens)},{d})x({d},{head.shape[1]})", lg, rlg,
        atol=4e-3, rtol=0)
    check_close("lm_head bf16 row max", m, rm, atol=4e-3, rtol=0)
    check_argmax("lm_head bf16", arg, rlg, cfg.vocab_size, gap_tol=8e-3)
    torch.cuda.synchronize()
    return errs


# ---------------------------------------------------------------------------
# phase 3: 2 layers, full width, f32: card vs CPU
# ---------------------------------------------------------------------------

def two_layer_f32_check(cfg):
    import torch

    from repro_torch.models import LM, tree_to
    from repro_torch.serving import Engine

    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    cpu = LM(cfg2, device="cpu")
    gpu = LM(cfg2)
    t0 = time.perf_counter()
    p_cpu = cpu.init(torch.Generator().manual_seed(11))
    p_gpu = tree_to(p_cpu, gpu.device)
    log(f"[2-layer f32] weights on the CPU: {time.perf_counter() - t0:.1f}s")
    reqs = traffic(5, 2, cfg.vocab_size)
    reqs = [(p[:40], 8) for p, _ in reqs]
    toks = torch.tensor([reqs[0][0]])
    lc, _ = cpu.prefill(p_cpu, toks)
    lg, _ = gpu.prefill(p_gpu, toks.to(gpu.device))
    check_close("2-layer f32 prefill logits, card vs CPU", lg.cpu(), lc,
                atol=1e-3, rtol=1e-3)
    outs = []
    for model, params in ((cpu, p_cpu), (gpu, p_gpu)):
        eng = Engine(model, params, batch=2, max_len=64, page_size=16)
        rids = [eng.submit(p, m) for p, m in reqs]
        res = eng.drain()
        outs.append([res[r] for r in rids])
    if outs[0] != outs[1]:
        fail(f"2-layer f32 greedy tokens: CPU {outs[0]} != card {outs[1]}")
    log(f"[2-layer f32] first 8 greedy tokens agree, card == CPU: {outs[1]}")


# ---------------------------------------------------------------------------
# phase 4: the serving path
# ---------------------------------------------------------------------------

def serve_main_path(cfg, model, params, reqs):
    """Drive the engine once; returns (launch counts, stats)."""
    import torch

    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.serving import Engine

    eng = Engine(model, params, batch=8, max_len=2048)
    if eng.page_size != 512:
        fail(f"engine page size {eng.page_size} != 512")
    bad = torch.zeros((), dtype=torch.int64, device=model.device)
    calls = {"prefill": 0, "decode": 0}
    prefill, step = model.prefill, model.paged_greedy_step

    def checked_prefill(p, t, max_len=None):
        logits, cache = prefill(p, t, max_len)
        bad.add_((~torch.isfinite(logits)).sum())
        calls["prefill"] += 1
        return logits, cache

    def checked_step(p, t, c):
        nxt, logits, c = step(p, t, c)
        bad.add_((~torch.isfinite(logits)).sum())
        calls["decode"] += 1
        return nxt, logits, c

    model.prefill, model.paged_greedy_step = checked_prefill, checked_step
    try:
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        rids = [eng.submit(p, m) for p, m in reqs]
        res = eng.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
    finally:
        del model.prefill, model.paged_greedy_step
    for rid, (p, m) in zip(rids, reqs):
        toks = res[rid]
        if len(toks) != m or not all(0 <= t < cfg.vocab_size for t in toks):
            fail(f"request {rid}: {len(toks)} tokens of {m}, or out of vocab")
    if int(bad) != 0:
        fail(f"{int(bad)} non-finite logits on the main path")
    for name in SERVE_KERNELS:
        if counts[name] <= 0:
            fail(f"kernel {name} never launched on the serving path")
    ntok = sum(len(res[r]) for r in rids)
    stats = dict(wall_s=wall, tokens=ntok, tok_s=ntok / wall,
                 prefill_calls=calls["prefill"],
                 decode_steps=calls["decode"],
                 preempted=sum(r.preempted for r in eng._requests.values()))
    return counts, stats


def device_rows(prof, nsteps):
    """(device ms per step, calls per step, name) of a profile's
    device-side events (kernels, copies), largest first: a CPU op's row
    carries its child kernels' device time too and would count it twice."""
    from torch.autograd import DeviceType

    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = e.self_cuda_time_total
        if dev_us > 0:
            rows.append((dev_us / 1e3 / nsteps, e.count // nsteps, e.key))
    return sorted(rows, reverse=True)


def profile_decode(model, params, reqs, nsteps=8):
    """Where the time of the main path goes: a fresh engine fills its 8
    slots (no slot retires inside the window), then ``nsteps`` decode steps
    run once on the host clock and once under ``torch.profiler``; also the
    host time of one B=1 prefill of the longest prompt."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving import Engine

    eng = Engine(model, params, batch=8, max_len=2048)
    for p, _ in reqs[:8]:
        eng.submit(p, 64)
    for _ in range(3):                         # admissions, then warm steps
        eng.step()

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(nsteps):
            eng.step()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / nsteps

    step_ms = run()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prof_step_ms = run()
    rows = device_rows(prof, nsteps)
    busy_ms = sum(r[0] for r in rows)
    log(f"[profile] decode step (8 slots, 16 layers): host {step_ms:.3f} "
        f"ms/step ({prof_step_ms:.3f} under the profiler); device busy "
        f"{busy_ms:.3f} ms/step = {100 * busy_ms / step_ms:.1f}% of the "
        f"unprofiled step, idle {100 * (1 - busy_ms / step_ms):.1f}%")
    for ms, n, key in rows[:12]:
        log(f"[profile]   {ms:8.4f} ms/step  {n:4d} calls/step  {key[:90]}")

    toks = torch.tensor([max((p for p, _ in reqs), key=len)],
                        device=model.device)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.prefill(params, toks)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    log(f"[profile] B=1 prefill of {toks.shape[1]} tokens: host "
        f"{min(times):.3f} ms (best of 3)")


# ---------------------------------------------------------------------------
# phase 5: times
# ---------------------------------------------------------------------------

def cuda_ms(fn, iters=30, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(iters):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / iters


def bound(bytes_, flops, dtype):
    tb, tf = bytes_ / HBM_BPS, flops / PEAK_FLOPS[dtype]
    return (max(tb, tf) * 1e3, "bytes" if tb >= tf else "operations")


def time_kernels(dev, cfg, params, sq, lens, page, num_pages):
    """{kernel: dict(ms, plain_ms, bound_ms, bound_by, library_ms)} at the
    main path's shapes: a decode step of len(lens) slots for rmsnorm, paged
    decode and the LM head; the longest admission prefill for flash."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (flash_attention_fwd,
                                                     flash_fwd_ref,
                                                     paged_decode_attention,
                                                     paged_decode_ref)
    from repro_torch.kernels.lm_head import lm_head_logits, lm_head_logits_ref
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_ref

    bf = torch.bfloat16
    d, h, hk, hd = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                    cfg.resolved_head_dim)
    b = len(lens)
    gen = torch.Generator(device=dev).manual_seed(3)
    out = {}

    x = torch.randn((b, 1, d), generator=gen, device=dev).to(bf)
    w = torch.ones(d, device=dev)
    wb = w.to(bf)
    eps = cfg.norm_eps
    out["rmsnorm"] = dict(
        ms=cuda_ms(lambda: rmsnorm(x, w, eps=eps), iters=200),
        plain_ms=cuda_ms(lambda: rmsnorm_ref(x, w, eps=eps), iters=200),
        library_ms=cuda_ms(lambda: F.rms_norm(x, (d,), wb, eps), iters=200),
        library="F.rms_norm (bf16 weight)",
        shape=f"x ({b},1,{d}) bf16, w f32")
    out["rmsnorm"].update(zip(("bound_ms", "bound_by"), bound(
        2 * b * d * 2 + d * 4, 4 * b * d, "bfloat16")))

    q = torch.randn((1, sq, h, hd), generator=gen, device=dev).to(bf)
    q = q.transpose(1, 2)
    k = torch.randn((1, hk, sq, hd), generator=gen, device=dev).to(bf)
    v = torch.randn((1, hk, sq, hd), generator=gen, device=dev).to(bf)
    qc = q.contiguous()
    pairs = sq * (sq + 1) // 2
    out["flash_fwd"] = dict(
        ms=cuda_ms(lambda: flash_attention_fwd(q, k, v, causal=True)),
        plain_ms=cuda_ms(lambda: flash_fwd_ref(q, k, v, causal=True),
                         iters=10),
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            qc, k, v, is_causal=True, enable_gqa=True)),
        library="F.scaled_dot_product_attention(is_causal, enable_gqa)",
        shape=f"q (1,{h},{sq},{hd}), k/v (1,{hk},{sq},{hd}) bf16, causal")
    out["flash_fwd"].update(zip(("bound_ms", "bound_by"), bound(
        2 * (2 * h + 2 * hk) * sq * hd + 4 * h * sq,
        4 * h * hd * pairs, "bfloat16")))

    nl = cfg.n_layers          # cycle the layers' pools, as a step does
    pools, table, kv_len, pos = paged_state(dev, cfg, lens, page, num_pages,
                                            nl, bf, gen)
    qd = torch.randn((b, h, 1, hd), generator=gen, device=dev).to(bf)
    it = iter(range(1 << 30))

    def kernel():
        kp, vp = pools[next(it) % nl]
        return paged_decode_attention(qd, kp, vp, block_table=table,
                                      kv_len=kv_len, pos_pages=pos)

    def plain():
        kp, vp = pools[next(it) % nl]
        return paged_decode_ref(qd, kp, vp, block_table=table,
                                kv_len=kv_len, pos_pages=pos)

    tab = table.long()
    m = tab.shape[1] * page
    mask = ((pos.long()[tab].reshape(b, m) >= 0)
            & (pos.long()[tab].reshape(b, m) < kv_len[:, None]))[:, None, None]

    def library():
        kp, vp = pools[next(it) % nl]
        kb = kp[tab].transpose(1, 2).reshape(b, hk, m, hd)
        vb = vp[tab].transpose(1, 2).reshape(b, hk, m, hd)
        return F.scaled_dot_product_attention(qd, kb, vb, attn_mask=mask,
                                              enable_gqa=True)

    ntok = sum(lens)
    pages_read = sum(-(-n // page) for n in lens)
    out["paged_decode"] = dict(
        ms=cuda_ms(kernel, iters=64), plain_ms=cuda_ms(plain, iters=16),
        library_ms=cuda_ms(library, iters=16),
        library="gather pages + F.scaled_dot_product_attention(attn_mask)",
        shape=f"q ({b},{h},1,{hd}) bf16, pools ({num_pages},{hk},{page},"
              f"{hd}), kv_len {lens}")
    out["paged_decode"].update(zip(("bound_ms", "bound_by"), bound(
        2 * ntok * hk * hd * 2 + 2 * 2 * b * h * hd + pages_read * page * 4
        + table.numel() * 4 + b * 4, 4 * h * hd * ntok, "bfloat16")))

    xh = torch.randn((b, d), generator=gen, device=dev).to(bf)
    head = params["embed"].T
    V = head.shape[1]
    vocab = cfg.vocab_size

    def library_head():
        lg = torch.matmul(xh, head)
        return lg[:, :vocab].max(dim=-1)

    out["lm_head"] = dict(
        ms=cuda_ms(lambda: lm_head_logits.raw(xh, head, vocab=vocab)),
        plain_ms=cuda_ms(lambda: lm_head_logits_ref(xh, head, vocab=vocab),
                         iters=10),
        library_ms=cuda_ms(library_head),
        library="torch.matmul (bf16 out) + max/argmax",
        shape=f"x ({b},{d}) @ embed.T ({d},{V}) bf16")
    out["lm_head"].update(zip(("bound_ms", "bound_by"), bound(
        d * V * 2 + b * d * 2 + b * V * 4 + b * 8, 2 * b * d * V,
        "bfloat16")))
    return out


# ---------------------------------------------------------------------------
# training: phases 2a/2b/3 for the training kernels, 6, 7 and 8
# ---------------------------------------------------------------------------

def small_f32_train_checks(dev):
    """The training kernels against their plain versions in f32 at small
    shapes, tolerance 1e-4: ragged rows and depth, padded vocab, tied and
    contiguous heads; ragged lengths, GQA groups of 1-4, strided q/do and
    rows that see no key (sq > skv, causal)."""
    import torch

    from repro_torch.kernels.flash_attention import (flash_bwd, flash_bwd_ref,
                                                     flash_delta,
                                                     flash_delta_ref,
                                                     flash_fwd_ref)
    from repro_torch.kernels.lm_head import (lm_head_bwd, lm_head_bwd_ref,
                                             lm_head_ce, lm_head_ce_stats_ref)

    tol = dict(atol=1e-4, rtol=1e-4)
    g = torch.Generator(device=dev).manual_seed(4)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev)

    for R, V, vocab, tied in ((5, 96, 70, True), (70, 200, 200, False),
                              (130, 1100, 1000, True), (1, 64, 1, False)):
        d = 48
        x = rnd(R, d)
        w = rnd(V, d).T if tied else rnd(d, V)
        lab = torch.randint(0, vocab, (R, 1), dtype=torch.int32,
                            generator=torch.Generator().manual_seed(R))
        lab = lab.to(dev)
        tag = f"CE f32 R={R} V={V} vocab={vocab} tied={tied}"
        lse, gold = lm_head_ce.raw(x, w, lab, vocab=vocab)
        rlse, rgold = lm_head_ce_stats_ref(x, w, lab, vocab=vocab)
        check_close(tag + " lse", lse, rlse, **tol)
        check_close(tag + " gold", gold, rgold, **tol)
        gr = rnd(R, 1)
        dx, dw = lm_head_bwd(x, w, lab, lse, gr, vocab=vocab)
        rdx, rdw = lm_head_bwd_ref(x, w, lab, lse, gr, vocab=vocab)
        check_close(tag + " dx", dx, rdx, **tol)
        check_close(tag + " dw", dw, rdw, **tol)

    for sq, skv, grp, d in ((5, 5, 1, 32), (9, 9, 4, 64), (70, 70, 2, 64),
                            (4, 11, 4, 32), (130, 200, 4, 64),
                            (7, 4, 2, 32)):
        b, hk = 2, 2
        h = hk * grp
        q = rnd(b, sq, h, d).transpose(1, 2)
        k, v = rnd(b, hk, skv, d), rnd(b, hk, skv, d)
        do = rnd(b, sq, h, d).transpose(1, 2)
        for causal in (True, False):
            tag = f"flash bwd f32 sq={sq} skv={skv} g={grp} d={d} c={causal}"
            o, lse = flash_fwd_ref(q, k, v, causal=causal)
            delta = flash_delta(do, o)
            check_close(tag + " delta", delta, flash_delta_ref(do, o), **tol)
            got = flash_bwd(q, k, v, do, lse, delta, causal=causal)
            want = flash_bwd_ref(q, k, v, do, lse, delta, causal=causal)
            for name, a, b_ in zip(("dq", "dk", "dv"), got, want):
                check_close(f"{tag} {name}", a, b_, **tol)
            if causal and sq > skv and not (got[0][:, :, :sq - skv] == 0).all():
                fail("flash bwd: rows that see no key must give dq = 0")
    torch.cuda.synchronize()


def _train_inputs(dev, cfg, embed, gen):
    """The training kernels' inputs at the main path's shapes, in bf16:
    the CE head's rows (R = B * (S - 1) normalized hidden states), the tied
    head embed.T and labels; attention q/k/v/do as the projections'
    transposed views."""
    import torch

    from repro_torch.kernels.rmsnorm import rmsnorm_ref

    bf = torch.bfloat16
    b, s = TRAIN_BATCH, TRAIN_SEQ
    d, h, hk, hd = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                    cfg.resolved_head_dim)
    R = b * (s - 1)
    x = rmsnorm_ref(torch.randn((R, d), generator=gen, device=dev),
                    torch.ones(d, device=dev), eps=cfg.norm_eps).to(bf)
    lab = torch.randint(0, cfg.vocab_size, (R, 1), generator=gen,
                        device=dev, dtype=torch.int32)
    gr = torch.full((R, 1), 1.0 / R, device=dev)      # d(mean NLL)/d(nll)

    def proj(heads, scale=1.0):
        t = torch.randn((b, s, heads, hd), generator=gen, device=dev) * scale
        return t.to(bf).transpose(1, 2)

    return dict(x=x, w=embed.T, lab=lab, g=gr, q=proj(h), k=proj(hk),
                v=proj(hk), do=proj(h, 0.1))


def full_width_train_checks(dev, cfg, embed):
    """The training kernels against their plain versions at the main
    path's full-width shapes in bf16. Returns {kernel: max |err|}."""
    import torch

    from repro_torch.kernels.flash_attention import (flash_attention_fwd,
                                                     flash_bwd, flash_bwd_ref,
                                                     flash_delta,
                                                     flash_delta_ref)
    from repro_torch.kernels.lm_head import (lm_head_bwd, lm_head_bwd_ref,
                                             lm_head_ce, lm_head_ce_stats_ref)

    vocab = cfg.vocab_size
    t = _train_inputs(dev, cfg, embed, torch.Generator(device=dev)
                      .manual_seed(6))
    x, w, lab, gr = t["x"], t["w"], t["lab"], t["g"]
    errs = {}
    # CE: bf16 products are exact in f32; the kernel and the plain version
    # sum d = 2048 of them (|s| ~ 1) and then 128256 exponentials in other
    # orders: |err| of lse and gold well under 1e-3
    lse, gold = lm_head_ce.raw(x, w, lab, vocab=vocab)
    rlse, rgold = lm_head_ce_stats_ref(x, w, lab, vocab=vocab)
    errs["lm_head_ce"] = max(
        check_close(f"CE bf16 lse R={x.shape[0]} V={w.shape[1]}", lse, rlse,
                    atol=1e-3, rtol=0),
        check_close("CE bf16 gold", gold, rgold, atol=1e-3, rtol=0))
    # CE backward: f32 outputs that sum 128256 (dx) or 4092 (dw) terms in
    # another order: 1e-3 of the largest magnitude
    dx, dw = lm_head_bwd(x, w, lab, lse, gr, vocab=vocab)
    rdx, rdw = lm_head_bwd_ref(x, w, lab, lse, gr, vocab=vocab)
    errs["lm_head_bwd"] = max(check_rel("CE bwd bf16 dx", dx, rdx, 1e-3),
                              check_rel("CE bwd bf16 dw", dw, rdw, 1e-3))
    del dx, dw, rdx, rdw
    q, k, v, do = t["q"], t["k"], t["v"], t["do"]
    with torch.no_grad():
        o, lse = flash_attention_fwd(q, k, v, causal=True)
    # delta: 64 exact products summed in f32
    delta = flash_delta(do, o)
    errs["flash_delta"] = check_close(
        f"flash delta bf16 {tuple(do.shape)}", delta, flash_delta_ref(do, o),
        atol=1e-4, rtol=1e-4)
    # flash bwd: both compute in f32 from the same bf16 inputs; dq is
    # rounded to bf16 (one ulp, 2^-7 relative), dk/dv stay f32 (1e-3 of the
    # largest magnitude covers the sum order over 1024 queries x 4 heads)
    got = flash_bwd(q, k, v, do, lse, delta, causal=True)
    want = flash_bwd_ref(q, k, v, do, lse, delta, causal=True)
    errs["flash_bwd"] = max(
        check_rel("flash bwd bf16 dq", got[0], want[0], 2 ** -7),
        check_rel("flash bwd bf16 dk", got[1], want[1], 1e-3),
        check_rel("flash bwd bf16 dv", got[2], want[2], 1e-3))
    torch.cuda.synchronize()
    return errs


def two_layer_f32_train_check(cfg):
    """2 layers at full width in f32, the same weights and batch (B=2,
    S=128) on the card and on the CPU: the loss agrees within 1e-4 and
    every parameter's gradient within 1e-3 of its largest magnitude (f32
    with sums in other orders; the embedding gradient adds the lookup's
    scatter and the head's product)."""
    import torch

    from repro_torch.data import SyntheticLMData
    from repro_torch.models import LM, tree_to
    from repro_torch.tree import leaves, leaves_with_path

    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    cpu, gpu = LM(cfg2, device="cpu"), LM(cfg2)
    p_cpu = cpu.init(torch.Generator().manual_seed(12))
    p_gpu = tree_to(p_cpu, gpu.device)
    toks = torch.from_numpy(SyntheticLMData(
        vocab_size=cfg.vocab_size, seq_len=128, global_batch=2,
        seed=5).batch(0))
    out = []
    for model, params in ((cpu, p_cpu), (gpu, p_gpu)):
        for p in leaves(params):
            p.requires_grad_()
        t0 = time.perf_counter()
        loss, _ = model.loss(params, {"tokens": toks.to(model.device)})
        grads = torch.autograd.grad(loss, leaves(params))
        log(f"[2-layer f32 train] loss + grads on {model.device}: "
            f"{time.perf_counter() - t0:.1f}s")
        out.append((loss.detach(), grads))
    (lc, gc), (lg, gg) = out
    check_close("2-layer f32 loss, card vs CPU", lg.cpu(), lc, atol=1e-4,
                rtol=0)
    worst = 0.0
    for (key, _), a, b_ in zip(leaves_with_path(p_cpu), gc, gg):
        worst = max(worst, check_rel(f"2-layer f32 grad {key}", b_.cpu(), a,
                                     1e-3))
    return worst


def _ckpt_root():
    """The candidate directory with the most free disk: checkpoints of the
    full model with its optimizer state are ~12 GB each."""
    roots = [tempfile.gettempdir(), ROOT]
    free = {r: shutil.disk_usage(r).free for r in roots}
    best = max(roots, key=free.get)
    log(f"[train] checkpoint root {best}: {free[best] / 1e9:.1f} GB free")
    return best


def train_main_path(cfg):
    """Drive ``TrainLoop`` once on the full bf16 model (global batch 4,
    seq_len 1024, 6 steps, checkpoints every 3 steps). Returns (launch
    counts, stats, the loop's result)."""
    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.launch import train as train_mod
    from repro_torch.models import LM
    from repro_torch.tree import leaves, tree_map

    model = LM(cfg)
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_ckpt_", dir=_ckpt_root())
    loop = train_mod.TrainLoop(model=model, global_batch=TRAIN_BATCH,
                               seq_len=TRAIN_SEQ, steps=TRAIN_STEPS,
                               ckpt_dir=ckpt, ckpt_every=3, log_every=1)
    step_fn, step_ms = train_mod.train_step, []

    def timed_step(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = step_fn(*args)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        return res

    train_mod.train_step = timed_step
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        out = loop.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
    finally:
        train_mod.train_step = step_fn
    hist = out["history"]
    if len(hist) != TRAIN_STEPS or out["final_step"] != TRAIN_STEPS:
        fail(f"training ran {len(hist)} steps to {out['final_step']}")
    if not all(map(lambda v: v == v and abs(v) != float("inf"), hist)):
        fail(f"non-finite training loss: {hist}")
    for name in TRAIN_KERNELS + ("rmsnorm", "flash_fwd"):
        if counts[name] <= 0:
            fail(f"kernel {name} never launched on the training path")

    # the latest checkpoint (step 6) restores bit-equal into a fresh tree
    t0 = time.perf_counter()
    saved = (out["params"], out["opt"])
    template = tree_map(lambda t: torch.empty_like(t, device="meta"), saved)
    step, restored, _ = CheckpointManager(ckpt).restore(template,
                                                        device=model.device)
    if step != TRAIN_STEPS:
        fail(f"latest checkpoint is step {step}, not {TRAIN_STEPS}")
    for a, b_ in zip(leaves(restored), leaves(saved)):
        if a.dtype != b_.dtype or not torch.equal(a, b_.detach()):
            fail("checkpoint restore is not bit-equal to the saved state")
    restore_s = time.perf_counter() - t0
    del restored
    shutil.rmtree(ckpt, ignore_errors=True)
    steady = step_ms[1:]
    stats = dict(wall_s=wall, history=hist, step_ms=step_ms,
                 tok_s=TRAIN_BATCH * TRAIN_SEQ * len(steady) / (
                     sum(steady) / 1e3),
                 peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                 restore_s=restore_s)
    return model, counts, stats, out


def profile_train_step(model, params, opt_state):
    """Where a train step's time goes: two steps on the host clock, then one
    under ``torch.profiler`` (device-side events only)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data import SyntheticLMData
    from repro_torch.launch.train import train_step
    from repro_torch.optim import AdamW

    opt = AdamW()
    batch = {"tokens": torch.from_numpy(SyntheticLMData(
        vocab_size=model.cfg.vocab_size, seq_len=TRAIN_SEQ,
        global_batch=TRAIN_BATCH, seed=9).batch(0)).to(model.device)}

    def run(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            train_step(model, opt, params, opt_state, batch)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n

    run(1)                                     # warm
    step_ms = run(2)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prof_ms = run(1)
    rows = device_rows(prof, 1)
    busy_ms = sum(r[0] for r in rows)
    log(f"[profile train] step (B={TRAIN_BATCH}, S={TRAIN_SEQ}, "
        f"{model.cfg.n_layers} layers): "
        f"host {step_ms:.3f} ms ({prof_ms:.3f} under the profiler); device "
        f"busy {busy_ms:.3f} ms = {100 * busy_ms / step_ms:.1f}% of the "
        f"unprofiled step, idle {100 * (1 - busy_ms / step_ms):.1f}%")
    for ms, n, key in rows[:15]:
        log(f"[profile train]   {ms:9.3f} ms  {n:5d} calls  {key[:90]}")
    return step_ms, busy_ms


def time_train_kernels(dev, cfg, embed):
    """{kernel: dict(ms, plain_ms, bound_ms, bound_by, library_ms)} for the
    training kernels at the main path's shapes."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (flash_attention_fwd,
                                                     flash_bwd, flash_bwd_ref,
                                                     flash_delta,
                                                     flash_delta_ref)
    from repro_torch.kernels.lm_head import (lm_head_bwd, lm_head_bwd_ref,
                                             lm_head_ce, lm_head_ce_stats_ref)

    vocab = cfg.vocab_size
    t = _train_inputs(dev, cfg, embed, torch.Generator(device=dev)
                      .manual_seed(7))
    x, w, lab, gr = t["x"], t["w"], t["lab"], t["g"]
    R, d = x.shape
    V = w.shape[1]
    out = {}
    ce_flops = 2 * R * d * V

    def library_ce():
        logits = torch.matmul(x, w).float()[:, :vocab]
        return (torch.logsumexp(logits, -1)
                - logits.gather(1, lab.long())[:, 0])

    out["lm_head_ce"] = dict(
        ms=cuda_ms(lambda: lm_head_ce.raw(x, w, lab, vocab=vocab), 3, 1),
        plain_ms=cuda_ms(lambda: lm_head_ce_stats_ref(x, w, lab, vocab=vocab),
                         3, 1),
        library_ms=cuda_ms(library_ce, 3, 1),
        library="torch.matmul (bf16) + logsumexp - gather",
        shape=f"x ({R},{d}) @ embed.T ({d},{V}) bf16, labels ({R},1)")
    out["lm_head_ce"].update(zip(("bound_ms", "bound_by"), bound(
        R * d * 2 + d * V * 2 + R * 4 + 2 * R * 4, ce_flops, "bfloat16")))
    lse, _ = lm_head_ce.raw(x, w, lab, vocab=vocab)
    xl = x.detach().requires_grad_()
    wl = w.detach().requires_grad_()
    lib_loss = None

    def library_bwd():
        return torch.autograd.grad(lib_loss, (xl, wl), gr[:, 0],
                                   retain_graph=True)

    logits = torch.matmul(xl, wl).float()[:, :vocab]
    lib_loss = torch.logsumexp(logits, -1) - logits.gather(
        1, lab.long())[:, 0]
    out["lm_head_bwd"] = dict(
        ms=cuda_ms(lambda: lm_head_bwd(x, w, lab, lse, gr, vocab=vocab), 2, 1),
        plain_ms=cuda_ms(lambda: lm_head_bwd_ref(x, w, lab, lse, gr,
                                                 vocab=vocab), 2, 1),
        library_ms=cuda_ms(library_bwd, 3, 1),
        library="autograd of torch.matmul (bf16) + logsumexp - gather",
        shape=f"x ({R},{d}), embed.T ({d},{V}) bf16 -> dx, dw f32")
    out["lm_head_bwd"].update(zip(("bound_ms", "bound_by"), bound(
        R * d * 2 + d * V * 2 + R * 4 * 3 + R * d * 4 + d * V * 4,
        3 * ce_flops, "bfloat16")))
    del logits, lib_loss, xl, wl

    q, k, v, do = t["q"], t["k"], t["v"], t["do"]
    b, h, s, hd = q.shape
    hk = k.shape[1]
    with torch.no_grad():
        o, lse = flash_attention_fwd(q, k, v, causal=True)
    delta = flash_delta(do, o)
    out["flash_delta"] = dict(
        ms=cuda_ms(lambda: flash_delta(do, o), 100),
        plain_ms=cuda_ms(lambda: flash_delta_ref(do, o), 100),
        library_ms=cuda_ms(lambda: (do * o).sum(-1), 100),
        library="(do * o).sum(-1) in bf16",
        shape=f"do (strided), o ({b},{h},{s},{hd}) bf16")
    out["flash_delta"].update(zip(("bound_ms", "bound_by"), bound(
        2 * b * h * s * hd * 2 + b * h * s * 4, 2 * b * h * s * hd,
        "bfloat16")))
    qs, ks, vs = (t_.detach().contiguous().requires_grad_()
                  for t_ in (q, k, v))
    sdpa = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                          enable_gqa=True)
    pairs = s * (s + 1) // 2
    out["flash_bwd"] = dict(
        ms=cuda_ms(lambda: flash_bwd(q, k, v, do, lse, delta, causal=True),
                   5, 1),
        plain_ms=cuda_ms(lambda: flash_bwd_ref(q, k, v, do, lse, delta,
                                               causal=True), 3, 1),
        library_ms=cuda_ms(lambda: torch.autograd.grad(
            sdpa, (qs, ks, vs), do, retain_graph=True), 10),
        library="autograd of F.scaled_dot_product_attention(is_causal, "
                "enable_gqa)",
        shape=f"q ({b},{h},{s},{hd}), k/v ({b},{hk},{s},{hd}) bf16, causal")
    out["flash_bwd"].update(zip(("bound_ms", "bound_by"), bound(
        2 * (2 * b * h * s * hd + 2 * b * hk * s * hd) + 2 * b * h * s * 4
        + 2 * b * h * s * hd + 2 * 4 * b * hk * s * hd,
        2.5 * 4 * b * h * hd * pairs, "bfloat16")))
    return out


# ---------------------------------------------------------------------------

def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch not found: run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import delta as delta_kernel
    from repro_torch.kernels.rmsnorm import kernel as rms_kernel
    from repro_torch.models import LM

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    log(f"[card] {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    t_start = time.perf_counter()

    # 1. build
    t0 = time.perf_counter()
    logs = _build.build_all()
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"[nvcc {name}] {line.strip()}")
    rms_kernel.build()
    delta_kernel.build()
    log(f"[build] {len(logs)} CUDA sources compiled in "
        f"{time.perf_counter() - t0:.1f}s")

    # 2a. kernels vs plain, f32 small shapes
    small_f32_checks(dev)
    small_f32_train_checks(dev)

    cfg = get_config("llama3_2_1b")
    page, num_pages, slots = 512, 8 * 4 + 1, 8
    reqs = traffic(0, 16, cfg.vocab_size)
    sq = max(len(p) for p, _ in reqs)               # longest admission
    lens = [len(p) + 16 for p, _ in reqs[:slots]]   # a decode step's kv

    # 3. 2-layer f32: card vs CPU, serving and training
    two_layer_f32_check(cfg)
    two_layer_f32_train_check(cfg)

    # 4. the serving path: full llama3_2_1b in bf16 through the engine
    model = LM(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    nparam = model.param_count(params)
    log(f"[model] llama3_2_1b bf16: {nparam} parameters, init "
        f"{time.perf_counter() - t0:.1f}s")
    counts, stats = serve_main_path(cfg, model, params, reqs)
    log("serving kernels: " + ", ".join(f"{k}={counts[k]}"
                                        for k in SERVE_KERNELS))
    log(f"[engine] {stats['tokens']} tokens for {len(reqs)} requests in "
        f"{stats['wall_s']:.3f}s = {stats['tok_s']:.1f} tok/s (prefills "
        f"{stats['prefill_calls']}, decode steps {stats['decode_steps']}, "
        f"preempted {stats['preempted']})")

    profile_decode(model, params, reqs)

    # 2b. kernels vs plain at the main path's full-width shapes, bf16
    errs = full_width_bf16_checks(dev, cfg, params, sq, lens, page,
                                  num_pages)

    times = time_kernels(dev, cfg, params, sq, lens, page, num_pages)
    del model, params

    # 6. the training path: full llama3_2_1b in bf16 through TrainLoop
    model, tcounts, tstats, out = train_main_path(cfg)
    log("training kernels: " + ", ".join(
        f"{k}={tcounts[k]}" for k in TRAIN_KERNELS + ("rmsnorm", "flash_fwd")))
    log(f"[train] loss history {tstats['history']}")
    log(f"[train] {TRAIN_STEPS} steps of {TRAIN_BATCH}x{TRAIN_SEQ} tokens in "
        f"{tstats['wall_s']:.3f}s wall (init and checkpoints included); "
        f"step ms {[round(t, 3) for t in tstats['step_ms']]}; steps 2-"
        f"{TRAIN_STEPS}: {tstats['tok_s']:.1f} tokens/s; peak device "
        f"memory {tstats['peak_gb']:.2f} GB; checkpoint restored bit-equal "
        f"in {tstats['restore_s']:.1f}s")
    counts.update({k: tcounts[k] for k in TRAIN_KERNELS})

    # 7. where a train step's time goes
    profile_train_step(model, out["params"], out["opt"])
    embed = out["params"]["embed"].detach()
    del out

    # 2b (training kernels) and 8. times
    errs.update(full_width_train_checks(dev, cfg, embed))
    times.update(time_train_kernels(dev, cfg, embed))
    for name, t in times.items():
        log(f"[time] {name} {t['shape']}: kernel {t['ms']:.4f} ms, bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}), plain "
            f"{t['plain_ms']:.4f} ms, library {t['library_ms']:.4f} ms "
            f"[{t['library']}]")
    log(f"[done] {time.perf_counter() - t_start:.1f}s")

    kernels = []
    for name, (route, source, replaces) in KERNEL_INFO.items():
        t = times[name]
        kernels.append(dict(
            name=name, route=route, source=source, replaces=replaces,
            launches=counts[name], max_abs_err=errs[name], ms=t["ms"],
            plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by=t["bound_by"], library_ms=t["library_ms"]))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
