#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
GPU: builds the port's seventeen hand-written Hopper kernels from
``src/``, holds each against its plain PyTorch version, serves
``llama3_2_1b`` through the continuous-batching engine, trains it through
``TrainLoop``, runs the paper's FD, SEM and DG apps at full size, serves
``musicgen_medium`` and ``falcon_mamba_7b`` through the static-batch path,
runs sequence-parallel ring attention at ``llama3_2_1b``'s widths and the
blocked matmul op, and times each kernel.

  python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

1. build: one nvcc per CUDA source, all in parallel (each kernel's
   registers and spills printed), plus the Triton flash-delta kernel; the
   SASS of the matmul, CE-head and decode-head libraries must hold HGMMA
   (wgmma) and UTMALDG (TMA loads), the CE forward's own tensor-core kernel
   HGMMA, that of the flash_fwd, flash_bwd and ring_flash libraries HGMMA
   and LDGSTS (cp.async), the ring step forward's own tensor-core kernel
   too, those of paged_decode and flash_decode LDGSTS;
2. kernels vs plain versions on the card: f32 at small shapes (tolerance
   1e-4; the app kernels at ragged shapes, 2e-5 for FD and 2e-4 of
   max|ref| for SEM/DG; flash_decode on positional and rotated caches,
   with kv_len as a device tensor and as an int (identical bits), at
   d = 256 with g = 8 and d = 112, with ranges wholly past q_pos or below
   the window, wrapped caches, NaN in masked slots, rows with no live slot
   and every split length forced; ssm_scan at L and dm off its tile, n
   4/8/16, with and without h0, and at falcon's prefill shape in bf16;
   flash_fwd with a window and at head dim
   128, paged decode at 128; the ring step forward and backward at ragged
   shard and chunk lengths, GQA, window and prefix masks and a chunk wholly
   after its shard; matmul at ragged M/N/K, out_dtype and K == 0; the
   tensor-core routes of matmul and the CE forward and backward in bf16 at
   ragged shapes, tied and untied heads, of flash_fwd and flash_bwd at
   ragged Sq != Skv, windows, d 32/64/128, GQA groups 1/4 and the
   projections' strided q, k, v, do (flash_bwd also with rows that see no
   key, and through a windowed and a d = 128 flash_attention gradient), of
   the ring step forward and backward at ring offsets with dead rows,
   windows, a prefix and d 32/64/128, and of the decode head at R = 1-300,
   tied and untied, each launch's route counted), bf16 at
   the main paths' full-width shapes (the ring kernels at every launch
   shape and offset of phase 13: 4 local steps, 16 replayed pairs) and f32
   at the apps' full-size shapes (tolerances stated beside each check; the
   DG kernels also on the apps path's own state, both versions against the
   f64 result within the f32 rounding bound of their summed terms);
3. llama3_2_1b at full width with 2 layers in f32, one set of weights on
   the card (kernels) and on the CPU (plain versions): prefill logits and
   the first 8 greedy tokens must agree; the training loss and every
   parameter's gradient must agree; musicgen_medium, falcon_mamba_7b and a
   windowed (64) llama3_2_1b through ``generate`` on the static path
   (200-token prompt, 80 new tokens across the wrap): equal tokens, close
   logits; llama's static tokens equal its engine tokens; internlm2_1_8b
   (head_dim 128) through prefill and the engine, card vs CPU;
4. the serving path: the full 16-layer bf16 llama3_2_1b through ``Engine``
   (8 slots, max_len 2048, page 512, 16 requests of 33-1000 prompt tokens
   and 32-64 new tokens). Launch counts are zeroed just before and read just
   after; every serving kernel must have launched, flash_fwd and the
   decode head on their tensor-core routes every time, rmsnorm on its
   16-byte vector route every time, every request complete, every logit be
   finite;
5. where the serving time goes: eight decode steps of a full engine on the
   host clock and under ``torch.profiler`` (device busy share, top device
   ops, the rmsnorm and paged decode kernels' rows), and one admission
   prefill;
6. the training path: the full 16-layer bf16 llama3_2_1b through
   ``TrainLoop`` (global batch 4, seq_len 1024, 6 steps, a checkpoint every
   3 steps). Launch counts are zeroed just before and read just after;
   every training kernel (and rmsnorm, flash_fwd) must have launched, the
   bf16 CE forward and backward, flash_fwd and flash_bwd on their
   tensor-core routes every time, every loss be
   finite, and the latest checkpoint must restore bit-equal to the
   parameters and optimizer state saved;
7. where the training time goes: the host's enqueue time (until
   ``train_step`` returns, before the synchronize), one train step on the
   host clock and under ``torch.profiler`` (the tensor-core CE forward's
   and backward's launches and flash_bwd's two kernels among its device
   rows, each with its TFLOP/s);
8. per-kernel times at the main paths' shapes beside their bound, the
   plain version's time and one library call's time (null where no single
   PyTorch call computes the function), flash_fwd and rmsnorm also at the
   train step's shape, flash_decode also at paligemma's d = 256, g = 8 and
   ssm_scan at falcon's prefill shape; the device time alone of flash_fwd,
   rmsnorm, paged decode, flash_decode and ssm_scan, their GB/s (the
   scan's exponentials/s), and the host cost of the pieces of one rmsnorm
   and one flash_decode call; the decode head, the CE forward, flash_bwd and the ring step
   forward also on their CUDA-core kernels on the same inputs (a copy 2
   bytes off the alignment the tensor-core route needs), their bf16 outputs
   held to the full-width limits; the tensor-core kernels' TFLOP/s, the
   decode head's GB/s;
9. the apps path, launch counts zeroed just before and read just after,
   each app kernel launched exactly as often as its calls say: ``FDWave``
   on 8192^2 at radius 4 for 200 steps (MNodes/s, analytic error) and
   ``launch.apps.fd_wave`` at the example's settings (error < 5e-2); the
   SEM operator on 32^3 elements of N = 7 (``apply_local`` and
   ``apply_global``, GFLOP/s) and ``launch.apps.sem_solve`` on 8^3
   elements of N = 7 (PCG iterations, error < 0.05); ``launch.apps.swe_run``
   on 2 x 256^2 triangles of N = 5 for 100 LSERK steps (finite, h within
   (0.9, 1.2), water mass conserved to 1e-5 relative, summed in f64);
10. where the apps' time goes: an LSERK step on the host clock and under
    ``torch.profiler``, and ``apply_global`` split into gather, kernel and
    ``index_add_`` scatter on CUDA events, beside two other scatter calls;
11. the static path: the full 48-layer bf16 musicgen_medium through
    ``generate`` (8 prompts of 512 tokens, 64 new; launch counts zeroed
    just before and read just after, flash_decode exactly 48 x 64), where
    its decode step's time goes (host clock, profiler), and prefill with 16
    conditioning frames + decode_step against forward (5% of the largest
    logit);
12. the full 64-layer bf16 falcon_mamba_7b through ``generate`` (4 prompts
    of 512 tokens, 32 new; ssm_scan exactly 64, once per layer of the
    prefill), its decode step's profile, and ``forward`` on B = 1, S = 2048
    (ssm_scan exactly 64) with its last logits against ``prefill``'s;
13. the ring path at llama3_2_1b's attention widths (B = 1, H = 32,
    Hk = 8, d = 64, S = 16384, bf16): the local ``ring_flash_attention``
    over 4 steps and the distributed schedule replayed rank by rank for 4
    ranks (``ring_schedule_replay``), forward and gradients, both against
    the port's ``flash_attention`` (each step kernel launched exactly
    4 + 16 times, both on their tensor-core routes each time); then
    ``matmul`` at 4096 x 2048 @ 2048 x 8192 in bf16
    (one launch, on the tensor-core route) against its plain version. The
    multi-rank ring over ``torch.distributed`` needs two cards and is held
    on the CPU only (``tests/test_torch_ring.py``, gloo).

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
    "rmsnorm": ("cuda", "src/repro_torch/csrc/rmsnorm.cu",
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
    "fd2d": ("cuda", "src/repro_torch/csrc/fd2d.cu",
             "src/repro/apps/fd2d.py:21"),
    "sem_apply": ("cuda", "src/repro_torch/csrc/sem.cu",
                  "src/repro/apps/sem.py:29"),
    "dg_volume": ("cuda", "src/repro_torch/csrc/dg.cu",
                  "src/repro/apps/dg_swe.py:26"),
    "dg_surface": ("cuda", "src/repro_torch/csrc/dg.cu",
                   "src/repro/apps/dg_swe.py:276"),
    "flash_decode": ("cuda", "src/repro_torch/csrc/flash_decode.cu",
                     "src/repro/kernels/flash_attention/kernel.py:356"),
    "ssm_scan": ("cuda", "src/repro_torch/csrc/ssm_scan.cu",
                 "src/repro/kernels/ssm_scan/kernel.py:26"),
    "ring_flash_fwd": ("cuda", "src/repro_torch/csrc/ring_flash.cu",
                       "src/repro/kernels/flash_attention/kernel.py:577"),
    "ring_flash_bwd": ("cuda", "src/repro_torch/csrc/ring_flash.cu",
                       "src/repro/kernels/flash_attention/kernel.py:690"),
    "matmul": ("cuda", "src/repro_torch/csrc/matmul.cu",
               "src/repro/kernels/matmul/kernel.py:20"),
}
SERVE_KERNELS = ("rmsnorm", "flash_fwd", "paged_decode", "lm_head")
TRAIN_KERNELS = ("lm_head_ce", "lm_head_bwd", "flash_delta", "flash_bwd")
# the training main path: llama3_2_1b at global batch 4 x seq_len 1024
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 1024, 6
APP_KERNELS = ("fd2d", "sem_apply", "dg_volume", "dg_surface")
RING_KERNELS = ("ring_flash_fwd", "ring_flash_bwd", "matmul")
# the apps main path: the FD wave on 8192^2 (radius 4, 200 steps), the SEM
# operator on 32^3 elements of N = 7 (each apply timed over SEM_REPEATS
# calls), the DG solver on 2 x 256^2 triangles of N = 5 (100 LSERK steps)
FD_SIZE, FD_RADIUS, FD_STEPS = 8192, 4, 200
SEM_ELEMS, SEM_N, SEM_REPEATS = 32, 7, 5
DG_NX, DG_N, DG_STEPS = 256, 5, 100
# the static path: musicgen_medium on 8 prompts of 512 tokens, 64 new;
# falcon_mamba_7b on 4 prompts of 512 tokens, 32 new, and a forward of
# B = 1, S = 2048
MG_BATCH, MG_PROMPT, MG_GEN = 8, 512, 64
FM_BATCH, FM_PROMPT, FM_GEN, FM_FWD_SEQ = 4, 512, 32, 2048
# the ring path: llama3_2_1b's attention (B = 1, H = 32, Hk = 8, d = 64)
# over 16384 tokens in 4 steps (4 ranks when replayed); matmul at the MLP's
# up projection of 4096 tokens (d 2048 -> d_ff 8192)
RING_SEQ, RING_STEPS = 16384, 4
MM_SHAPE = (4096, 2048, 8192)


def log(msg):
    print(msg, flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check_close(name, got, ref, *, atol, rtol, quiet=False):
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
    if not quiet:
        log(f"[check] {name}: max|err| {worst:.3e} (atol {atol}, "
            f"rtol {rtol})")
    return worst


def check_rel(name, got, ref, rel, quiet=False):
    """check_close with atol = rel * max|ref| and rtol = rel: for outputs
    whose error is a sum-order effect that scales with their magnitude."""
    scale = float(ref.float().abs().max())
    return check_close(name, got, ref, atol=rel * scale, rtol=rel,
                       quiet=quiet)


def check_rows(name, got, ref, rel, quiet=False):
    """Each element within ``rel`` times the largest |ref| of its row (the
    last dim): for attention's o, whose rows differ in scale with the keys
    they see (|o| ~ sqrt(e / keys) for randn inputs) and round to bf16 each
    on its own scale. Returns (max |err|, max err / row max)."""
    import torch

    got, ref = got.float(), ref.float()
    if got.shape != ref.shape:
        fail(f"{name}: shape {tuple(got.shape)} != {tuple(ref.shape)}")
    if not torch.isfinite(got).all():
        fail(f"{name}: non-finite values")
    err = (got - ref).abs()
    scale = ref.abs().amax(-1, keepdim=True)
    worst = float(err.max()) if err.numel() else 0.0
    ratio = (float(torch.where(err == 0, 0.0, err / scale).max())
             if err.numel() else 0.0)
    bad = err > rel * scale
    if bad.any():
        fail(f"{name}: {int(bad.sum())} of {err.numel()} elements outside "
             f"{rel:.4g} x their row's max|ref| (max |err| {worst:.3e}, "
             f"max err / row max {ratio:.3e})")
    if not quiet:
        log(f"[check] {name}: max|err| {worst:.3e}, max err / row max "
            f"{ratio:.3e} (limit {rel:.4g})")
    return worst, ratio


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


def small_f32_static_checks(dev):
    """The static path's kernels against their plain versions in f32 at
    small ragged shapes, tolerance 1e-4: ``flash_decode`` on positional and
    rotated caches (skv off the 32-slot chunk, a window under a chunk,
    before and after the wrap, kv_len < skv, the clamped last slot, g of 1,
    4 and 8, d of 32, 64 and 128, a strided q); ``ssm_scan`` (y and hT) at
    ragged L and dm with h0; ``flash_fwd`` with a window and at d = 128;
    ``paged_decode`` at d = 128."""
    import torch

    from repro_torch.kernels.flash_attention import (decode_ref, flash_decode,
                                                     flash_attention_fwd,
                                                     flash_fwd_ref,
                                                     paged_decode_attention,
                                                     paged_decode_ref,
                                                     rolling_slot_pos)
    from repro_torch.kernels.ssm_scan import selective_scan_ref, ssm_scan_fwd

    tol = dict(atol=1e-4, rtol=1e-4)
    g = torch.Generator(device=dev).manual_seed(6)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev)

    # (skv, kv_len, window, slot_pos after t tokens or None, g, d)
    cases = [(77, 77, None, None, 1, 64), (77, 40, None, None, 4, 64),
             (200, 150, 5, None, 4, 128), (200, 200, None, None, 8, 128),
             (33, 1, None, None, 8, 32), (64, 50, 64, 50, 1, 64),
             (64, 64, 64, 64, 4, 64), (64, 100, 64, 100, 8, 128),
             (40, 173, 64, 173, 4, 64), (24, 31, 24, 31, 1, 32),
             (200, 1000, 200, 1000, 4, 64)]
    for skv, kv_len, window, t, gq, d in cases:
        b, hk = 3, 2
        q = rnd(b, 1, hk * gq, d).transpose(1, 2)          # strided view
        k, v = rnd(b, hk, skv, d), rnd(b, hk, skv, d)
        sp = (None if t is None else
              rolling_slot_pos(skv, t).to(dev))
        o = flash_decode(q, k, v, kv_len=kv_len, slot_pos=sp, window=window)
        ro = decode_ref(q, k, v, kv_len=kv_len, slot_pos=sp, window=window)
        check_close(f"flash_decode f32 skv={skv} kv_len={kv_len} "
                    f"window={window} rotated={t is not None} g={gq} d={d}",
                    o, ro, **tol)
    # a row that sees no slot gives exactly 0
    k = rnd(1, 2, 40, 64)
    o = flash_decode(rnd(1, 4, 1, 64), k, k, kv_len=10,
                     slot_pos=torch.full((40,), -1, dtype=torch.int32,
                                         device=dev))
    if not (o == 0).all():
        fail("flash_decode: a row with no live slot must give exactly 0")

    for bt, L, dm, n in ((3, 77, 100, 16), (1, 200, 64, 8), (2, 5, 33, 4)):
        x, dA = rnd(bt, L, dm), rnd(bt, L, dm)
        delta = torch.nn.functional.softplus(dA) * 0.1
        A = -(rnd(dm, n).abs() + 0.1)
        B, C, D = rnd(bt, L, n), rnd(bt, L, n), rnd(dm)
        h0 = rnd(bt, dm, n)
        y, hT = ssm_scan_fwd(x, delta, A, B, C, D, h0=h0)
        ry, rhT = selective_scan_ref(x, delta, A, B, C, D, h0=h0)
        tag = f"ssm_scan f32 bt={bt} L={L} dm={dm} n={n}"
        check_close(tag + " y", y, ry, **tol)
        check_close(tag + " hT", hT, rhT, **tol)

    for sq, skv, h, hk, d, causal, window in (
            (130, 130, 4, 2, 64, True, 40), (70, 200, 4, 2, 64, True, 33),
            (130, 130, 8, 2, 64, False, 7), (70, 70, 4, 2, 128, True, None),
            (130, 200, 8, 8, 128, True, 50), (9, 9, 4, 1, 128, False, None)):
        q = rnd(2, sq, h, d).transpose(1, 2)
        k, v = rnd(2, hk, skv, d), rnd(2, hk, skv, d)
        o, lse = flash_attention_fwd(q, k, v, causal=causal, window=window)
        ro, rlse = flash_fwd_ref(q, k, v, causal=causal, window=window)
        tag = (f"flash f32 sq={sq} skv={skv} h={h}/{hk} d={d} c={causal} "
               f"window={window}")
        check_close(tag + " o", o, ro, **tol)
        check_close(tag + " lse", lse, rlse, **tol)

    for gq, page in ((8, 16), (2, 5)):
        b, hk, d, nsp = 3, 2, 128, 4
        npages = b * nsp + 1
        q = rnd(b, hk * gq, 1, d)
        kp, vp = rnd(npages, hk, page, d), rnd(npages, hk, page, d)
        table = (torch.arange(b * nsp, dtype=torch.int32) + 1).reshape(b, nsp)
        kv_len = torch.tensor([3 * page + 2, page, 1], dtype=torch.int32)
        pos = torch.full((npages, page), -1, dtype=torch.int32)
        for bi in range(b):
            for j in range(nsp):
                p = torch.arange(j * page, (j + 1) * page, dtype=torch.int32)
                pos[table[bi, j]] = torch.where(p < kv_len[bi], p, -1)
        kw = dict(block_table=table.to(dev), kv_len=kv_len.to(dev),
                  pos_pages=pos.to(dev))
        check_close(f"paged f32 g={gq} page={page} d=128",
                    paged_decode_attention(q, kp, vp, **kw),
                    paged_decode_ref(q, kp, vp, **kw), **tol)
    torch.cuda.synchronize()


def small_decode_scan_checks(dev):
    """The split-KV flash_decode and the time-parallel ssm_scan against
    their plain versions at the edges of their designs. flash_decode:
    kv_len as a one-element int32 device tensor and as an int (identical
    outputs), d = 256 with g = 8 and d = 112 in f32 and bf16, ranges wholly
    past q_pos and wholly below the window, wrapped rotated caches, NaN in
    masked k and v slots (the same bits as without), rows with no live
    slot (exactly 0), and every split length of 32-512 forced; f32 within
    1e-4, bf16 within 1% of max|o| and 2^-7 (both sides round o to bf16;
    the plain version also rounds p). ssm_scan: L and dm off its 128-step,
    32-channel tile, n 4/8/16, with and without h0 (f32, 1e-4), and at
    falcon_mamba_7b's prefill shape (bf16 x, B, C, f32 delta; y within
    1e-2 and 2^-7, hT within 1e-3 of its largest magnitude)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import (decode_ref, flash_decode,
                                                     ops as attn_ops,
                                                     rolling_slot_pos)
    from repro_torch.kernels.ssm_scan import selective_scan_ref, ssm_scan_fwd

    tol = dict(atol=1e-4, rtol=1e-4)
    g = torch.Generator(device=dev).manual_seed(16)
    i32 = torch.int32

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev)

    def kv_tol(dtype, ref):
        if dtype == torch.float32:
            return tol
        return dict(atol=0.01 * float(ref.float().abs().max()), rtol=2 ** -7)

    # (b, hk, g, d, skv, kv_len, window, rotated after t tokens or None)
    cases = [(3, 1, 8, 256, 200, 150, None, None),   # paligemma's MQA
             (2, 2, 8, 256, 96, 500, 96, 500),       # d 256, wrapped
             (3, 2, 4, 112, 200, 130, None, None),
             (2, 4, 1, 112, 64, 100, 40, 100),       # d 112, wrapped
             (2, 2, 4, 64, 1000, 40, None, None),    # ranges past q_pos
             (2, 2, 4, 64, 1000, 900, 50, None),     # ranges below the window
             (3, 2, 2, 128, 96, 517, 40, 517),       # window < cache, wrapped
             (1, 3, 16, 128, 300, 300, None, None)]  # g * d = 2048
    for b, hk, gq, d, skv, kv_len, window, t in cases:
        for dtype in (torch.float32, torch.bfloat16):
            q = rnd(b, 1, hk * gq, d).transpose(1, 2).to(dtype)
            k, v = rnd(b, hk, skv, d).to(dtype), rnd(b, hk, skv, d).to(dtype)
            sp = None if t is None else rolling_slot_pos(skv, t).to(dev)
            kw = dict(slot_pos=sp, window=window)
            ref = decode_ref(q, k, v, kv_len=kv_len, **kw)
            o = flash_decode(q, k, v, kv_len=kv_len, **kw)
            tag = (f"flash_decode {str(dtype)[6:]} b={b} hk={hk} g={gq} d={d} "
                   f"skv={skv} kv_len={kv_len} window={window} "
                   f"rotated={t is not None} split="
                   f"{attn_ops.decode_split(b, hk, skv)[0]}")
            check_close(tag, o, ref, **kv_tol(dtype, ref))
            kl = torch.tensor([kv_len], dtype=i32, device=dev)
            if not torch.equal(flash_decode(q, k, v, kv_len=kl, **kw), o):
                fail(f"{tag}: kv_len as a device tensor gave other bits "
                     "than kv_len as an int")
    log("[check] flash_decode: kv_len as an int32 device tensor gives the "
        "int's bits in every case above")

    # NaN in masked slots: slots past q_pos (positional) and an empty slot
    # of a rotated cache; the kernel gives the bits it gives without them
    for sp in (None, rolling_slot_pos(64, 40).to(dev)):
        q = rnd(2, 4, 1, 64).to(torch.bfloat16)
        k = rnd(2, 2, 64, 64).to(torch.bfloat16)
        v = rnd(2, 2, 64, 64).to(torch.bfloat16)
        want = flash_decode(q, k, v, kv_len=40, slot_pos=sp, window=64)
        kn, vn = k.clone(), v.clone()
        kn[:, :, 45], vn[:, :, 45] = float("nan"), float("nan")
        kn[:, :, 63], vn[:, :, 63] = float("nan"), float("nan")
        got = flash_decode(q, kn, vn, kv_len=40, slot_pos=sp, window=64)
        if not torch.equal(got, want):
            fail(f"flash_decode: NaN in masked slots (rotated="
                 f"{sp is not None}) moved the output")
    # rows with no live slot give exactly 0
    k = rnd(2, 2, 70, 256)
    for kw in (dict(kv_len=torch.zeros(1, dtype=i32, device=dev)),
               dict(kv_len=30, slot_pos=torch.full((70,), -1, dtype=i32,
                                                   device=dev))):
        if not (flash_decode(rnd(2, 16, 1, 256), k, k, **kw) == 0).all():
            fail(f"flash_decode: a row with no live slot must give exactly "
                 f"0 ({kw})")
    log("[check] flash_decode: NaN in masked k/v slots changes no bit; rows "
        "with no live slot give exactly 0")

    # every split length, forced
    rule = attn_ops.decode_split
    q, k, v = rnd(2, 8, 1, 64), rnd(2, 2, 777, 64), rnd(2, 2, 777, 64)
    sp = rolling_slot_pos(777, 900).to(dev)
    try:
        for split in (32, 64, 128, 256, 512):
            attn_ops.decode_split = (lambda b, hk, skv, s=split:
                                     (s, -(-skv // s)))
            for kw in (dict(kv_len=600, window=100), dict(kv_len=777),
                       dict(kv_len=900, slot_pos=sp, window=300)):
                check_close(f"flash_decode f32 split={split} {sorted(kw)}",
                            flash_decode(q, k, v, **kw),
                            decode_ref(q, k, v, **kw), **tol, quiet=True)
    finally:
        attn_ops.decode_split = rule
    log("[check] flash_decode f32: splits of 32, 64, 128, 256, 512 slots "
        "forced, each within 1e-4 of the plain version")

    for bt, L, dm, n in ((2, 129, 17, 4), (1, 300, 40, 8), (3, 77, 100, 16),
                         (1, 128, 32, 16), (2, 1, 5, 16), (1, 1000, 33, 16)):
        x = rnd(bt, L, dm)
        delta = torch.nn.functional.softplus(rnd(bt, L, dm)) * 0.1
        A = -(rnd(dm, n).abs() + 0.1)
        B, C, D = rnd(bt, L, n), rnd(bt, L, n), rnd(dm)
        for h0 in (rnd(bt, dm, n), None):
            y, hT = ssm_scan_fwd(x, delta, A, B, C, D, h0=h0)
            ry, rhT = selective_scan_ref(x, delta, A, B, C, D, h0=h0)
            tag = (f"ssm_scan f32 bt={bt} L={L} dm={dm} n={n} "
                   f"h0={h0 is not None}")
            check_close(tag + " y", y, ry, **tol)
            check_close(tag + " hT", hT, rhT, **tol)

    args = _scan_inputs(dev, g, get_config("falcon_mamba_7b"), FM_BATCH,
                        FM_PROMPT)
    y, hT = ssm_scan_fwd(*args)
    ry, rhT = selective_scan_ref(*args)
    check_close(f"ssm_scan bf16 y at falcon's prefill {tuple(y.shape)}", y,
                ry, atol=1e-2, rtol=2 ** -7)
    check_rel("ssm_scan bf16 hT (f32) at falcon's prefill", hT, rhT, 1e-3)
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


def _proj(gen, b, s, heads, hd):
    """A bf16 (b, heads, s, hd) tensor laid out as the attention layer's
    projections give it: the (b, s, heads, hd) -> (b, heads, s, hd) view,
    strides (s heads hd, hd, heads hd, 1)."""
    import torch

    t = torch.randn((b, s, heads, hd), generator=gen, device=gen.device)
    return t.to(torch.bfloat16).transpose(1, 2)


def check_flash_tc(tag, q, k, v, quiet=False, **kw):
    """One bf16 flash_attention_fwd call against flash_fwd_ref, on the
    tensor-core route (counted). o within 2e-2 absolute + relative (the
    plain version rounds the normalised p to bf16 before p@v, the kernel
    the unnormalised one; both round o once) and, row by row, within 2^-6
    of the row's largest |o| (the rounding model reads 2^-7, one bf16 ulp of
    o: a tile dropped or counted twice misses by far more); lse within
    1e-3 / 1e-4. Returns max |err| of o."""
    from repro_torch.kernels.flash_attention import (flash_attention_fwd,
                                                     flash_fwd_ref)

    before = flash_attention_fwd.routes["wgmma"]
    o, lse = flash_attention_fwd(q, k, v, **kw)
    if flash_attention_fwd.routes["wgmma"] != before + 1:
        fail(f"{tag}: did not take the tensor-core route")
    ro, rlse = flash_fwd_ref(q, k, v, **kw)
    err = check_close(tag + " o", o, ro, atol=2e-2, rtol=2e-2, quiet=quiet)
    check_rows(tag + " o", o, ro, 2 ** -6, quiet=quiet)
    check_close(tag + " lse", lse, rlse, atol=1e-3, rtol=1e-4, quiet=quiet)
    return err


def full_width_bf16_checks(dev, cfg, params, sq, lens, page, num_pages):
    """Each kernel against its plain version at the main path's shapes, in
    bf16: a prefill of ``sq`` tokens, a decode step over slots holding
    ``lens`` tokens. Returns {kernel: max |err|}."""
    import torch

    from repro_torch.kernels.flash_attention import (paged_decode_attention,
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

    # attention: q, k, v as the projections' strided views (the main
    # path's layout) and k, v contiguous besides; limits as check_flash_tc
    q, k, v = (_proj(gen, 1, sq, n, hd) for n in (h, hk, hk))
    errs["flash_fwd"] = 0.0
    for layout, kk, vv in (("k/v views", k, v),
                           ("k/v contiguous", k.contiguous(), v.contiguous())):
        errs["flash_fwd"] = max(errs["flash_fwd"], check_flash_tc(
            f"flash bf16 sq={sq} h={h}/{hk} {layout}", q, kk, vv,
            causal=True))

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

    # LM head (the tensor-core route): bf16 products are exact in f32; the
    # two sum d=2048 of them in different orders, the tensor cores
    # truncating each k16 step: |err| <= d * 2^-24 * sum|x w| ~ 4e-3 at
    # these magnitudes
    x = rmsnorm_ref(torch.randn((len(lens), d), generator=gen, device=dev),
                    torch.ones(d, device=dev), eps=cfg.norm_eps).to(bf)
    head = params["embed"].T
    before = lm_head_logits.routes["wgmma"]
    lg, m, arg = lm_head_logits.raw(x, head, vocab=cfg.vocab_size)
    if lm_head_logits.routes["wgmma"] != before + 1:
        fail("lm_head bf16 at the decode step's shape did not take the "
             "tensor-core route")
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
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.lm_head import lm_head_logits
    from repro_torch.kernels.rmsnorm import rmsnorm
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
        fwd_routes = dict(flash_attention_fwd.routes)
        head_routes = dict(lm_head_logits.routes)
        rms_routes = dict(rmsnorm.routes)
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
    check_tc_routes("serving path: flash_fwd", fwd_routes, counts["flash_fwd"])
    check_tc_routes("serving path: lm_head", head_routes, counts["lm_head"])
    if rms_routes != {"vec": counts["rmsnorm"], "elem": 0}:
        fail(f"serving path: rmsnorm routes {rms_routes}; all "
             f"{counts['rmsnorm']} launches must take the vector kernel")
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
    for name in ("paged_decode", "rmsnorm"):
        mine = [r for r in rows if name in r[2]]
        if not mine:
            fail(f"profile: no {name} kernel among the decode step's device "
                 "rows")
        for ms, n, key in mine:
            log(f"[profile] {name}: {ms:8.4f} ms/step  {n:4d} calls/step  "
                f"{key[:80]}")

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


def event_ms(fn, n=20):
    """The device time of one call of fn from CUDA events around n calls
    queued behind a sleep kernel: the card starts the first call only once
    the host has enqueued all n, so no host gap between calls is timed
    (unlike cuda_ms). It counts every launch of fn and the ~1 us between
    them, so it reads a little above a profiler row. The sleep must outlast
    the host's enqueueing; it is lengthened until it does."""
    import torch

    fn()
    torch.cuda.synchronize()
    cycles = 2_000_000
    for _ in range(6):
        s0, s, e = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        s0.record()
        torch.cuda._sleep(cycles)
        s.record()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        e.record()
        e.synchronize()
        if s0.elapsed_time(s) > 1.25 * host_ms + 0.05:
            return s.elapsed_time(e) / n
        cycles *= 4
    fail(f"event_ms: the host enqueued {n} calls in {host_ms:.3f} ms, "
         f"longer than a {cycles // 4} cycle sleep")


def device_ms(fn, kernel, n=20):
    """The device time of one call's launches of ``kernel`` (a substring of
    the CUDA kernel's name), from ``torch.profiler``'s device rows over n
    calls: the kernel alone, without the host gaps that cuda_ms's
    back-to-back calls measure when a call is shorter than its wrapper's
    Python. A session that records no device event at all (the profiler
    does so now and then late in a long run, and then goes on doing so) is
    run again, up to three times, and then the call is timed by event_ms
    instead, with a line that says so; a session whose device rows lack
    ``kernel`` fails at once."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        rows = device_rows(prof, n)
        if rows:
            break
    else:
        ms = event_ms(fn, n)
        log(f"[time] {kernel}: the profiler recorded no device event in 3 "
            f"sessions; device time {ms:.4f} ms from CUDA events behind a "
            "queued sleep (event_ms)")
        return ms
    ms = sum(r[0] for r in rows if kernel in r[2])
    if ms <= 0:
        fail(f"profiler: no device time for {kernel}; device rows: "
             f"{[r[2][:120] for r in rows]}")
    return ms


def bound(bytes_, flops, dtype):
    tb, tf = bytes_ / HBM_BPS, flops / PEAK_FLOPS[dtype]
    return (max(tb, tf) * 1e3, "bytes" if tb >= tf else "operations")


def flash_times(q, k, v, iters, plain_iters):
    """Causal flash_attention_fwd on q, k, v (the projections' views): the
    call's time back to back (cuda_ms), the kernel's device time alone on
    these inputs and on contiguous copies of k and v (the layout is the
    only difference), the plain version's time and SDPA's on contiguous
    copies of all three."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (flash_attention_fwd,
                                                     flash_fwd_ref)

    qc, kc, vc = (t.contiguous() for t in (q, k, v))

    def run(kk, vv):
        return lambda: flash_attention_fwd(q, kk, vv, causal=True)

    return dict(
        ms=cuda_ms(run(k, v), iters),
        device_ms=device_ms(run(k, v), "fwd_tc_kernel"),
        device_ms_contig=device_ms(run(kc, vc), "fwd_tc_kernel"),
        plain_ms=cuda_ms(lambda: flash_fwd_ref(q, k, v, causal=True),
                         plain_iters, 1),
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            qc, kc, vc, is_causal=True, enable_gqa=True), iters),
        library="F.scaled_dot_product_attention(is_causal, enable_gqa) on "
                "contiguous q, k, v")


def rmsnorm_host_split(x, w, wb, eps, n=2000):
    """Host microseconds of one rmsnorm call on x (rows, 1, d) and of its
    pieces, each run n times back to back on the host clock: the checks
    and route (what the wrapper reads before it allocates), torch.empty,
    the stream handle, the ctypes call refused before its launch (rows =
    0), the ctypes call that launches; beside them F.rms_norm's whole
    call."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import _build
    from repro_torch.kernels.rmsnorm import ops, rmsnorm

    d = x.shape[-1]
    rows = x.numel() // d
    lib, fn = ops._entry()
    o = torch.empty_like(x)
    xp, wp, op, st = x.data_ptr(), w.data_ptr(), o.data_ptr(), _build.stream()

    def checks():
        return (_build.on_cpu("rmsnorm", x, w), ops._CODE.get(x.dtype),
                ops._CODE.get(w.dtype), w.shape != (d,), w.is_contiguous(),
                x.numel(), x.is_contiguous(),
                ops._vec(d, d, x.data_ptr(), w.data_ptr(), 2, 4))

    def per_call(f):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            f()
        dt = (time.perf_counter() - t0) * 1e6 / n
        torch.cuda.synchronize()
        return dt

    if fn(1, xp, wp, op, 0, d, d, 1, 0, eps, st) == 0:
        fail("rmsnorm: the entry point launched with rows = 0")
    return dict(
        whole=per_call(lambda: rmsnorm(x, w, eps=eps)),
        checks=per_call(checks),
        empty=per_call(lambda: torch.empty_like(x)),
        stream=per_call(_build.stream),
        ctypes=per_call(lambda: fn(1, xp, wp, op, 0, d, d, 1, 0, eps, st)),
        ctypes_launch=per_call(
            lambda: fn(1, xp, wp, op, rows, d, d, 1, 0, eps, st)),
        library=per_call(lambda: F.rms_norm(x, (d,), wb, eps)))


def time_kernels(dev, cfg, params, sq, lens, page, num_pages):
    """{kernel: dict(ms, plain_ms, bound_ms, bound_by, library_ms)} at the
    main path's shapes: a decode step of len(lens) slots for rmsnorm, paged
    decode and the LM head; the longest admission prefill for flash."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (paged_decode_attention,
                                                     paged_decode_ref)
    from repro_torch.kernels.flash_attention import ops as attn_ops
    from repro_torch.kernels.lm_head import lm_head_logits, lm_head_logits_ref
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_ref

    bf = torch.bfloat16
    d, h, hk, hd = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                    cfg.resolved_head_dim)
    b = len(lens)
    gen = torch.Generator(device=dev).manual_seed(3)
    out = {}

    w = torch.ones(d, device=dev)
    wb = w.to(bf)
    eps = cfg.norm_eps
    # the decode step's rows and the train step's
    for name, rows in (("rmsnorm", b), ("rmsnorm@train",
                                        TRAIN_BATCH * TRAIN_SEQ)):
        x = torch.randn((rows, 1, d), generator=gen, device=dev).to(bf)
        nbytes = 2 * rows * d * 2 + d * 4
        out[name] = dict(
            ms=cuda_ms(lambda: rmsnorm(x, w, eps=eps), iters=200),
            device_ms=device_ms(lambda: rmsnorm(x, w, eps=eps), "rmsnorm"),
            plain_ms=cuda_ms(lambda: rmsnorm_ref(x, w, eps=eps), iters=50),
            library_ms=cuda_ms(lambda: F.rms_norm(x, (d,), wb, eps),
                               iters=200),
            bytes=nbytes, library="F.rms_norm (bf16 weight)",
            shape=f"x ({rows},1,{d}) bf16, w f32")
        out[name].update(zip(("bound_ms", "bound_by"), bound(
            nbytes, 4 * rows * d, "bfloat16")))
    x = torch.randn((b, 1, d), generator=gen, device=dev).to(bf)
    out["rmsnorm"]["host_us"] = rmsnorm_host_split(x, w, wb, eps)

    # q, k, v as the projections' views (the admission's layout); SDPA on
    # contiguous copies
    q, k, v = (_proj(gen, 1, sq, n, hd) for n in (h, hk, hk))
    pairs = sq * (sq + 1) // 2
    out["flash_fwd"] = dict(
        **flash_times(q, k, v, iters=30, plain_iters=10),
        flops=4 * h * hd * pairs,
        shape=f"q (1,{h},{sq},{hd}), k/v (1,{hk},{sq},{hd}) bf16 views, "
              "causal")
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
    nbytes = (2 * ntok * hk * hd * 2 + 2 * 2 * b * h * hd
              + pages_read * page * 4 + table.numel() * 4 + b * 4)
    out["paged_decode"] = dict(
        ms=cuda_ms(kernel, iters=64),
        device_ms=device_ms(kernel, "paged_decode"),
        plain_ms=cuda_ms(plain, iters=16),
        library_ms=cuda_ms(library, iters=16), bytes=nbytes,
        library="gather pages + F.scaled_dot_product_attention(attn_mask)",
        shape=f"q ({b},{h},1,{hd}) bf16, pools ({num_pages},{hk},{page},"
              f"{hd}), kv_len {lens}")
    out["paged_decode"].update(zip(("bound_ms", "bound_by"), bound(
        nbytes, 4 * h * hd * ntok, "bfloat16")))
    out["paged_decode"]["split"] = attn_ops.paged_split(b, hk, table.shape[1],
                                                        page)

    xh = torch.randn((b, d), generator=gen, device=dev).to(bf)
    head = params["embed"].T
    V = head.shape[1]
    vocab = cfg.vocab_size

    def library_head():
        lg = torch.matmul(xh, head)
        return lg[:, :vocab].max(dim=-1)

    x_simt, simt = _unaligned(xh), []

    def head_simt():
        simt[:] = lm_head_logits.raw(x_simt, head, vocab=vocab)

    head_bytes = d * V * 2 + b * d * 2 + b * V * 4 + b * 8
    out["lm_head"] = dict(
        ms=_timed_routes(lambda: lm_head_logits.raw(xh, head, vocab=vocab),
                         lm_head_logits, "wgmma", 30),
        simt_ms=_timed_routes(head_simt, lm_head_logits, "simt", 10),
        bytes=head_bytes,
        plain_ms=cuda_ms(lambda: lm_head_logits_ref(xh, head, vocab=vocab),
                         iters=10),
        library_ms=cuda_ms(library_head),
        library="torch.matmul (bf16 out) + max/argmax",
        shape=f"x ({b},{d}) @ embed.T ({d},{V}) bf16")
    out["lm_head"].update(zip(("bound_ms", "bound_by"), bound(
        head_bytes, 2 * b * d * V, "bfloat16")))
    # the CUDA-core kernel's bf16 instantiation (the route of bf16 TMA
    # cannot read) on the same values, at full_width_bf16_checks' limits
    rlg, rm, _ = lm_head_logits_ref(xh, head, vocab=vocab)
    check_close(f"lm_head bf16 CUDA-core ({b},{d})x({d},{V})", simt[0], rlg,
                atol=4e-3, rtol=0)
    check_close("lm_head bf16 CUDA-core row max", simt[1], rm, atol=4e-3,
                rtol=0)
    check_argmax("lm_head bf16 CUDA-core", simt[2], rlg, vocab, gap_tol=8e-3)
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

    q, k, v = (_proj(gen, b, s, n, hd) for n in (h, hk, hk))
    do = torch.randn((b, s, h, hd), generator=gen, device=dev) * 0.1
    return dict(x=x, w=embed.T, lab=lab, g=gr, q=q, k=k, v=v,
                do=do.to(bf).transpose(1, 2))


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
    before = lm_head_ce.routes["wgmma"]
    lse, gold = lm_head_ce.raw(x, w, lab, vocab=vocab)
    if lm_head_ce.routes["wgmma"] != before + 1:
        fail("CE fwd bf16 at full width did not take the tensor-core route")
    rlse, rgold = lm_head_ce_stats_ref(x, w, lab, vocab=vocab)
    errs["lm_head_ce"] = max(
        check_close(f"CE bf16 lse R={x.shape[0]} V={w.shape[1]}", lse, rlse,
                    atol=1e-3, rtol=0),
        check_close("CE bf16 gold", gold, rgold, atol=1e-3, rtol=0))
    # CE backward: f32 outputs that sum 128256 (dx) or 4092 (dw) terms in
    # another order: 1e-3 of the largest magnitude
    before = lm_head_bwd.routes["wgmma"]
    dx, dw = lm_head_bwd(x, w, lab, lse, gr, vocab=vocab)
    if lm_head_bwd.routes["wgmma"] != before + 1:
        fail("CE bwd bf16 at full width did not take the tensor-core route")
    rdx, rdw = lm_head_bwd_ref(x, w, lab, lse, gr, vocab=vocab)
    errs["lm_head_bwd"] = max(check_rel("CE bwd bf16 dx", dx, rdx, 1e-3),
                              check_rel("CE bwd bf16 dw", dw, rdw, 1e-3))
    del dx, dw, rdx, rdw
    q, k, v, do = t["q"], t["k"], t["v"], t["do"]
    # flash_fwd at the train step's shape and layout (q, k, v all views)
    errs["flash_fwd@train"] = check_flash_tc(
        f"flash bf16 train {tuple(q.shape)} k/v {tuple(k.shape)} views", q,
        k, v, causal=True)
    with torch.no_grad():
        o, lse = flash_attention_fwd(q, k, v, causal=True)
    # delta: 64 exact products summed in f32
    delta = flash_delta(do, o)
    errs["flash_delta"] = check_close(
        f"flash delta bf16 {tuple(do.shape)}", delta, flash_delta_ref(do, o),
        atol=1e-4, rtol=1e-4)
    # flash bwd: both compute in f32 from the same bf16 inputs; dq is
    # rounded to bf16 (one ulp, 2^-7 relative), dk/dv stay f32 (1e-3 of the
    # largest magnitude covers the sum order over 1024 queries x 4 heads
    # and the kernel's hi/lo bf16 planes of p and ds)
    before = flash_bwd.routes["wgmma"]
    got = flash_bwd(q, k, v, do, lse, delta, causal=True)
    if flash_bwd.routes["wgmma"] != before + 1:
        fail("flash bwd bf16 at the train shape did not take the tensor-core "
             "route")
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
    from repro_torch.kernels.flash_attention import (flash_attention_fwd,
                                                     flash_bwd)
    from repro_torch.kernels.lm_head import lm_head_bwd, lm_head_ce
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
        bwd_routes = dict(lm_head_bwd.routes)
        fwd_routes = dict(flash_attention_fwd.routes)
        ce_routes = dict(lm_head_ce.routes)
        fbwd_routes = dict(flash_bwd.routes)
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
    if bwd_routes != {"wgmma": counts["lm_head_bwd"], "simt": 0}:
        fail(f"training path: CE backward routes {bwd_routes}; every bf16 "
             "backward must take the tensor-core route")
    check_tc_routes("training path: flash_fwd", fwd_routes, counts["flash_fwd"])
    check_tc_routes("training path: CE forward", ce_routes,
                    counts["lm_head_ce"])
    check_tc_routes("training path: flash_bwd", fbwd_routes,
                    counts["flash_bwd"])

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
    """Where a train step's time goes: the host's enqueue time (until
    ``train_step`` returns) against the step's, two steps on the host clock,
    then one under ``torch.profiler`` (device-side events only)."""
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
    enq = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_step(model, opt, params, opt_state, batch)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        enq.append(((t1 - t0) * 1e3, (time.perf_counter() - t0) * 1e3))
    log("[profile train] host enqueue (train_step returns, before the "
        "synchronize) / step: " + "; ".join(f"{a:.3f} / {b:.3f} ms"
                                            for a, b in enq))
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
    cfg = model.cfg
    ce_flops = (2 * TRAIN_BATCH * (TRAIN_SEQ - 1) * cfg.d_model
                * params["embed"].shape[0])
    log_ce_fwd(rows, ce_flops)
    log_ce_bwd_passes(rows, ce_flops)
    hd = cfg.resolved_head_dim
    log_flash_bwd(rows, 2.5 * 4 * TRAIN_BATCH * cfg.n_heads * hd
                  * TRAIN_SEQ * (TRAIN_SEQ + 1) // 2, cfg.n_layers)
    return step_ms, busy_ms


def log_ce_fwd(rows, flops):
    """The tensor-core CE forward among a train step's device rows: its
    product with the stats epilogue (2 R d V FLOPs) and the merge."""
    gemm = sum(r[0] for r in rows if "gemm_kernel" in r[2]
               and "CeStatsEpi" in r[2])
    merge = sum(r[0] for r in rows if "ce_merge_kernel" in r[2])
    if gemm <= 0:
        fail("train step profile: no device time for the CE forward's "
             "tensor-core kernel")
    log(f"[profile train] CE forward: {gemm + merge:.4f} ms = product + "
        f"stats {gemm:.4f} ms ({flops / (gemm * 1e-3) / 1e12:.1f} TFLOP/s) "
        f"+ merge {merge:.4f} ms")


def log_flash_bwd(rows, flops, layers):
    """flash_bwd's two tensor-core kernels among a train step's device
    rows (one launch of each per layer): dq and dk/dv, against the
    function's FLOPs (4 d per visible pair forward, 2.5 times that
    backward). The ring's instantiations (DeviceOffsets) share the kernels'
    names and are not counted."""
    dq = sum(r[0] for r in rows if "dq_tc_kernel" in r[2]
             and "ValueOffsets" in r[2])
    dkv = sum(r[0] for r in rows if "dkv_tc_kernel" in r[2]
              and "ValueOffsets" in r[2])
    if dq <= 0 or dkv <= 0:
        fail("train step profile: no device time for flash_bwd's tensor-core "
             "kernels")
    log(f"[profile train] flash_bwd: dq {dq:.4f} ms + dk/dv {dkv:.4f} ms "
        f"over {layers} launches = {(dq + dkv) / layers:.4f} ms a launch, "
        f"{flops * layers / ((dq + dkv) * 1e-3) / 1e12:.1f} TFLOP/s of the "
        "function")


def log_ce_bwd_passes(rows, flops):
    """The tensor-core CE backward's three launches among a train step's
    device rows (``device_rows``): (a) the logits recompute with the dl
    planes in its epilogue, 2 R d V FLOPs; (b) dx and (c) dw, 2 x 2 R d V
    issued each (the hi and lo planes)."""
    passes = (("(a) s = x w, dl -> hi/lo planes", "DlEpi", 1),
              ("(b) dx = (hi + lo) w^T", ", 2, 128, 4,", 2),
              ("(c) dw^T = (hi + lo)^T x", "<true, true, 2,", 2))
    for label, tag, units in passes:
        ms = sum(r[0] for r in rows if "gemm_kernel" in r[2] and tag in r[2])
        if ms <= 0:
            fail(f"train step profile: no device time for the CE backward's "
                 f"pass {label}")
        log(f"[profile train] CE backward {label}: {ms:.4f} ms, "
            f"{units * flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s issued")


def _unaligned(t):
    """A copy of ``t`` with its strides whose base lies one element past
    the alignment of t's own: the tensor-core routes refuse it by layout,
    so a wrapper launches its CUDA-core kernel on the same values."""
    import torch

    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].as_strided(t.shape, t.stride())
    out.copy_(t)
    return out


def _timed_routes(fn, wrapper, path, iters, warmup=1):
    """cuda_ms of fn, every launch of ``wrapper`` in it on ``path``."""
    from repro_torch.kernels import reset_launches

    reset_launches()
    ms = cuda_ms(fn, iters, warmup)
    if dict(wrapper.routes) != {"wgmma": 0, "simt": 0, path: iters + warmup}:
        fail(f"timed {wrapper.__name__}: routes {dict(wrapper.routes)}, "
             f"expected all {iters + warmup} on {path}")
    return ms


def time_train_kernels(dev, cfg, embed):
    """{kernel: dict(ms, plain_ms, bound_ms, bound_by, library_ms)} for the
    training kernels at the main path's shapes; the CE forward and
    flash_bwd also on their CUDA-core kernels (simt_ms) on the same values,
    whose bf16 outputs are held to full_width_train_checks' limits."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (flash_attention_fwd,
                                                     flash_bwd, flash_bwd_ref,
                                                     flash_delta,
                                                     flash_delta_ref)
    from repro_torch.kernels import reset_launches
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

    x_simt, simt = _unaligned(x), []

    def ce_simt():
        simt[:] = lm_head_ce.raw(x_simt, w, lab, vocab=vocab)

    out["lm_head_ce"] = dict(
        ms=_timed_routes(lambda: lm_head_ce.raw(x, w, lab, vocab=vocab),
                         lm_head_ce, "wgmma", 10),
        simt_ms=_timed_routes(ce_simt, lm_head_ce, "simt", 2),
        flops=ce_flops,
        plain_ms=cuda_ms(lambda: lm_head_ce_stats_ref(x, w, lab, vocab=vocab),
                         3, 1),
        library_ms=cuda_ms(library_ce, 3, 1),
        library="torch.matmul (bf16) + logsumexp - gather",
        shape=f"x ({R},{d}) @ embed.T ({d},{V}) bf16, labels ({R},1)")
    out["lm_head_ce"].update(zip(("bound_ms", "bound_by"), bound(
        R * d * 2 + d * V * 2 + R * 4 + 2 * R * 4, ce_flops, "bfloat16")))
    # the CUDA-core kernel's bf16 instantiation (the route of bf16 the
    # copies cannot read) at the limits of full_width_train_checks
    rlse, rgold = lm_head_ce_stats_ref(x, w, lab, vocab=vocab)
    check_close(f"CE bf16 CUDA-core lse R={R} V={V}", simt[0], rlse,
                atol=1e-3, rtol=0)
    check_close("CE bf16 CUDA-core gold", simt[1], rgold, atol=1e-3, rtol=0)
    del x_simt, simt, rlse, rgold
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
    reset_launches()
    bwd_ms = cuda_ms(lambda: lm_head_bwd(x, w, lab, lse, gr, vocab=vocab), 2,
                     1)
    if lm_head_bwd.routes != {"wgmma": 3, "simt": 0}:
        fail(f"timed CE backward routes {lm_head_bwd.routes}: expected the "
             "tensor-core route on every call")
    out["lm_head_bwd"] = dict(
        ms=bwd_ms, flops=3 * ce_flops, tc_flops=5 * ce_flops,
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
    pairs = s * (s + 1) // 2
    # flash_fwd at the train step's shape and layout (the projections'
    # views)
    out["flash_fwd@train"] = dict(
        **flash_times(q, k, v, iters=20, plain_iters=3),
        flops=4 * b * h * hd * pairs,
        shape=f"q ({b},{h},{s},{hd}), k/v ({b},{hk},{s},{hd}) bf16 views, "
              "causal (the train step's)")
    out["flash_fwd@train"].update(zip(("bound_ms", "bound_by"), bound(
        2 * (2 * b * h * s * hd + 2 * b * hk * s * hd) + 4 * b * h * s,
        4 * b * h * hd * pairs, "bfloat16")))
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
    q_simt, simt = _unaligned(q), []

    def fbwd_simt():
        simt[:] = flash_bwd(q_simt, k, v, do, lse, delta, causal=True)

    out["flash_bwd"] = dict(
        ms=_timed_routes(lambda: flash_bwd(q, k, v, do, lse, delta,
                                           causal=True),
                         flash_bwd, "wgmma", 20),
        simt_ms=_timed_routes(fbwd_simt, flash_bwd, "simt", 3),
        flops=2.5 * 4 * b * h * hd * pairs,
        tc_flops=4.5 * 4 * b * h * hd * pairs,
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
    # the CUDA-core kernel's bf16 instantiation at full_width_train_checks'
    # limits: dq 2^-7, dk and dv 1e-3, each of the largest magnitude
    want = flash_bwd_ref(q, k, v, do, lse, delta, causal=True)
    check_rel("flash bwd bf16 CUDA-core dq", simt[0], want[0], 2 ** -7)
    check_rel("flash bwd bf16 CUDA-core dk", simt[1], want[1], 1e-3)
    check_rel("flash bwd bf16 CUDA-core dv", simt[2], want[2], 1e-3)
    return out


# ---------------------------------------------------------------------------
# the paper apps: phases 2a (apps), 9, 10 and their times
# ---------------------------------------------------------------------------

def small_f32_app_checks(dev):
    """The app kernels against their plain versions in f32 at small ragged
    shapes: FD with h != w, neither a multiple of the tile, r in {1, 2, 4}
    (tolerance 2e-5); SEM with E not a multiple of eb, nq in {2, 5, 8}, and
    DG with N in {1, 3, 5}, E not a multiple of eb (2e-4 of max|ref|: f32
    contractions summed in another order)."""
    import torch

    from repro_torch.apps.numerics import fd_second_derivative_weights
    from repro_torch.kernels.apps import (apply_ref, dg_surface, dg_volume,
                                          fd2d, fd2d_ref, sem_apply,
                                          surface_ref, volume_ref)

    g = torch.Generator(device=dev).manual_seed(8)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev)

    for h, w, r, block in ((37, 53, 1, (16, 32)), (50, 29, 2, (8, 16)),
                           (61, 45, 4, (32, 256)), (203, 301, 4, (32, 64))):
        wts = tuple(float(x) for x in fd_second_derivative_weights(r))
        u1, u2 = rnd(h, w), rnd(h, w)
        dx = 2.0 / w
        dt = 0.5 * dx / 2 ** 0.5
        check_close(f"fd2d f32 ({h},{w}) r={r} tile {block}",
                    fd2d(u1, u2, weights=wts, dx=dx, dt=dt, block=block),
                    fd2d_ref(u1, u2, wts, dx, dt), atol=2e-5, rtol=2e-5)
    for E, nq, eb in ((7, 2, 4), (13, 5, 4), (37, 8, 32), (70, 8, 32)):
        u, geo, dmat = rnd(E, nq, nq, nq), rnd(E, 7, nq, nq, nq), rnd(nq, nq)
        check_rel(f"sem_apply f32 E={E} nq={nq} eb={eb}",
                  sem_apply(u, geo, dmat, eb=eb), apply_ref(u, geo, dmat),
                  2e-4)
    for n, E, eb in ((1, 37, 8), (3, 50, 16), (5, 131, 64), (5, 10, 64)):
        np_, nfp3 = (n + 1) * (n + 2) // 2, 3 * (n + 1)
        q = 0.1 * rnd(E, np_, 3)
        q[..., 0] += 1.5
        geom, db, dr, ds = rnd(E, 4), rnd(E, np_, 2), rnd(np_, np_), rnd(
            np_, np_)
        check_rel(f"dg_volume f32 N={n} E={E} eb={eb}",
                  dg_volume(q, geom, db, dr, ds, eb=eb),
                  volume_ref(q, geom, db, dr, ds), 2e-4)
        qm, qp = 0.1 * rnd(E, nfp3, 3), 0.1 * rnd(E, nfp3, 3)
        qm[..., 0] += 1.5
        qp[..., 0] += 1.5
        theta = rnd(E, nfp3)
        nrm = torch.stack([theta.cos(), theta.sin(), rnd(E, nfp3).abs()],
                          -1).contiguous()
        lift = rnd(np_, nfp3)
        check_rel(f"dg_surface f32 N={n} E={E} eb={eb}",
                  dg_surface(qm, qp, nrm, lift, eb=eb),
                  surface_ref(qm, qp, nrm, lift), 2e-4)
    torch.cuda.synchronize()


def _host_ms(fn, n, warmup=0):
    """Host ms per call of ``fn`` over ``n`` calls after ``warmup`` untimed
    ones, card synchronized."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def apps_main_path(dev):
    """Drive the three apps once through their entry points at full size.
    Launch counts are zeroed just before and read just after. Returns
    (counts, expected counts, state for the later phases)."""
    import numpy as np
    import torch

    from repro_torch.apps.fd2d import FDWave, fd_flops_per_step
    from repro_torch.apps.sem import SEMOperator, sem_flops_per_element
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.launch import apps

    torch.cuda.synchronize()
    reset_launches()
    t_phase = time.perf_counter()

    # FD: 8192^2, radius 4 (8th order), 200 leapfrog steps
    t0 = time.perf_counter()
    fd = FDWave(width=FD_SIZE, height=FD_SIZE, radius=FD_RADIUS)
    setup_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fd.run(FD_STEPS)                      # synchronizes the card
    wall = time.perf_counter() - t0
    err = float(np.abs(fd.solution - fd.analytic()).max())
    n2 = FD_SIZE * FD_SIZE
    log(f"[fd] {FD_SIZE}x{FD_SIZE}, radius {FD_RADIUS}, tile {fd.block}, "
        f"{FD_STEPS} steps to t={fd.current_time:.5f}: {wall:.3f}s = "
        f"{1e3 * wall / FD_STEPS:.4f} ms/step, "
        f"{n2 * FD_STEPS / wall / 1e6:.1f} MNodes/s, "
        f"{fd_flops_per_step(FD_SIZE, FD_SIZE, FD_RADIUS) * FD_STEPS / wall / 1e9:.1f}"
        f" GFLOP/s; max|u - analytic| {err:.3e} (setup {setup_s:.1f}s)")
    if not err < 5e-2:
        fail(f"FD wave at full size diverged: max|err| {err:.3e}")
    apps.fd_wave(size=256, steps=200, log=log)

    # SEM: 32^3 elements, N = 7, deformed box
    t0 = time.perf_counter()
    op = SEMOperator(ex=SEM_ELEMS, ey=SEM_ELEMS, ez=SEM_ELEMS, n=SEM_N)
    setup_s = time.perf_counter() - t0
    nq = op.nq
    gen = torch.Generator(device=dev).manual_seed(9)
    u_loc = torch.randn((op.E, nq, nq, nq), generator=gen, device=dev)
    u_glob = torch.randn((op.nglob,), generator=gen, device=dev)
    flops = sem_flops_per_element(nq) * op.E
    local_ms = _host_ms(lambda: op.apply_local(u_loc), SEM_REPEATS, 1)
    global_ms = _host_ms(lambda: op.apply_global(u_glob), SEM_REPEATS, 1)
    au = op.apply_global(u_glob)
    if not bool(torch.isfinite(au).all()):
        fail("SEM apply_global gave non-finite values")
    log(f"[sem] E={op.E} ({SEM_ELEMS}^3), N={SEM_N}, eb={op.eb}, dofs={op.nglob}: "
        f"apply_local {local_ms:.4f} ms = {flops / local_ms / 1e6:.1f} "
        f"GFLOP/s, apply_global {global_ms:.4f} ms = "
        f"{flops / global_ms / 1e6:.1f} GFLOP/s (host clock, mean of "
        f"{SEM_REPEATS} after one warm call; setup {setup_s:.1f}s)")
    solve = apps.sem_solve(n=SEM_N, elems=8, log=log)
    solve["global_ms"] = _host_ms(lambda: solve["op"].apply_global(
        solve["u"]), SEM_REPEATS, 1)
    log(f"[sem] apply_global at the solve's size (E={solve['op'].E}): "
        f"{solve['global_ms']:.4f} ms host")

    # DG: nx = ny = 256 (131072 triangles), N = 5, 100 LSERK steps
    t0 = time.perf_counter()
    swe = apps.swe_run(nx=DG_NX, n=DG_N, steps=DG_STEPS, log=log)
    log(f"[swe] whole run with setup {time.perf_counter() - t0:.1f}s; dt "
        f"= 0.5 * hmin / ((N+1)^2 * cmax) = {swe['dt']:.6e}")

    torch.cuda.synchronize()
    counts = launch_counts()
    log(f"[apps] main path {time.perf_counter() - t_phase:.1f}s")
    expected = {"fd2d": FD_STEPS + 200,
                "sem_apply": 3 * (SEM_REPEATS + 1) + 1 + 1 + solve["iters"],
                "dg_volume": 5 * DG_STEPS, "dg_surface": 5 * DG_STEPS}
    for name, want in expected.items():
        if counts[name] != want:
            fail(f"kernel {name} launched {counts[name]} times on the apps "
                 f"path, expected {want}")
    return counts, dict(fd=fd, op=op, u_loc=u_loc, u_glob=u_glob, swe=swe)


def sem_global_breakdown(op, u_glob):
    """Where ``apply_global``'s time goes, on CUDA events: the gather of
    local dofs, the kernel, the ``index_add_`` scatter, and the whole; and,
    beside the scatter, two other PyTorch calls that compute the same sum
    (``scatter_add_``, ``index_put_`` with accumulate), which the port does
    not use."""
    import torch

    from repro_torch.apps.sem import gather, scatter_add
    from repro_torch.kernels.apps import sem_apply

    u_loc = gather(u_glob, op.gid_t)
    au = sem_apply(u_loc, op.geo, op.dmat, eb=op.eb)
    gid, flat = op.gid_t.reshape(-1), au.reshape(-1)
    zeros = lambda: torch.zeros(op.nglob, device=au.device)  # noqa: E731
    parts = dict(
        gather=cuda_ms(lambda: gather(u_glob, op.gid_t), 10),
        kernel=cuda_ms(lambda: sem_apply(u_loc, op.geo, op.dmat, eb=op.eb),
                       10),
        scatter=cuda_ms(lambda: scatter_add(au, op.gid_t, op.nglob), 10),
        whole=cuda_ms(lambda: op.apply_global(u_glob), 10),
        scatter_add_=cuda_ms(lambda: zeros().scatter_add_(0, gid, flat), 10),
        index_put_=cuda_ms(lambda: zeros().index_put_((gid,), flat,
                                                      accumulate=True), 10))
    log(f"[sem] apply_global (E={op.E}, N={op.n}) on CUDA events: "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in parts.items()))
    return parts


def profile_swe_step(sol, Q, dt, nsteps=5):
    """Where an LSERK step's time goes: ``nsteps`` steps on the host clock,
    then under ``torch.profiler`` (device-side events only)."""
    from torch.profiler import ProfilerActivity, profile

    def run():
        nonlocal Q
        for _ in range(nsteps):
            Q = sol.step(Q, dt)

    run()                                                    # warm
    step_ms = _host_ms(run, 1) / nsteps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prof_ms = _host_ms(run, 1) / nsteps
    rows = device_rows(prof, nsteps)
    busy_ms = sum(r[0] for r in rows)
    log(f"[profile swe] LSERK step (E={sol.E}, N={sol.n}, 5 stages): host "
        f"{step_ms:.4f} ms/step ({prof_ms:.4f} under the profiler); device "
        f"busy {busy_ms:.4f} ms/step = {100 * busy_ms / step_ms:.1f}% of "
        f"the unprofiled step, idle {100 * (1 - busy_ms / step_ms):.1f}%")
    for ms, n, key in rows[:12]:
        log(f"[profile swe]   {ms:8.4f} ms/step  {n:4d} calls/step  "
            f"{key[:90]}")
    return step_ms, busy_ms


def _app_inputs(state, *, perturbed=False):
    """The app kernels' inputs at the main path's shapes: the FD fields
    after 200 steps, a random SEM field on the 32^3 mesh, the SWE state
    after 100 steps and its face traces. ``perturbed`` replaces the SWE
    state by a seeded random one on the same mesh (h = 1.5 + 0.1 N(0,1),
    momenta 0.3 N(0,1)) and the flat bottom's zero bathymetry gradient by
    a random one (50 N(0,1)), so that the source term carries weight."""
    import torch

    fd, op, sol, Q = state["fd"], state["op"], state["swe"]["solver"], \
        state["swe"]["Q"]
    db = sol.db
    if perturbed:
        g = torch.Generator(device=Q.device).manual_seed(10)
        Q = torch.randn(Q.shape, generator=g, device=Q.device) * torch.tensor(
            [0.1, 0.3, 0.3], device=Q.device)
        Q[..., 0] += 1.5
        db = 50 * torch.randn(db.shape, generator=g, device=db.device)
    QM, QP = sol.traces(Q)
    return dict(fd=(fd.u1, fd.u2, fd.weights, fd.dx, fd.dt, fd.block),
                sem=(state["u_loc"], op.geo, op.dmat, op.eb),
                vol=(Q, sol.geom, db, sol.dr, sol.ds, sol.eb),
                surf=(QM, QP, sol.nrm, sol.lift, sol.eb))


def _volume_terms_abs(Q, geom, dB, Dr, Ds, g):
    """For each output of the DG volume RHS, the sum of the absolute values
    of the terms it is summed from (f64): the scale of its f32 rounding."""
    import torch

    h, hu, hv = Q[..., 0], Q[..., 1], Q[..., 2]
    u, v = hu / h, hv / h
    gh2 = 0.5 * g * h * h
    F = torch.stack([hu.abs(), (hu * u).abs() + gh2, (hu * v).abs()], -1)
    G = torch.stack([hv.abs(), (hu * v).abs(), (hv * v).abs() + gh2], -1)
    a = geom.abs()[:, :, None, None]
    dr, ds = Dr.abs(), Ds.abs()
    mag = (a[:, 0] * torch.einsum("nm,emf->enf", dr, F)
           + a[:, 1] * torch.einsum("nm,emf->enf", ds, F)
           + a[:, 2] * torch.einsum("nm,emf->enf", dr, G)
           + a[:, 3] * torch.einsum("nm,emf->enf", ds, G))
    src = torch.stack([torch.zeros_like(h), g * h * dB[..., 0].abs(),
                       g * h * dB[..., 1].abs()], -1)
    return mag + src


def _surface_terms_abs(QM, QP, nrm, lift, g):
    """The same for the DG surface RHS: |lift| applied to the absolute
    terms of (FM - f*) fscale."""
    import torch

    nx_, ny_, fsc = nrm[..., 0].abs(), nrm[..., 1].abs(), nrm[..., 2].abs()

    def flux_abs(Q):
        h, hu, hv = Q[..., 0], Q[..., 1], Q[..., 2]
        u, v = hu / h, hv / h
        gh2 = 0.5 * g * h * h
        Fn = torch.stack([hu.abs() * nx_ + hv.abs() * ny_,
                          ((hu * u).abs() + gh2) * nx_ + (hu * v).abs() * ny_,
                          (hu * v).abs() * nx_ + ((hv * v).abs() + gh2) * ny_],
                         -1)
        return Fn, u.abs() * nx_ + v.abs() * ny_ + torch.sqrt(g * h)

    FM, lamM = flux_abs(QM)
    FP, lamP = flux_abs(QP)
    C = torch.maximum(lamM, lamP)[..., None]
    d = (1.5 * FM + 0.5 * FP + 0.5 * C * (QM.abs() + QP.abs())) * fsc[..., None]
    return torch.einsum("nf,efq->enq", lift.abs(), d)


def check_rounding(name, outs, ref64, mag, rel):
    """Each of ``outs`` (name: f32 tensor) within ``rel * mag`` of the f64
    result ``ref64``, elementwise: for outputs that are cancelling sums,
    where an error that scales with the result cannot hold but one that
    scales with the summed terms can. ``rel`` = (terms per dot product +
    16) * 2^-24 is the worst-case rounding of such a sum in f32 (Higham's
    gamma_n) with room for the pointwise flux arithmetic; a wrong index or
    term errs by the size of the terms, ~1/rel times more."""
    import torch

    bound_ = rel * mag
    worst = {}
    for label, got in outs.items():
        if not torch.isfinite(got).all():
            fail(f"{name} ({label}): non-finite values")
        err = (got.double() - ref64).abs()
        bad = err > bound_
        if bad.any():
            fail(f"{name} ({label}): {int(bad.sum())} of {err.numel()} "
                 f"elements beyond {rel:.2e} of their summed |terms| (max "
                 f"|err| {float(err.max()):.3e})")
        worst[label] = (float(err.max()),
                        float((err / bound_.clamp_min(1e-300)).max()))
    log(f"[check] {name}: max|ref| {float(ref64.abs().max()):.3e}, max "
        f"summed |terms| {float(mag.max()):.3e}; vs the f64 result "
        + ", ".join(f"{k} max|err| {e:.3e} ({100 * r:.1f}% of its bound)"
                    for k, (e, r) in worst.items()) + f" (rel {rel:.2e})")


def full_size_app_checks(state):
    """Each app kernel against its plain version at the main path's
    shapes and meshes. Returns {kernel: max |err|}. The DG kernels are
    held twice. On a random state with a random bathymetry gradient, kernel
    and plain version agree within 2e-4 of max|ref|. On the main path's own
    state after 100 steps, close to rest on a flat bottom, each output
    (|ref| < 4) is the cancelling sum of terms near 1e5 (rx ~ 256 times Dr
    F), so there both the kernel and the plain version are held against
    the plain version in f64, within the f32 rounding bound of the summed
    |terms| (``check_rounding``)."""
    import torch

    from repro_torch.kernels.apps import (GRAV, apply_ref, dg_surface,
                                          dg_volume, fd2d, fd2d_ref,
                                          sem_apply, surface_ref, volume_ref)

    a = _app_inputs(state, perturbed=True)
    u1, u2, wts, dx, dt, block = a["fd"]
    errs = {"fd2d": check_close(
        f"fd2d f32 {tuple(u1.shape)} r={(len(wts) - 1) // 2}",
        fd2d(u1, u2, weights=wts, dx=dx, dt=dt, block=block),
        fd2d_ref(u1, u2, wts, dx, dt), atol=2e-5, rtol=2e-5)}
    u, geo, dmat, eb = a["sem"]
    errs["sem_apply"] = check_rel(f"sem_apply f32 {tuple(u.shape)} eb={eb}",
                                  sem_apply(u, geo, dmat, eb=eb),
                                  apply_ref(u, geo, dmat), 2e-4)
    *args, eb = a["vol"]
    errs["dg_volume"] = check_rel(f"dg_volume f32 {tuple(args[0].shape)}"
                                  " (random state and bathymetry)",
                                  dg_volume(*args, eb=eb), volume_ref(*args),
                                  2e-4)
    *args, eb = a["surf"]
    errs["dg_surface"] = check_rel(f"dg_surface f32 {tuple(args[0].shape)}"
                                   " (random state)",
                                   dg_surface(*args, eb=eb),
                                   surface_ref(*args), 2e-4)

    m = _app_inputs(state)
    *args, eb = m["vol"]
    np_ = args[0].shape[1]
    a64 = [t.double() for t in args]
    check_rounding(f"dg_volume {tuple(args[0].shape)} (main path state)",
                   dict(kernel=dg_volume(*args, eb=eb),
                        plain=volume_ref(*args)),
                   volume_ref(*a64), _volume_terms_abs(*a64, GRAV),
                   (np_ + 16) * 2.0 ** -24)
    *args, eb = m["surf"]
    nfp3 = args[0].shape[1]
    a64 = [t.double() for t in args]
    check_rounding(f"dg_surface {tuple(args[0].shape)} (main path state)",
                   dict(kernel=dg_surface(*args, eb=eb),
                        plain=surface_ref(*args)),
                   surface_ref(*a64), _surface_terms_abs(*a64, GRAV),
                   (nfp3 + 16) * 2.0 ** -24)
    torch.cuda.synchronize()
    return errs


def time_app_kernels(state):
    """{kernel: dict(ms, plain_ms, bound_ms, bound_by, library_ms)} for the
    app kernels at the main path's shapes (f32)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.apps.dg_swe import (dg_bytes_per_element,
                                         dg_flops_per_element,
                                         dg_surface_bytes_per_element,
                                         dg_surface_flops_per_element)
    from repro_torch.apps.fd2d import fd_flops_per_step
    from repro_torch.apps.sem import (sem_bytes_per_element,
                                      sem_flops_per_element)
    from repro_torch.kernels.apps import (apply_ref, dg_surface, dg_volume,
                                          fd2d, fd2d_ref, sem_apply,
                                          surface_ref, volume_ref)

    a = _app_inputs(state)
    out = {}
    u1, u2, wts, dx, dt, block = a["fd"]
    h, w = u1.shape
    r = (len(wts) - 1) // 2
    u3 = torch.empty_like(u1)
    cross = torch.zeros((1, 1, 2 * r + 1, 2 * r + 1), device=u1.device)
    cross[0, 0, r, :] += torch.tensor(wts, device=u1.device)
    cross[0, 0, :, r] += torch.tensor(wts, device=u1.device)
    scale = float(torch.tensor(dt * dt, dtype=torch.float32)) * float(
        torch.tensor(1.0 / (dx * dx), dtype=torch.float32))

    def library_fd():
        pad = F.pad(u1[None, None], (r, r, r, r), mode="circular")
        return 2.0 * u1 - u2 + scale * F.conv2d(pad, cross)[0, 0]

    out["fd2d"] = dict(
        ms=cuda_ms(lambda: fd2d(u1, u2, weights=wts, dx=dx, dt=dt,
                                block=block, out=u3), 50),
        plain_ms=cuda_ms(lambda: fd2d_ref(u1, u2, wts, dx, dt), 5, 1),
        library_ms=cuda_ms(library_fd, 10),
        library="F.conv2d of the circular-padded field with the cross "
                "filter (cuDNN, TF32 off) + the update",
        shape=f"u1/u2/u3 ({h},{w}) f32, r={r}, tile {block}")
    out["fd2d"].update(zip(("bound_ms", "bound_by"), bound(
        3 * h * w * 4, fd_flops_per_step(w, h, r), "float32")))

    none = "none: no single PyTorch call computes it"
    u, geo, dmat, eb = a["sem"]
    E, nq = u.shape[0], u.shape[1]
    out["sem_apply"] = dict(
        ms=cuda_ms(lambda: sem_apply(u, geo, dmat, eb=eb), 20),
        plain_ms=cuda_ms(lambda: apply_ref(u, geo, dmat), 5, 1),
        library_ms=None, library=none,
        shape=f"u ({E},{nq},{nq},{nq}), geo ({E},7,...) f32, eb={eb}")
    out["sem_apply"].update(zip(("bound_ms", "bound_by"), bound(
        sem_bytes_per_element(nq, 4) * E, sem_flops_per_element(nq) * E,
        "float32")))

    *args, eb = a["vol"]
    E, np_ = args[0].shape[0], args[0].shape[1]
    out["dg_volume"] = dict(
        ms=cuda_ms(lambda: dg_volume(*args, eb=eb), 50),
        plain_ms=cuda_ms(lambda: volume_ref(*args), 10),
        library_ms=None, library=none,
        shape=f"q ({E},{np_},3), geom ({E},4), db ({E},{np_},2) f32, "
              f"eb={eb}")
    out["dg_volume"].update(zip(("bound_ms", "bound_by"), bound(
        dg_bytes_per_element(np_, 4) * E, dg_flops_per_element(np_) * E,
        "float32")))

    *args, eb = a["surf"]
    nfp3 = args[0].shape[1]
    out["dg_surface"] = dict(
        ms=cuda_ms(lambda: dg_surface(*args, eb=eb), 50),
        plain_ms=cuda_ms(lambda: surface_ref(*args), 10),
        library_ms=None, library=none,
        shape=f"qm/qp/nrm ({E},{nfp3},3), lift ({np_},{nfp3}) f32, eb={eb}")
    out["dg_surface"].update(zip(("bound_ms", "bound_by"), bound(
        dg_surface_bytes_per_element(np_, nfp3, 4) * E,
        dg_surface_flops_per_element(np_, nfp3) * E, "float32")))
    return out


# ---------------------------------------------------------------------------
# the static path: windowed caches, musicgen_medium and falcon_mamba_7b
# ---------------------------------------------------------------------------

def _two_layer_pair(arch, **changes):
    """(CPU model, its params, card model, the same params on the card) of
    ``arch`` at full width with 2 layers in f32."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import LM, tree_to

    cfg = dataclasses.replace(get_config(arch), n_layers=2, dtype="float32",
                              **changes)
    cpu, gpu = LM(cfg, device="cpu"), LM(cfg)
    p_cpu = cpu.init(torch.Generator().manual_seed(12))
    return cpu, p_cpu, gpu, tree_to(p_cpu, gpu.device)


def two_layer_static_f32_checks():
    """2-layer f32 models at full width, one set of weights on the card
    (kernels) and on the CPU (plain versions): ``generate`` must give the
    same tokens on both and the prefill and decode logits agree within
    1e-3 (f32 sums in other orders over d <= 8192 terms). musicgen_medium
    and falcon_mamba_7b take the static path; llama3_2_1b with a window of
    64 decodes 80 tokens after a 200-token prompt (the rolling cache wraps),
    and without a window its static tokens must equal the engine's;
    internlm2_1_8b (head_dim 128) runs prefill and the engine."""
    import numpy as np
    import torch

    from repro_torch.launch.serve import generate

    tol = dict(atol=1e-3, rtol=1e-3)
    runs = (("musicgen_medium", {}, 2, 32, 16),
            ("falcon_mamba_7b", {}, 2, 32, 16),
            ("llama3_2_1b", dict(window=64), 2, 200, 80))
    for arch, changes, b, plen, ngen in runs:
        cpu, p_cpu, gpu, p_gpu = _two_layer_pair(arch, **changes)
        vocab = cpu.cfg.vocab_size
        prompts = np.random.RandomState(7).randint(1, vocab, (b, plen))
        tag = f"2-layer f32 {arch} {changes or ''}".strip()
        if cpu.pageable or gpu.pageable:
            fail(f"{tag}: expected an unpageable model")
        toks = torch.from_numpy(prompts)
        lc, cc = cpu.prefill(p_cpu, toks, max_len=plen + ngen)
        lg, cg = gpu.prefill(p_gpu, toks.to(gpu.device), max_len=plen + ngen)
        check_close(f"{tag} prefill logits, card vs CPU", lg.cpu(), lc, **tol)
        nxt = cpu.greedy_token(lc)[:, None]
        lc, _ = cpu.decode_step(p_cpu, nxt, cc)
        lg, _ = gpu.decode_step(p_gpu, nxt.to(gpu.device), cg)
        check_close(f"{tag} decode logits, card vs CPU", lg.cpu(), lc, **tol)
        outs = [generate(m, p, prompts, gen_tokens=ngen)
                for m, p in ((cpu, p_cpu), (gpu, p_gpu))]
        if outs[1][1]["engine"] or not np.array_equal(outs[0][0],
                                                      outs[1][0]):
            fail(f"{tag}: static tokens CPU {outs[0][0].tolist()} != card "
                 f"{outs[1][0].tolist()}")
        log(f"[2-layer f32] {tag}: {ngen} static tokens agree, card == CPU "
            f"(first row {outs[1][0][0, :12].tolist()})")
        del cpu, p_cpu, gpu, p_gpu, cc, cg

    cpu, p_cpu, gpu, p_gpu = _two_layer_pair("llama3_2_1b")
    prompts = np.random.RandomState(8).randint(1, cpu.cfg.vocab_size, (2, 40))
    static, _ = generate(gpu, p_gpu, prompts, gen_tokens=8, engine="static")
    paged, _ = generate(gpu, p_gpu, prompts, gen_tokens=8, engine="paged",
                        page_size=16)
    if not np.array_equal(static, paged):
        fail(f"llama3_2_1b 2-layer f32: static tokens {static.tolist()} != "
             f"engine tokens {paged.tolist()}")
    log(f"[2-layer f32] llama3_2_1b: static tokens == engine tokens on the "
        f"card ({static[0].tolist()})")
    del cpu, p_cpu, gpu, p_gpu

    # head_dim 128 on the card: prefill (flash_fwd) and the engine
    # (paged_decode), card vs CPU
    cpu, p_cpu, gpu, p_gpu = _two_layer_pair("internlm2_1_8b")
    prompts = np.random.RandomState(9).randint(1, cpu.cfg.vocab_size, (2, 40))
    toks = torch.from_numpy(prompts)
    lc, _ = cpu.prefill(p_cpu, toks)
    lg, _ = gpu.prefill(p_gpu, toks.to(gpu.device))
    check_close("2-layer f32 internlm2_1_8b (head_dim 128) prefill logits, "
                "card vs CPU", lg.cpu(), lc, **tol)
    outs = [generate(m, p, prompts, gen_tokens=8, page_size=16)[0]
            for m, p in ((cpu, p_cpu), (gpu, p_gpu))]
    if not np.array_equal(*outs):
        fail(f"internlm2_1_8b engine tokens: CPU {outs[0].tolist()} != card "
             f"{outs[1].tolist()}")
    log(f"[2-layer f32] internlm2_1_8b (head_dim 128): engine tokens agree, "
        f"card == CPU ({outs[1][0].tolist()})")


def _full_model(arch, seed):
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import LM

    model = LM(get_config(arch))
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=model.device).manual_seed(seed))
    torch.cuda.synchronize()
    log(f"[model] {arch} bf16: {model.param_count(params)} parameters, init "
        f"{time.perf_counter() - t0:.1f}s")
    return model, params


def _static_run(model, params, prompts, ngen):
    """``generate`` once, launch counts zeroed just before and read just
    after; every token in the vocab, and the path static."""
    import torch

    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.launch.serve import generate

    torch.cuda.synchronize()
    reset_launches()
    out, stats = generate(model, params, prompts, gen_tokens=ngen)
    torch.cuda.synchronize()
    counts = launch_counts()
    check_tc_routes(f"{model.cfg.name} static path: flash_fwd",
                    flash_attention_fwd.routes, counts["flash_fwd"])
    if stats["engine"] or out.shape != (prompts.shape[0], ngen):
        fail(f"{model.cfg.name}: generate took the engine or returned "
             f"{out.shape}")
    if not ((out >= 0) & (out < model.cfg.vocab_size)).all():
        fail(f"{model.cfg.name}: tokens out of vocab")
    return out, stats, counts


def profile_static_step(model, params, prompts, nsteps=8):
    """Where a static decode step's time goes: prefill, two warm
    ``greedy_step``s, then ``nsteps`` on the host clock and under
    ``torch.profiler`` (device-side events only)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    dev = model.device
    toks = torch.from_numpy(prompts).to(dev)
    with torch.no_grad():
        logits, cache = model.prefill(params, toks,
                                      max_len=toks.shape[1] + 4 * nsteps)
        tok = model.greedy_token(logits)[:, None]

        def run():
            nonlocal tok, cache
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(nsteps):
                nxt, _, cache = model.greedy_step(params, tok, cache)
                tok = nxt[:, None]
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3 / nsteps

        for _ in range(2):
            model.greedy_step(params, tok, cache)
        step_ms = run()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            prof_ms = run()
    rows = device_rows(prof, nsteps)
    busy_ms = sum(r[0] for r in rows)
    name = model.cfg.name
    log(f"[profile {name}] decode step (B={prompts.shape[0]}, "
        f"{model.cfg.n_layers} layers): host {step_ms:.3f} ms/step "
        f"({prof_ms:.3f} under the profiler); device busy {busy_ms:.3f} "
        f"ms/step = {100 * busy_ms / step_ms:.1f}% of the unprofiled step, "
        f"idle {100 * (1 - busy_ms / step_ms):.1f}%")
    for ms, n, key in rows[:12]:
        log(f"[profile {name}]   {ms:8.4f} ms/step  {n:4d} calls/step  "
            f"{key[:90]}")
    return step_ms, busy_ms


def musicgen_main_path():
    """musicgen_medium in bf16 at full width through ``generate`` (the
    static path: sinusoidal positions are not pageable): 8 prompts of 512
    tokens, 64 new tokens. flash_decode must launch 48 x 64 times. Then
    where a decode step's time goes, and prefill with 16 conditioning
    frames + decode_step against forward. Returns (counts, model, params,
    stats)."""
    import numpy as np
    import torch

    model, params = _full_model("musicgen_medium", 21)
    cfg = model.cfg
    b, plen, ngen = MG_BATCH, MG_PROMPT, MG_GEN
    prompts = np.random.RandomState(21).randint(0, cfg.vocab_size, (b, plen))
    out, stats, counts = _static_run(model, params, prompts, ngen)
    want = cfg.n_layers * ngen
    if counts["flash_decode"] != want or counts["flash_fwd"] != cfg.n_layers:
        fail(f"musicgen: flash_decode launched {counts['flash_decode']} "
             f"times (want {cfg.n_layers} x {ngen} = {want}), flash_fwd "
             f"{counts['flash_fwd']} (want {cfg.n_layers})")
    for name in ("rmsnorm", "lm_head"):
        if counts[name] <= 0:
            fail(f"musicgen: kernel {name} never launched")
    log("musicgen static path kernels: " + ", ".join(
        f"{k}={counts[k]}" for k in ("flash_decode", "flash_fwd", "rmsnorm",
                                     "lm_head")))
    log(f"[musicgen] generate B={b} prompt={plen} new={ngen}: prefill "
        f"{stats['prefill_s'] * 1e3:.3f} ms, decode {stats['decode_s']:.3f}s"
        f" = {stats['decode_s'] * 1e3 / ngen:.3f} ms/step, "
        f"{stats['tokens_per_s']:.1f} tok/s; first row {out[0, :12].tolist()}")
    step_ms, busy_ms = profile_static_step(model, params, prompts)

    # the audio-conditioning prefix: prefill + one decode step against the
    # full forward over the same sequence. Both paths round the residual
    # stream to bf16 at every layer but attend with different kernels
    # (flash_fwd vs flash_decode), so 48 layers of bf16 rounding separate
    # them: held to 5% of the largest logit (atol) and 5% relative
    gen = torch.Generator(device=model.device).manual_seed(22)
    pre = torch.randn((2, cfg.num_prefix_embeddings, cfg.d_model),
                      generator=gen, device=model.device).to(model.dtype)
    toks = torch.from_numpy(prompts[:2, :65]).to(model.device)
    with torch.no_grad():
        full, _ = model.forward(params, toks, prefix_embeddings=pre)
        lp, cache = model.prefill(params, toks[:, :64], prefix_embeddings=pre,
                                  max_len=96)
        ld, cache = model.decode_step(params, toks[:, 64:], cache)
    if cache["pos"] != cfg.num_prefix_embeddings + 65:
        fail(f"musicgen prefix: cache pos {cache['pos']}")
    rel = 0.05
    check_rel("musicgen bf16 prefill(prefix) logits vs forward", lp,
              full[:, -2], rel)
    check_rel("musicgen bf16 prefill(prefix) + decode_step logits vs "
              "forward", ld, full[:, -1], rel)
    stats.update(step_ms=step_ms, busy_ms=busy_ms)
    return counts, model, params, stats


def falcon_main_path():
    """falcon_mamba_7b in bf16 at full width: ``generate`` (static) on 4
    prompts of 512 tokens, 32 new tokens, with ssm_scan launched once per
    layer by the prefill; ``forward`` on B = 1, S = 2048 (64 launches), and
    its last-position logits against ``prefill``'s on the same tokens (the
    stateless and state-returning forms of the scan). Returns (counts,
    model, params, stats)."""
    import numpy as np
    import torch

    from repro_torch.kernels import launch_counts, reset_launches

    model, params = _full_model("falcon_mamba_7b", 31)
    cfg = model.cfg
    b, plen, ngen = FM_BATCH, FM_PROMPT, FM_GEN
    prompts = np.random.RandomState(31).randint(0, cfg.vocab_size, (b, plen))
    out, stats, counts = _static_run(model, params, prompts, ngen)
    if counts["ssm_scan"] != cfg.n_layers:
        fail(f"falcon: ssm_scan launched {counts['ssm_scan']} times in "
             f"generate (want one per layer of the prefill, {cfg.n_layers})")
    log("falcon static path kernels: " + ", ".join(
        f"{k}={counts[k]}" for k in ("ssm_scan", "rmsnorm", "lm_head")))
    log(f"[falcon] generate B={b} prompt={plen} new={ngen}: prefill "
        f"{stats['prefill_s'] * 1e3:.3f} ms, decode {stats['decode_s']:.3f}s"
        f" = {stats['decode_s'] * 1e3 / ngen:.3f} ms/step, "
        f"{stats['tokens_per_s']:.1f} tok/s; first row {out[0, :12].tolist()}")
    step_ms, busy_ms = profile_static_step(model, params, prompts)

    toks = torch.from_numpy(np.random.RandomState(32).randint(
        0, cfg.vocab_size, (1, FM_FWD_SEQ))).to(model.device)
    with torch.no_grad():
        model.forward(params, toks[:, :64])                  # warm
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        full, _ = model.forward(params, toks)
        torch.cuda.synchronize()
        fwd_ms = (time.perf_counter() - t0) * 1e3
        fcounts = launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lp, _ = model.prefill(params, toks)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
    if fcounts["ssm_scan"] != cfg.n_layers:
        fail(f"falcon forward: ssm_scan launched {fcounts['ssm_scan']} "
             f"times (want {cfg.n_layers})")
    if not torch.isfinite(full).all():
        fail("falcon forward: non-finite logits")
    # the same kernel and the same bf16 ops on both sides: equal up to the
    # LM head's row count (1e-3 covers its f32 sums in another order)
    check_close("falcon bf16 forward vs prefill last-position logits",
                lp, full[:, -1], atol=1e-3, rtol=1e-3)
    log(f"[falcon] forward B=1 S={FM_FWD_SEQ}: {fwd_ms:.3f} ms "
        f"(ssm_scan x{fcounts['ssm_scan']}); prefill of the same tokens "
        f"{prefill_ms:.3f} ms")
    stats.update(step_ms=step_ms, busy_ms=busy_ms, fwd_ms=fwd_ms,
                 prefill_ms=prefill_ms)
    return counts, model, params, stats


def full_width_static_checks(dev):
    """flash_decode at musicgen's decode shape and ssm_scan at falcon's
    forward shape, in bf16 (delta f32, as the model feeds it), against
    their plain versions. Returns {kernel: max |err|}."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import decode_ref, flash_decode
    from repro_torch.kernels.ssm_scan import selective_scan_ref, ssm_scan_fwd

    gen = torch.Generator(device=dev).manual_seed(23)
    errs = {}
    q, k, v, kv_len = _decode_inputs(dev, gen, 1)
    k, v = k[0], v[0]
    # o averages hundreds of randn rows, so |o| <~ 0.3: both sides round o
    # to bf16 (one ulp apart at most, <= 2^-7 relative); the plain version
    # also rounds p to bf16 before p @ v (2^-9 relative per term, ~1e-4 in
    # o), which the absolute 1% of max|o| covers
    sp = torch.arange(k.shape[2], dtype=torch.int32, device=dev)
    sp = torch.roll(sp, 100)                 # a rotated window of 576
    for tag, kw in ((f"flash_decode bf16 {tuple(q.shape)} vs cache "
                     f"{tuple(k.shape)} kv_len={kv_len}", dict(kv_len=kv_len)),
                    ("flash_decode bf16 rotated, window 400",
                     dict(kv_len=700, slot_pos=sp, window=400))):
        ref = decode_ref(q, k, v, **kw)
        err = check_close(tag, flash_decode(q, k, v, **kw), ref,
                          atol=0.01 * float(ref.float().abs().max()),
                          rtol=2 ** -7)
        errs.setdefault("flash_decode", err)

    args = _scan_inputs(dev, gen, get_config("falcon_mamba_7b"))
    y, hT = ssm_scan_fwd(*args)
    ry, rhT = selective_scan_ref(*args)
    # y: one bf16 rounding each side (2^-8 relative) over f32 sums in
    # another order; hT f32: 1e-3 of its largest magnitude
    errs["ssm_scan"] = check_close(
        f"ssm_scan bf16 y {tuple(y.shape)}", y, ry, atol=1e-2, rtol=2 ** -7)
    check_rel("ssm_scan bf16 hT (f32)", hT, rhT, 1e-3)
    torch.cuda.synchronize()
    return errs


def _decode_inputs(dev, gen, nlayers):
    """q (B, H, 1, d) and ``nlayers`` caches k, v (B, H, m, d) in bf16 at
    musicgen's decode shape, with kv_len = m (the last step of the run)."""
    import torch

    from repro_torch.configs import get_config

    cfg = get_config("musicgen_medium")
    b, h, d = MG_BATCH, cfg.n_heads, cfg.resolved_head_dim
    m = MG_PROMPT + MG_GEN
    bf = torch.bfloat16
    q = torch.randn((b, h, 1, d), generator=gen, device=dev).to(bf)
    k = [torch.randn((b, h, m, d), generator=gen, device=dev).to(bf)
         for _ in range(nlayers)]
    v = [torch.randn((b, h, m, d), generator=gen, device=dev).to(bf)
         for _ in range(nlayers)]
    return q, k, v, m


def _scan_inputs(dev, gen, cfg, bt=1, L=FM_FWD_SEQ):
    """The scan's inputs at falcon's forward shape (B = 1, S = 2048; or bt
    rows of L steps): x, B, C bf16, delta f32 softplus-sized,
    A = -exp(log(1..n)), D = 1."""
    import torch

    bf = torch.bfloat16
    dm, n = cfg.resolved_d_inner, cfg.ssm_state
    x = torch.randn((bt, L, dm), generator=gen, device=dev).to(bf)
    delta = torch.nn.functional.softplus(
        torch.randn((bt, L, dm), generator=gen, device=dev) - 4)
    A = -torch.arange(1, n + 1, dtype=torch.float32,
                      device=dev).expand(dm, n).contiguous()
    B = torch.randn((bt, L, n), generator=gen, device=dev).to(bf)
    C = torch.randn((bt, L, n), generator=gen, device=dev).to(bf)
    D = torch.ones(dm, device=dev)
    return x, delta, A, B, C, D


def _paligemma_decode_inputs(dev, gen, nlayers):
    """q (B, 8, 1, 256) and ``nlayers`` caches k, v (B, 1, m, 256) in bf16:
    paligemma_3b's MQA decode at musicgen's batch and cache length."""
    import torch

    from repro_torch.configs import get_config

    cfg = get_config("paligemma_3b")
    b, h, hk, d = MG_BATCH, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    m = MG_PROMPT + MG_GEN
    bf = torch.bfloat16
    q = torch.randn((b, h, 1, d), generator=gen, device=dev).to(bf)
    k = [torch.randn((b, hk, m, d), generator=gen, device=dev).to(bf)
         for _ in range(nlayers)]
    v = [torch.randn((b, hk, m, d), generator=gen, device=dev).to(bf)
         for _ in range(nlayers)]
    return q, k, v, m


def decode_host_split(q, k, v, kv_len, n=2000):
    """Host microseconds of one flash_decode call and of its pieces, each
    run n times back to back on the host clock, as rmsnorm_host_split
    splits rmsnorm's: the checks (what the wrapper reads before it
    allocates), the split rule, the two torch.empty (o and the workspace),
    the stream handle, the ctypes call refused before its launch (b = 0),
    the ctypes call that launches both kernels; beside them SDPA's whole
    call on the same inputs."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash_decode, ops

    b, h, _, d = q.shape
    hk, skv = k.shape[1], k.shape[2]
    split, nsplit = ops.decode_split(b, hk, skv)
    lib, fn = ops._decode_entry()
    o = torch.empty_like(q)
    ws = torch.empty(b * h * nsplit * (d + 2), dtype=torch.float32,
                     device=q.device)
    st = _build.stream()
    mask = (torch.arange(skv, device=q.device) < kv_len)[None, None, None]

    def call(nb):
        return fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), None, None,
                  o.data_ptr(), ws.data_ptr(), nb, h, hk, skv, d, 1, kv_len,
                  0, split, d ** -0.5, q.stride(0), q.stride(1), k.stride(0),
                  k.stride(1), v.stride(0), v.stride(1), st)

    def checks():
        _build.on_cpu("flash_decode", q, k, v, None, None)
        ops._window("flash_decode", None)
        ops._decode_check("flash_decode", q, k, v, kv_len, None)

    def empties():
        torch.empty((b, h, 1, d), dtype=q.dtype, device=q.device)
        torch.empty(b * h * nsplit * (d + 2), dtype=torch.float32,
                    device=q.device)

    def per_call(f):
        return _host_ms(f, n) * 1e3

    if call(0) == 0:
        fail("flash_decode: the entry point launched with b = 0")
    return dict(
        whole=per_call(lambda: flash_decode(q, k, v, kv_len=kv_len)),
        checks=per_call(checks),
        split=per_call(lambda: ops.decode_split(b, hk, skv)),
        empty=per_call(empties),
        stream=per_call(_build.stream),
        ctypes=per_call(lambda: call(0)),
        ctypes_launch=per_call(lambda: call(b)),
        library=per_call(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask)))


# Hopper's special-function unit: 16 MUFU.EX2 a clock per SM, at the H100
# SXM's 1.98 GHz boost clock on 132 SMs (ssm_scan's exponentials)
EX2_PER_S = 16 * 132 * 1.98e9


def scan_bound(bt, L, dm, n, xbytes):
    """(bound ms, "bytes" or "operations") of ssm_scan: x, delta, y, B, C,
    A, D and hT once each, against its bt * L * dm * n exponentials at
    EX2_PER_S."""
    nbytes = (bt * L * dm * (2 * xbytes + 4) + 2 * bt * L * n * xbytes
              + dm * n * 4 + dm * 4 + bt * dm * n * 4)
    tb, te = nbytes / HBM_BPS, bt * L * dm * n / EX2_PER_S
    return max(tb, te) * 1e3, "bytes" if tb >= te else "operations"


def time_static_kernels(dev):
    """flash_decode at musicgen's decode shape (one step's 48 layers cycle
    through 8 caches, 226 MB, so L2 does not hold them) and at paligemma's
    (d = 256, g = 8; 24 caches, 113 MB), ssm_scan at falcon's forward and
    prefill shapes, beside their bounds, plain versions and library calls,
    with the device time alone of each and the host split of one
    flash_decode call."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import (decode_ref, decode_split,
                                                     flash_decode)
    from repro_torch.kernels.ssm_scan import selective_scan_ref, ssm_scan_fwd

    gen = torch.Generator(device=dev).manual_seed(24)
    out = {}
    for name, nl, inputs in (("flash_decode", 8, _decode_inputs),
                             ("flash_decode@d256", 24,
                              _paligemma_decode_inputs)):
        q, ks, vs, kv_len = inputs(dev, gen, nl)
        b, h, _, d = q.shape
        hk, m = ks[0].shape[1], ks[0].shape[2]
        it = iter(range(1 << 30))
        mask = (torch.arange(m, device=dev) < kv_len)[None, None, None]
        kl_dev = torch.tensor([kv_len], dtype=torch.int32, device=dev)

        def cycle(fn):
            def run():
                i = next(it) % nl
                return fn(ks[i], vs[i])
            return run

        kernel = cycle(lambda k, v: flash_decode(q, k, v, kv_len=kv_len))
        nbytes = 2 * b * hk * kv_len * d * 2 + 2 * b * h * d * 2
        out[name] = dict(
            ms=cuda_ms(kernel, iters=96),
            device_ms=device_ms(kernel, "flash_decode"),
            ms_dev_len=cuda_ms(cycle(lambda k, v: flash_decode(
                q, k, v, kv_len=kl_dev)), iters=96),
            plain_ms=cuda_ms(cycle(lambda k, v: decode_ref(q, k, v,
                                                           kv_len=kv_len)),
                             iters=24),
            library_ms=cuda_ms(cycle(
                lambda k, v: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, enable_gqa=hk != h)), iters=96),
            library="F.scaled_dot_product_attention(attn_mask bool)",
            bytes=nbytes, split=decode_split(b, hk, m),
            shape=f"q ({b},{h},1,{d}), k/v ({b},{hk},{m},{d}) bf16, "
                  f"kv_len {kv_len}")
        out[name].update(zip(("bound_ms", "bound_by"), bound(
            nbytes, 4 * b * h * kv_len * d, "bfloat16")))
        if name == "flash_decode":
            out[name]["host_us"] = decode_host_split(q, ks[0], vs[0], kv_len)
        del ks, vs

    cfg = get_config("falcon_mamba_7b")
    for name, bt, L in (("ssm_scan", 1, FM_FWD_SEQ),
                        ("ssm_scan@prefill", FM_BATCH, FM_PROMPT)):
        args = _scan_inputs(dev, gen, cfg, bt, L)
        dm, n = args[0].shape[2], cfg.ssm_state
        out[name] = dict(
            ms=cuda_ms(lambda: ssm_scan_fwd(*args), iters=10, warmup=2),
            device_ms=device_ms(lambda: ssm_scan_fwd(*args), "ssm_scan",
                                n=10),
            plain_ms=cuda_ms(lambda: selective_scan_ref(*args), iters=2,
                             warmup=1),
            library_ms=None,
            library="none: no single PyTorch call computes it",
            exps=bt * L * dm * n,
            shape=f"x ({bt},{L},{dm}) bf16, delta f32, B/C ({bt},{L},{n}) "
                  "bf16")
        out[name].update(zip(("bound_ms", "bound_by"),
                             scan_bound(bt, L, dm, n, 2)))
        del args
    return out


# ---------------------------------------------------------------------------
# the tensor-core routes of matmul, the CE backward, flash_fwd and the ring
# step backward
# ---------------------------------------------------------------------------

# library -> the SASS ops its tensor-core kernels must issue: wgmma (HGMMA)
# everywhere; TMA tensor loads (UTMALDG) in the GEMM mainloop's libraries,
# cp.async copies (LDGSTS) in the attention kernels'
TC_LIBS = {"matmul": ("HGMMA", "UTMALDG"), "lm_head_ce": ("HGMMA", "UTMALDG"),
           "lm_head": ("HGMMA", "UTMALDG"),
           "flash_fwd": ("HGMMA", "LDGSTS"), "flash_bwd": ("HGMMA", "LDGSTS"),
           "ring_flash": ("HGMMA", "LDGSTS"), "paged_decode": ("LDGSTS",),
           "flash_decode": ("LDGSTS",)}
# (library, a name in the kernel's mangled symbol) -> the ops that kernel
# alone must issue: the CE forward's tensor-core kernel (its epilogue's
# name), in a library whose backward has HGMMA anyway; the ring step's
# tensor-core forward (the shared forward of attn_fwd_sm90.cuh), beside the
# ring's tensor-core backward
TC_FUNCS = {("lm_head_ce", "CeStatsEpi"): ("HGMMA", "UTMALDG"),
            ("ring_flash", "fwd_tc_kernel"): ("HGMMA", "LDGSTS")}


def _sass_functions(sass):
    """{mangled name: its SASS} of cuobjdump --dump-sass output."""
    out, name = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            name = line.split("Function : ", 1)[1].strip()
            out[name] = []
        elif name is not None:
            out[name].append(line)
    return {k: "\n".join(v) for k, v in out.items()}


def tc_sass_check():
    """The tensor-core libraries as built must hold the ops of TC_LIBS in
    their SASS, and the kernels of TC_FUNCS theirs in their own: the design
    reached the tensor cores and its copy engine."""
    from repro_torch.kernels import _build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = {name: subprocess.run(
        [tool, "--dump-sass", _build._lib_path(name)], check=True,
        capture_output=True, text=True, timeout=300).stdout
        for name in TC_LIBS}
    for name, ops in TC_LIBS.items():
        found = {op: sass[name].count(op) for op in ops}
        if not all(found.values()):
            fail(f"SASS of lib{name}: {found}; the tensor-core route must "
                 f"issue {' and '.join(ops)}")
        log(f"[sass] lib{name}: " + ", ".join(f"{op} x{n}"
                                              for op, n in found.items()))
    for (name, tag), ops in TC_FUNCS.items():
        funcs = {k: v for k, v in _sass_functions(sass[name]).items()
                 if tag in k}
        if not funcs:
            fail(f"SASS of lib{name}: no function named *{tag}*")
        found = {op: sum(v.count(op) for v in funcs.values()) for op in ops}
        if not all(found.values()):
            fail(f"SASS of lib{name}'s {tag} kernel: {found}; it must issue "
                 f"{' and '.join(ops)}")
        log(f"[sass] lib{name} {tag} kernel ({len(funcs)} instance(s)): "
            + ", ".join(f"{op} x{n}" for op, n in found.items()))


def check_tc_routes(what, routes, launches):
    """Every one of ``launches`` bf16 launches took the tensor-core route."""
    if dict(routes) != {"wgmma": launches, "simt": 0}:
        fail(f"{what}: routes {dict(routes)}; all {launches} bf16 launches "
             "must take the tensor-core kernel")


def small_tc_checks(dev):
    """The tensor-core routes against their plain versions in bf16 at small
    ragged shapes: matmul against matmul_ref (the products are exact in f32
    on both sides; f32 out differs by the order of K f32 additions, 2^-16
    of the largest |c|; bf16 out by one rounding, 2^-7 of the largest); the
    CE forward at ragged R (1, 5, 70, 130), tied and untied, V = 1104 in
    256-column tiles of which the last two lie wholly past vocab = 600 and
    a label in the last true column, against lm_head_ce_stats_ref (lse and
    gold within 1e-3 absolute, the full-width limit); the CE backward tied
    and untied with vocab < V against lm_head_bwd_ref (1e-3 of the largest
    magnitude, the full-width limit); then small_tc_attn_checks. Each
    call's route is counted and must be wgmma."""
    import torch

    from repro_torch.kernels import reset_launches
    from repro_torch.kernels.lm_head import (lm_head_bwd, lm_head_bwd_ref,
                                             lm_head_ce, lm_head_ce_stats_ref,
                                             lm_head_logits,
                                             lm_head_logits_ref)
    from repro_torch.kernels.matmul import matmul, matmul_ref

    bf = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(8)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev)

    reset_launches()
    calls = 0
    for m, k, n in ((128, 64, 256), (129, 200, 72), (300, 136, 264),
                    (7, 2056, 520)):
        a, b = rnd(m, k).to(bf), rnd(k, n).to(bf)
        for od in (torch.float32, torch.bfloat16):
            tag = f"matmul tc bf16 {m}x{k}x{n} out {od}"
            got, want = matmul(a, b, out_dtype=od), matmul_ref(a, b,
                                                              out_dtype=od)
            check_rel(tag, got, want,
                      2 ** -16 if od == torch.float32 else 2 ** -7)
            calls += 1
    if matmul.routes != {"wgmma": calls, "simt": 0}:
        fail(f"matmul routes {matmul.routes}: expected {calls} on wgmma")
    calls = 0
    V, vocab, d = 1104, 600, 64
    for R in (1, 5, 70, 130):
        for tied in (True, False):
            x = rnd(R, d).to(bf)
            w = (rnd(V, d).T if tied else rnd(d, V)).to(bf)
            lab = torch.randint(0, vocab, (R, 1), dtype=torch.int32,
                                generator=torch.Generator().manual_seed(R))
            lab[-1] = vocab - 1
            lab = lab.to(dev)
            tag = f"CE fwd tc bf16 R={R} V={V} vocab={vocab} d={d} tied={tied}"
            lse, gold = lm_head_ce.raw(x, w, lab, vocab=vocab)
            rlse, rgold = lm_head_ce_stats_ref(x, w, lab, vocab=vocab)
            check_close(tag + " lse", lse, rlse, atol=1e-3, rtol=0)
            check_close(tag + " gold", gold, rgold, atol=1e-3, rtol=0)
            calls += 1
    check_tc_routes("small CE forward cases", lm_head_ce.routes, calls)
    calls = 0
    for R, V, vocab, d in ((67, 200, 190, 96), (130, 1104, 1000, 64)):
        for tied in (True, False):
            x = rnd(R, d).to(bf)
            w = (rnd(V, d).T if tied else rnd(d, V)).to(bf)
            lab = torch.randint(0, vocab, (R, 1), dtype=torch.int32,
                                generator=torch.Generator().manual_seed(R))
            lab = lab.to(dev)
            lse, _ = lm_head_ce.raw(x, w, lab, vocab=vocab)
            gr = rnd(R, 1)
            tag = f"CE bwd tc bf16 R={R} V={V} vocab={vocab} d={d} tied={tied}"
            dx, dw = lm_head_bwd(x, w, lab, lse, gr, vocab=vocab)
            rdx, rdw = lm_head_bwd_ref(x, w, lab, lse, gr, vocab=vocab)
            check_rel(tag + " dx", dx, rdx, 1e-3)
            check_rel(tag + " dw", dw, rdw, 1e-3)
            if not (dw[:, vocab:] == 0).all():
                fail(tag + ": dw must be 0 on the padded columns")
            calls += 1
    if lm_head_bwd.routes != {"wgmma": calls, "simt": 0}:
        fail(f"CE bwd routes {lm_head_bwd.routes}: expected {calls} on wgmma")
    # the decode head at R = 1 .. 300 (row tiles of 8, 16, 64 and 256),
    # tied and untied, V = 1104 past vocab = 1000, d = 256: logits and row
    # max within 1e-3 (bf16 products exact in f32, d = 256 of them summed in
    # other orders), argmax by check_argmax's rule
    calls = 0
    V, vocab, d = 1104, 1000, 256
    for R in (1, 5, 8, 16, 20, 70, 300):
        for tied in (True, False):
            x = rnd(R, d).to(bf)
            w = (0.5 * (rnd(V, d).T if tied else rnd(d, V))).to(bf)
            tag = f"decode head tc bf16 R={R} V={V} vocab={vocab} tied={tied}"
            lg, m, arg = lm_head_logits.raw(x, w, vocab=vocab)
            rlg, rm, _ = lm_head_logits_ref(x, w, vocab=vocab)
            check_close(tag + " logits", lg, rlg, atol=1e-3, rtol=0,
                        quiet=True)
            check_close(tag + " max", m, rm, atol=1e-3, rtol=0, quiet=True)
            check_argmax(tag, arg, rlg, vocab, gap_tol=2e-3)
            calls += 1
    check_tc_routes("small decode head cases", lm_head_logits.routes, calls)
    small_tc_attn_checks(dev)


def small_tc_attn_checks(dev):
    """The tensor-core routes of flash_fwd, flash_bwd and the ring step
    backward against their plain versions in bf16 at small ragged shapes,
    each case with k and v (and do) both as the projections' views (the
    main path's layout) and contiguous; limits beside each; every call's
    route counted, all wgmma. Then bf16 gradients through a windowed and a
    d = 128 flash_attention, and the up-front refusal of an f32 one."""
    import torch

    from repro_torch.kernels import reset_launches
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_fwd,
                                                     flash_bwd, flash_bwd_ref,
                                                     flash_delta,
                                                     flash_delta_ref,
                                                     flash_fwd_ref,
                                                     ring_bwd_ref,
                                                     ring_flash_bwd,
                                                     ring_flash_fwd,
                                                     ring_fwd_ref)

    g = torch.Generator(device=dev).manual_seed(9)

    def layouts(b, s, h, hk, d):
        """q (a view), then (tag, k, v, do) as views and contiguous."""
        q, k, v, do = (_proj(g, b, s_, n, d)
                       for s_, n in ((s[0], h), (s[1], hk), (s[1], hk),
                                     (s[0], h)))
        return q, (("views", k, v, do),
                   ("contiguous", k.contiguous(), v.contiguous(),
                    do.contiguous()))

    reset_launches()
    # flash_fwd: check_flash_tc's limits (the full-width ones)
    calls = 0
    # (sq, skv, h, hk, d, causal, window): tests/test_torch_cuda.py's
    # FLASH_TC_CASES and one at the length of an admission prefill
    flash_cases = (
        (5, 5, 4, 4, 32, True, None), (70, 200, 8, 2, 64, True, None),
        (130, 130, 4, 1, 64, True, 40), (200, 333, 8, 2, 128, True, 50),
        (129, 129, 4, 4, 128, False, None), (1, 77, 8, 2, 64, True, None),
        (300, 300, 8, 2, 32, False, 64), (64, 64, 4, 1, 64, True, 1),
        (1000, 1000, 8, 2, 64, True, None))
    for sq, skv, h, hk, d, causal, window in flash_cases:
        q, lays = layouts(2, (sq, skv), h, hk, d)
        for lay, k, v, _ in lays:
            check_flash_tc(f"flash tc bf16 sq={sq} skv={skv} h={h}/{hk} d={d} "
                           f"c={causal} window={window} k/v {lay}", q, k, v,
                           causal=causal, window=window)
            calls += 1
    check_tc_routes("small flash_fwd cases", flash_attention_fwd.routes, calls)

    # flash_bwd on the plain o and lse: dq within 2^-7 of its largest
    # (rounded to bf16), dk/dv 1e-3 (f32), the full-width limits; rows that
    # see no key (sq > skv, causal) give dq = 0. delta = rowsum(do o) plus
    # noise, as the ring passes it: with delta exactly rowsum(do o), window
    # 1 makes dq and dk zero in exact arithmetic (p = 1 on one key), and a
    # limit relative to their largest magnitude would measure only the two
    # sides' f32 cancellation
    calls = 0
    for sq, skv, h, hk, d, causal, window in flash_cases + (
            (90, 40, 8, 2, 64, True, None), (70, 33, 4, 1, 128, True, 16)):
        q, lays = layouts(2, (sq, skv), h, hk, d)
        o, lse = flash_fwd_ref(q, lays[0][1], lays[0][2], causal=causal,
                               window=window)
        dead = torch.isneginf(lse)
        noise = torch.randn((2, h, sq), generator=g, device=dev)
        for lay, k, v, do in lays:
            kw = dict(causal=causal, window=window)
            delta = flash_delta(do, o) + noise
            got = flash_bwd(q, k, v, do, lse, delta, **kw)
            want = flash_bwd_ref(q, k, v, do, lse, delta, **kw)
            tag = (f"flash bwd tc bf16 sq={sq} skv={skv} h={h}/{hk} d={d} "
                   f"c={causal} window={window} k/v/do {lay}")
            check_rel(tag + " dq", got[0], want[0], 2 ** -7)
            check_rel(tag + " dk", got[1], want[1], 1e-3)
            check_rel(tag + " dv", got[2], want[2], 1e-3)
            if dead.any() and not (got[0][dead] == 0).all():
                fail(f"{tag}: rows that see no key must give dq = 0")
            calls += 1
    check_tc_routes("small flash_bwd cases", flash_bwd.routes, calls)

    # gradients through flash_attention: bf16 with a window and at d = 128
    # on the tensor-core backward, each within 2^-7 of its largest against
    # the plain backward on the same o and lse (both round dq, dk, dv to
    # bf16 once); an f32 windowed one is refused before any launch
    for d, window in ((64, 40), (128, None), (128, 24)):
        q, k, v, go = (_proj(g, 2, 200, n, d) for n in (8, 2, 2, 8))
        q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
        reset_launches()
        o = flash_attention(q, k, v, causal=True, window=window)
        got = torch.autograd.grad(o, (q, k, v), go)
        check_tc_routes(f"flash_attention grad d={d} window={window}: "
                        "flash_bwd", flash_bwd.routes, 1)
        with torch.no_grad():
            o2, lse = flash_attention_fwd(q, k, v, causal=True, window=window)
            want = flash_bwd_ref(q, k, v, go, lse, flash_delta_ref(go, o2),
                                 causal=True, window=window)
        for name, a, b_ in zip(("dq", "dk", "dv"), got, want):
            check_rel(f"flash_attention bf16 grad d={d} window={window} "
                      f"{name}", a, b_.to(a.dtype), 2 ** -7)
    q = torch.randn((1, 4, 64, 64), generator=g, device=dev,
                    requires_grad=True)
    reset_launches()
    try:
        flash_attention(q, q.detach(), q.detach(), window=16)
        fail("an f32 windowed flash_attention gradient was not refused")
    except NotImplementedError:
        pass
    if flash_attention_fwd.launches:
        fail("the f32 refusal came after the forward's launch")
    log("[check] f32 windowed flash_attention gradient refused before any "
        "launch")

    # the ring step forward at check_flash_tc's limits (o 2e-2 and 2^-6 of
    # its row, lse 1e-3 / 1e-4, -inf on the same rows) and, on its o and
    # lse, the backward: dq within 2^-7 of its largest (rounded to bf16),
    # dk/dv 1e-3 (f32), the full-width limits
    calls = 0
    # (sq, skv, h, hk, d, q_start, k_start, masks)
    cases = ((70, 45, 4, 1, 32, 30, 50, {}),          # crosses the diagonal
             (33, 40, 4, 4, 64, 100, 0, {}),          # wholly before
             (33, 40, 8, 2, 64, 0, 64, {}),           # wholly after: dead
             (197, 160, 8, 2, 64, 64, 96, {}),        # ragged, dead rows
             (130, 200, 4, 1, 64, 60, 20, dict(window=30)),
             (150, 145, 8, 2, 32, 10, 30, dict(prefix_len=35)),
             (150, 400, 8, 2, 64, 200, 0, dict(window=40, prefix_len=70)),
             (70, 45, 4, 4, 64, 0, 0, dict(causal=False)),
             (130, 300, 8, 2, 128, 30, 50, dict(window=40)),
             (200, 333, 8, 2, 128, 0, 120, dict(prefix_len=140)),
             (256, 256, 8, 2, 128, 0, 0, {}),
             (1024, 1024, 8, 2, 64, 1024, 0, {}))     # a whole chunk before
    for sq, skv, h, hk, d, qs, ks, kw in cases:
        q, lays = layouts(2, (sq, skv), h, hk, d)
        qst, kst = _offsets(dev, qs, ks)
        g_lse = torch.randn((2, h, sq), generator=g, device=dev)
        for lay, k, v, do in lays:
            tag = (f"ring tc bf16 sq={sq} skv={skv} h={h}/{hk} d={d} "
                   f"q0={qs} k0={ks} {kw} k/v/do {lay}")
            o, lse = ring_flash_fwd(q, k, v, qst, kst, **kw)
            ro, rlse = ring_fwd_ref(q, k, v, qst, kst, **kw)
            check_close(tag + " o", o, ro, atol=2e-2, rtol=2e-2, quiet=True)
            check_rows(tag + " o", o, ro, 2 ** -6, quiet=True)
            check_lse(tag + " lse", lse, rlse, atol=1e-3, rtol=1e-4,
                      quiet=True)
            delta = flash_delta(do, o) - torch.where(torch.isneginf(lse), 0.0,
                                                     g_lse)
            args = (q, k, v, do, lse, delta, qst, kst)
            got = ring_flash_bwd(*args, **kw)
            want = ring_bwd_ref(*args, **kw)
            check_rel(tag + " dq", got[0], want[0], 2 ** -7)
            check_rel(tag + " dk", got[1], want[1], 1e-3)
            check_rel(tag + " dv", got[2], want[2], 1e-3)
            dead = ks > qs + sq - 1 and kw.get("causal", True)
            if dead and not all((t_ == 0).all() for t_ in got):
                fail(f"{tag}: a dead chunk must give zero gradients")
            rows = torch.isneginf(lse)
            if rows.any() and not (got[0][rows] == 0).all():
                fail(f"{tag}: rows with lse = -inf must give dq = 0")
            calls += 1
    check_tc_routes("small ring_flash_fwd cases", ring_flash_fwd.routes, calls)
    check_tc_routes("small ring_flash_bwd cases", ring_flash_bwd.routes, calls)
    log(f"[check] ring step forward and backward, tensor-core routes: {calls} "
        "small bf16 cases within their limits")
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# the ring and matmul: phases 2a, 13 and 8 for ring_flash_fwd/bwd and matmul
# ---------------------------------------------------------------------------

def check_lse(name, got, ref, *, atol, rtol, quiet=False):
    """lse with rows that saw no key: -inf in exactly the same rows, the
    finite rest within the tolerance."""
    import torch

    dead, rdead = torch.isneginf(got), torch.isneginf(ref)
    if not torch.equal(dead, rdead):
        fail(f"{name}: -inf rows differ ({int(dead.sum())} vs "
             f"{int(rdead.sum())})")
    return check_close(name, torch.where(dead, 0.0, got),
                       torch.where(rdead, 0.0, ref), atol=atol, rtol=rtol,
                       quiet=quiet)


def _offsets(dev, qs, ks):
    import torch

    return (torch.tensor([[qs]], dtype=torch.int32, device=dev),
            torch.tensor([[ks]], dtype=torch.int32, device=dev))


def small_f32_ring_checks(dev):
    """ring_flash_fwd/bwd and matmul against their plain versions in f32 at
    small shapes, tolerance 1e-4: ragged shard and chunk lengths, GQA
    groups of 1-4, d 32/64 (128 forward only), chunks before, across and
    wholly after the shard (every row masked: lse = -inf, o = 0 and zero
    gradients), window and prefix masks; matmul at ragged M/N/K, with
    out_dtype, and K == 0 (zeros, no launch)."""
    import torch

    from repro_torch.kernels import launch_counts
    from repro_torch.kernels.flash_attention import (flash_delta,
                                                     ring_bwd_ref,
                                                     ring_flash_bwd,
                                                     ring_flash_fwd,
                                                     ring_fwd_ref)
    from repro_torch.kernels.matmul import matmul, matmul_ref

    tol = dict(atol=1e-4, rtol=1e-4)
    g = torch.Generator(device=dev).manual_seed(40)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev)

    # (sq, skv, h, hk, d, q_start, k_start, masks)
    cases = ((70, 45, 4, 2, 32, 30, 50, {}),          # crosses the diagonal
             (33, 40, 4, 4, 64, 100, 0, {}),          # wholly before
             (33, 40, 8, 2, 64, 0, 64, {}),           # wholly after: dead
             (97, 32, 8, 2, 64, 64, 96, {}),          # ragged, 5 x 32 chunks
             (70, 45, 4, 1, 64, 60, 20, dict(window=30)),
             (70, 45, 8, 2, 32, 10, 30, dict(prefix_len=35)),
             (70, 45, 4, 4, 64, 0, 0, dict(causal=False)),
             (70, 45, 8, 2, 128, 30, 50, dict(window=40)))
    for sq, skv, h, hk, d, qs, ks, kw in cases:
        q = rnd(2, sq, h, d).transpose(1, 2)          # strided, as projected
        k, v = rnd(2, hk, skv, d), rnd(2, hk, skv, d)
        qst, kst = _offsets(dev, qs, ks)
        tag = (f"ring f32 sq={sq} skv={skv} h={h}/{hk} d={d} q0={qs} "
               f"k0={ks} {kw}")
        o, lse = ring_flash_fwd(q, k, v, qst, kst, **kw)
        ro, rlse = ring_fwd_ref(q, k, v, qst, kst, **kw)
        check_close(tag + " o", o, ro, **tol)
        check_lse(tag + " lse", lse, rlse, **tol)
        dead = ks > qs + sq - 1 and kw.get("causal", True)
        if dead and not (torch.isneginf(lse).all() and (o == 0).all()):
            fail(f"{tag}: a chunk after the shard must give lse = -inf, o = 0")
        if d == 128:
            continue
        do = rnd(2, sq, h, d).transpose(1, 2)
        delta = flash_delta(do, o) - rnd(2, h, sq)    # delta' = delta - g_lse
        got = ring_flash_bwd(q, k, v, do, lse, delta, qst, kst, **kw)
        want = ring_bwd_ref(q, k, v, do, rlse, delta, qst, kst, **kw)
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            check_close(f"{tag} {name}", a, b, **tol)
        if dead and not all((t == 0).all() for t in got):
            fail(f"{tag}: a dead chunk must give zero gradients")

    for m, k, n, od in ((1, 1, 1, None), (100, 70, 130, None),
                        (129, 257, 65, torch.bfloat16), (5, 1000, 3, None)):
        a, b = rnd(m, k), rnd(k, n)
        check_close(f"matmul f32 {m}x{k}x{n} out {od}", matmul(a, b,
                    out_dtype=od), matmul_ref(a, b, out_dtype=od),
                    atol=1e-4 if od is None else 2e-2,
                    rtol=1e-4 if od is None else 2 ** -8)
    before = launch_counts()["matmul"]
    z = matmul(rnd(4, 0), rnd(0, 6), out_dtype=torch.bfloat16)
    if (launch_counts()["matmul"] != before or z.dtype != torch.bfloat16
            or tuple(z.shape) != (4, 6) or (z != 0).any()):
        fail("matmul: K == 0 must give bf16 zeros without a launch")
    torch.cuda.synchronize()


def _ring_inputs(dev, gen, seq):
    """llama3_2_1b's attention at B = 1 and ``seq`` tokens, bf16: q as the
    projection's strided view, k, v and the output cotangent do."""
    import torch

    from repro_torch.configs import get_config

    cfg = get_config("llama3_2_1b")
    h, hk, d = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    bf = torch.bfloat16

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf)

    q = rnd(1, seq, h, d).transpose(1, 2)
    return q, rnd(1, hk, seq, d), rnd(1, hk, seq, d), rnd(1, h, seq, d)


def _grads(fn, q, k, v, do):
    import torch

    q, k, v = (t.detach().requires_grad_(True) for t in (q, k, v))
    o = fn(q, k, v)
    return [o.detach()] + list(torch.autograd.grad(o, (q, k, v), do))


def _replay_pairs(n, a, c):
    """The (rank, step) pairs of an n-rank ring whose ranks hold a queries
    and c keys each: (i, t, j, q_start, k_start), rank i meeting chunk
    j = (i + t) % n at step t at the distributed form's offsets."""
    from repro_torch.kernels.flash_attention.ring import _shard_offsets

    return [(i, t, (i + t) % n, *_shard_offsets(i, t, n, a, c))
            for i in range(n) for t in range(n)]


def ring_schedule_replay(q, k, v, *, n, causal=True, window=None,
                         sm_scale=None, prefix_len=0):
    """The distributed ring of n ranks replayed rank by rank in one process
    (one card cannot hold n NCCL ranks): q (B, H, Sq, D) and k, v
    (B, Hk, Skv, D) are the GLOBAL tensors, rank i's shard is the i-th of n
    sequence slices, and its steps and merges are the distributed form's
    (the ring module's ``_ring`` at ``_replay_pairs``' offsets), with no
    communication. Returns the ranks' o shards concatenated along the
    sequence; differentiable, so a backward replays the reversed ring."""
    import torch

    from repro_torch.kernels.flash_attention.ring import _ring

    sq, skv = q.shape[2], k.shape[2]
    if sq % n or skv % n:
        raise ValueError(f"ring_schedule_replay: n={n} does not divide the "
                         f"lengths ({sq}, {skv})")
    a, c = sq // n, skv // n
    kw = dict(causal=causal, window=window, sm_scale=sm_scale,
              prefix_len=prefix_len)
    steps = [[] for _ in range(n)]
    for i, _, j, qs, ks in _replay_pairs(n, a, c):
        steps[i].append((k[:, :, j * c:(j + 1) * c],
                         v[:, :, j * c:(j + 1) * c], qs, ks))
    return torch.cat([_ring(q[:, :, i * a:(i + 1) * a], steps[i], kw)
                      for i in range(n)], dim=2)


def ring_main_path(dev):
    """Phase 13: the ring at llama3_2_1b's attention widths (B = 1, H = 32,
    Hk = 8, d = 64) over RING_SEQ tokens in RING_STEPS steps, bf16: (a) the
    local ring_flash_attention and its gradients, (b) the distributed
    schedule replayed rank by rank (ring_schedule_replay), both against the
    port's flash_attention (kernels 2-4); then matmul at the MLP's up
    projection. Launch counts are zeroed before and read after each path.
    Returns (counts, matmul's max |err| against its plain version)."""
    import torch

    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     ring_flash_attention,
                                                     ring_flash_bwd,
                                                     ring_flash_fwd)
    from repro_torch.kernels.matmul import matmul, matmul_ref

    n = RING_STEPS
    gen = torch.Generator(device=dev).manual_seed(41)
    q, k, v, do = _ring_inputs(dev, gen, RING_SEQ)
    t0 = time.perf_counter()
    ref = _grads(lambda *a: flash_attention(*a, causal=True), q, k, v, do)
    torch.cuda.synchronize()
    t_flash = time.perf_counter() - t0

    reset_launches()
    t0 = time.perf_counter()
    local = _grads(lambda *a: ring_flash_attention(*a, ring_steps=n,
                                                   causal=True), q, k, v, do)
    torch.cuda.synchronize()
    t_local = time.perf_counter() - t0
    t0 = time.perf_counter()
    replay = _grads(lambda *a: ring_schedule_replay(*a, n=n, causal=True),
                    q, k, v, do)
    torch.cuda.synchronize()
    t_replay = time.perf_counter() - t0
    counts = launch_counts()
    fwd_routes = dict(ring_flash_fwd.routes)
    bwd_routes = dict(ring_flash_bwd.routes)
    log(f"[ring] S={RING_SEQ} h=32/8 d=64 bf16, {n} steps, forward + "
        f"backward: flash_attention {t_flash * 1e3:.3f} ms, local ring "
        f"{t_local * 1e3:.3f} ms, rank-by-rank replay of {n} ranks "
        f"{t_replay * 1e3:.3f} ms (host clock, first calls)")
    want = n + n * n                      # local steps + replayed steps
    for name in ("ring_flash_fwd", "ring_flash_bwd"):
        if counts[name] != want:
            fail(f"ring path: {name} launched {counts[name]} times, "
                 f"expected {want}")
    check_tc_routes("ring path: ring_flash_fwd", fwd_routes, want)
    check_tc_routes("ring path: ring_flash_bwd", bwd_routes, want)
    # limits: o row by row (check_rows), 2^-5 of the row's largest |o|:
    # flash_attention rounds its f32 o to bf16 once, the ring rounds each
    # of its n steps' o and each of its n - 1 merges' to bf16, 2n roundings
    # of at most 2^-8 of rows about as large as o's (read on an H100:
    # err / row max 1.342e-02 local, 1.099e-02 replay, 1.481e-02 replay vs
    # local, all below 2^-6).
    # Gradients are bf16 here (cast to q's, k's, v's dtype as JAX does), so
    # flash's 1e-3 f32 limit for dk/dv cannot apply: each side rounds once
    # and the ring's dq (and the replay's dk/dv) sum n bf16 partials in bf16
    # (autograd accumulates in the leaf's dtype): 2^-6 of the largest
    # magnitude, rtol 2^-6.
    for form, got in (("local", local), ("replay", replay)):
        check_rows(f"ring {form} o vs flash_attention", got[0], ref[0],
                   2 ** -5)
        for nm, a, b in zip(("dq", "dk", "dv"), got[1:], ref[1:]):
            check_rel(f"ring {form} {nm} vs flash_attention", a, b, 2 ** -6)
    check_rows("ring replay o vs local ring o", replay[0], local[0], 2 ** -5)
    del ref, local, replay

    bf = torch.bfloat16
    m, kk, nn = MM_SHAPE
    a = torch.randn((m, kk), generator=gen, device=dev).to(bf)
    b = (torch.randn((kk, nn), generator=gen, device=dev) * kk ** -0.5).to(bf)
    reset_launches()
    t0 = time.perf_counter()
    c = matmul(a, b)
    torch.cuda.synchronize()
    log(f"[matmul] {m}x{kk} @ {kk}x{nn} bf16 -> bf16: "
        f"{(time.perf_counter() - t0) * 1e3:.3f} ms (host clock, first call)")
    counts["matmul"] = launch_counts()["matmul"]
    if counts["matmul"] != 1:
        fail(f"matmul path: {counts['matmul']} launches, expected 1")
    if matmul.routes != {"wgmma": 1, "simt": 0}:
        fail(f"matmul path: routes {matmul.routes}; the bf16 call must take "
             "the tensor-core kernel")
    # bf16 products are exact in f32; both sum K of them in f32 and round
    # once to bf16: one ulp, 2^-8 relative
    err = check_rel(f"matmul bf16 {m}x{kk}x{nn}", c, matmul_ref(a, b),
                    2 ** -7)
    torch.cuda.synchronize()
    return counts, err


def ring_kernel_checks(dev):
    """Phase 2b for the ring kernels: each against its plain version at
    every launch shape and offset of phase 13, bf16: the RING_STEPS local
    steps (all RING_SEQ queries against each chunk) and the RING_STEPS^2
    replayed (rank, step) pairs (a shard against one chunk at the
    distributed offsets). The plain versions run in blocks of one shard's
    query rows, dk/dv summed over the blocks, so that their f32 scores fit
    the card. Returns ({kernel: max |err|}, the replayed pairs' inputs
    (tag, q, k, v, do, q_start, k_start) for time_ring_kernels)."""
    import torch

    from repro_torch.kernels import reset_launches
    from repro_torch.kernels.flash_attention import (flash_delta,
                                                     ring_bwd_ref,
                                                     ring_flash_bwd,
                                                     ring_flash_fwd,
                                                     ring_fwd_ref)

    gen = torch.Generator(device=dev).manual_seed(42)
    n = RING_STEPS
    c = RING_SEQ // n
    q, k, v, do = _ring_inputs(dev, gen, RING_SEQ)

    def part(x, j):
        return x[:, :, j * c:(j + 1) * c]

    local = [(f"local step {t}", q, part(k, t), part(v, t), do, 0, t * c)
             for t in range(n)]
    replay = [(f"rank {i} step {t}", part(q, i), part(k, j), part(v, j),
               part(do, i).contiguous(), qs, ks)
              for i, t, j, qs, ks in _replay_pairs(n, c, c)]
    worst = dict.fromkeys(("o", "o/row", "lse", "dq", "dk", "dv"), 0.0)
    reset_launches()
    for tag, qq, kc, vc, dd, qs, ks in local + replay:
        tag = f"ring bf16 S={RING_SEQ} {tag}"
        o, lse = ring_flash_fwd(qq, kc, vc, *_offsets(dev, qs, ks))
        g_lse = torch.randn(lse.shape, generator=gen, device=dev)
        delta = flash_delta(dd, o) - torch.where(torch.isneginf(lse), 0.0,
                                                 g_lse)
        got = ring_flash_bwd(qq, kc, vc, dd, lse, delta,
                             *_offsets(dev, qs, ks))
        ro, rlse, rdq, rdk, rdv = [], [], [], 0.0, 0.0
        for r in range(0, qq.shape[2], c):
            rows = slice(r, r + c)
            o_r, lse_r = ring_fwd_ref(qq[:, :, rows], kc, vc, qs + r, ks)
            part = (qq[:, :, rows], kc, vc, dd[:, :, rows], lse[:, :, rows],
                    delta[:, :, rows], qs + r, ks)
            dq_r, dk_r, dv_r = ring_bwd_ref(*part)
            ro.append(o_r)
            rlse.append(lse_r)
            rdq.append(dq_r)
            rdk, rdv = rdk + dk_r, rdv + dv_r
        ro, rlse, rdq = (torch.cat(x, dim=2) for x in (ro, rlse, rdq))
        # o at check_flash_tc's limits (the tensor-core forward rounds p
        # to bf16 before P V, the plain version keeps it f32; both round o
        # once): 2e-2 absolute + relative and 2^-6 of the row's largest
        # |o|; lse f32; dq rounded to bf16 (flash bwd's 2^-7), dk/dv f32
        # (1e-3)
        err_o = check_close(tag + " o", o, ro, atol=2e-2, rtol=2e-2,
                            quiet=True)
        _, ratio = check_rows(tag + " o", o, ro, 2 ** -6, quiet=True)
        for key, e in (("o", err_o), ("o/row", ratio),
                       ("lse", check_lse(tag + " lse", lse, rlse, atol=1e-3,
                                         rtol=1e-4, quiet=True)),
                       ("dq", check_rel(tag + " dq", got[0], rdq, 2 ** -7,
                                        quiet=True)),
                       ("dk", check_rel(tag + " dk", got[1], rdk, 1e-3,
                                        quiet=True)),
                       ("dv", check_rel(tag + " dv", got[2], rdv, 1e-3,
                                        quiet=True))):
            worst[key] = max(worst[key], e)
    torch.cuda.synchronize()
    for fn in (ring_flash_fwd, ring_flash_bwd):
        check_tc_routes(f"ring kernel checks: {fn.__name__}", fn.routes,
                        len(local) + len(replay))
    log(f"[check] ring bf16 kernels vs plain at S={RING_SEQ}, {n} local "
        f"steps + {len(replay)} replayed (rank, step) pairs, all on the "
        f"tensor-core routes: max|err| o "
        f"{worst['o']:.3e} (err/row-max {worst['o/row']:.3e}, limits 2e-2 "
        f"and 2^-6 of the row), "
        f"lse {worst['lse']:.3e} (1e-3), dq {worst['dq']:.3e} (2^-7 of "
        f"max), dk {worst['dk']:.3e}, dv {worst['dv']:.3e} (1e-3 of max)")
    return ({"ring_flash_fwd": max(worst["o"], worst["lse"]),
             "ring_flash_bwd": max(worst["dq"], worst["dk"], worst["dv"])},
            replay)


def time_ring_kernels(dev, pairs):
    """The ring kernels at the distributed form's per-rank shape on the
    main path, over the replayed (rank, step) pairs of ring_kernel_checks:
    ms per launch; the bound counts the keys each pair's rows see. matmul
    at MM_SHAPE."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import reset_launches
    from repro_torch.kernels.flash_attention import (flash_delta,
                                                     ring_bwd_ref,
                                                     ring_flash_bwd,
                                                     ring_flash_fwd,
                                                     ring_fwd_ref)
    from repro_torch.kernels.matmul import matmul, matmul_ref

    gen = torch.Generator(device=dev).manual_seed(43)
    _, q, k, _, _, _, _ = pairs[0]
    _, h, a, d = q.shape
    hk, c = k.shape[1], k.shape[2]
    runs, visible = [], 0
    for _, q, k, v, do, qs, ks in pairs:
        qpos = qs + torch.arange(a, device=dev)
        kpos = ks + torch.arange(c, device=dev)
        mask = qpos[:, None] >= kpos[None, :]
        visible += int(mask.sum())
        offs = _offsets(dev, qs, ks)
        o, lse = ring_flash_fwd(q, k, v, *offs)
        runs.append(dict(qkv=(q, k, v), offs=offs, do=do, mask=mask, lse=lse,
                         delta=flash_delta(do, o), q_simt=_unaligned(q)))
    npairs = len(runs)

    def per_launch(fn, iters):
        def go():
            for r in runs:
                fn(r)
        return cuda_ms(go, iters=iters, warmup=1) / npairs

    def per_launch_on(path, wrapper, fn, iters):
        """per_launch, every launch of ``wrapper`` in it on ``path``."""
        reset_launches()
        ms = per_launch(fn, iters)
        want = {"wgmma": 0, "simt": 0, path: (iters + 1) * npairs}
        if dict(wrapper.routes) != want:
            fail(f"timed {wrapper.__name__}: routes {dict(wrapper.routes)}, "
                 f"expected {want}")
        return ms

    def sdpa(r):
        return F.scaled_dot_product_attention(*r["qkv"], attn_mask=r["mask"],
                                              enable_gqa=True)

    def sdpa_fwd_bwd(r):
        ins = [t.detach().requires_grad_(True) for t in r["qkv"]]
        torch.autograd.grad(sdpa(dict(r, qkv=ins)), ins, r["do"])

    def bwd_args(r):
        return (*r["qkv"], r["do"], r["lse"], r["delta"], *r["offs"])

    out = {}
    shape = (f"{npairs} (rank, step) pairs of q (1,{h},{a},{d}) vs a chunk "
             f"(1,{hk},{c},{d}) bf16, causal, {visible} visible (q, k) "
             "pairs per head in all")
    flops = 4 * d * h * visible / npairs
    io = (h * a * d + 2 * hk * c * d) * 2
    out["ring_flash_fwd"] = dict(
        ms=per_launch_on("wgmma", ring_flash_fwd,
                         lambda r: ring_flash_fwd(*r["qkv"], *r["offs"]), 2),
        simt_ms=per_launch_on("simt", ring_flash_fwd, lambda r: ring_flash_fwd(
            r["q_simt"], *r["qkv"][1:], *r["offs"]), 1),
        flops=flops,
        plain_ms=per_launch(lambda r: ring_fwd_ref(*r["qkv"], *r["offs"]),
                            1),
        library_ms=per_launch(sdpa, 2),
        library="F.scaled_dot_product_attention(attn_mask bool, enable_gqa)",
        shape=shape)
    out["ring_flash_fwd"].update(zip(("bound_ms", "bound_by"), bound(
        io + h * a * d * 2 + h * a * 4, flops, "bfloat16")))
    # the CUDA-core forward's bf16 instantiation (the route of bf16 the
    # copies cannot read) on the same values: it keeps p in f32 and rounds
    # the same f32 o once, so o within one ulp, 2^-7 of its row; lse f32
    worst = [0.0, 0.0]
    for r in runs:
        o, lse = ring_flash_fwd(r["q_simt"], *r["qkv"][1:], *r["offs"])
        ro, rlse = ring_fwd_ref(*r["qkv"], *r["offs"])
        worst[0] = max(worst[0], check_rows("ring fwd bf16 CUDA-core o", o,
                                            ro, 2 ** -7, quiet=True)[1])
        worst[1] = max(worst[1], check_lse("ring fwd bf16 CUDA-core lse",
                                           lse, rlse, atol=1e-3, rtol=1e-4,
                                           quiet=True))
        del o, lse, ro, rlse
    log(f"[check] ring fwd bf16 CUDA-core kernel vs plain over the "
        f"{npairs} pairs: o err/row-max {worst[0]:.3e} (limit 2^-7), lse "
        f"{worst[1]:.3e} (1e-3)")
    for r in runs:
        del r["q_simt"]
    # SDPA's backward alone: its forward + backward less its forward (one
    # graph alive at a time)
    out["ring_flash_bwd"] = dict(
        ms=per_launch(lambda r: ring_flash_bwd(*bwd_args(r)), 2),
        flops=2.5 * flops, tc_flops=4.5 * flops,
        plain_ms=per_launch(lambda r: ring_bwd_ref(*bwd_args(r)), 1),
        library_ms=per_launch(sdpa_fwd_bwd, 2)
        - out["ring_flash_fwd"]["library_ms"],
        library="backward of F.scaled_dot_product_attention(attn_mask bool, "
                "enable_gqa): forward + backward - forward",
        shape=shape)
    out["ring_flash_bwd"].update(zip(("bound_ms", "bound_by"), bound(
        io + h * a * d * 2 + 2 * h * a * 4 + h * a * d * 2
        + 2 * hk * c * d * 4, 2.5 * flops, "bfloat16")))
    del runs

    bf = torch.bfloat16
    m, kk, nn = MM_SHAPE
    x = torch.randn((m, kk), generator=gen, device=dev).to(bf)
    w = (torch.randn((kk, nn), generator=gen, device=dev) * kk ** -0.5).to(bf)
    out["matmul"] = dict(
        ms=cuda_ms(lambda: matmul(x, w), iters=5, warmup=1),
        flops=2 * m * kk * nn,
        plain_ms=cuda_ms(lambda: matmul_ref(x, w), iters=5, warmup=1),
        library_ms=cuda_ms(lambda: torch.matmul(x, w), iters=20),
        library="torch.matmul (bf16 in and out)",
        shape=f"a ({m},{kk}) @ b ({kk},{nn}) bf16 -> bf16")
    out["matmul"].update(zip(("bound_ms", "bound_by"), bound(
        (m * kk + kk * nn + m * nn) * 2, 2 * m * kk * nn, "bfloat16")))
    return out


# ---------------------------------------------------------------------------

def log_times(times):
    """Phase 8's report: a [time] line for each entry of ``times``, the
    [gbps] and [tflops] lines and the rmsnorm host split."""
    for name, t in times.items():
        lib = ("null" if t["library_ms"] is None
               else f"{t['library_ms']:.4f} ms")
        dev_only = ("" if "device_ms" not in t else
                    f" (device time alone {t['device_ms']:.4f} ms" + (
                        "" if "device_ms_contig" not in t else
                        f"; with k, v contiguous "
                        f"{t['device_ms_contig']:.4f} ms") + ")")
        log(f"[time] {name} {t['shape']}: kernel {t['ms']:.4f} ms{dev_only}, bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}), plain "
            f"{t['plain_ms']:.4f} ms, library {lib} [{t['library']}]")
        if "simt_ms" in t:
            log(f"[time] {name}: tensor-core route {t['ms']:.4f} ms, the "
                f"CUDA-core kernel on the same values {t['simt_ms']:.4f} ms "
                f"({t['simt_ms'] / t['ms']:.1f}x)")
    pairs_bwd = ("visible pairs; S and dP twice, dV and dK as hi and lo "
                 "planes: 9 products of 2 d per pair")
    issued_as = {
        "lm_head_bwd": "hi and lo planes: 5 products of 2 R d V",
        "flash_bwd": pairs_bwd, "ring_flash_bwd": pairs_bwd}
    t = times["lm_head"]
    log(f"[gbps] lm_head: {t['bytes'] / (t['ms'] * 1e-3) / 1e9:.1f} GB/s of "
        f"the function's {t['bytes'] / 1e9:.4f} GB in {t['ms']:.4f} ms, "
        f"{100 * t['bound_ms'] / t['ms']:.1f}% of its bound "
        f"({HBM_BPS / 1e12:.2f} TB/s)")
    for name in ("rmsnorm", "rmsnorm@train", "paged_decode", "flash_decode",
                 "flash_decode@d256"):
        t = times[name]
        log(f"[gbps] {name}: {t['bytes'] / (t['ms'] * 1e-3) / 1e9:.1f} "
            f"GB/s of the function's {t['bytes'] / 1e9:.6f} GB in "
            f"{t['ms']:.4f} ms on the call's clock, "
            f"{t['bytes'] / (t['device_ms'] * 1e-3) / 1e9:.1f} GB/s in the "
            f"device time alone ({t['device_ms']:.4f} ms), "
            f"{100 * t['bound_ms'] / t['device_ms']:.1f}% of its bound")
    t = times["paged_decode"]
    log(f"[paged] split-KV: {t['split'][0]} slots a block, "
        f"{t['split'][1]} ranges a (sequence, kv head)")
    for name in ("flash_decode", "flash_decode@d256"):
        t = times[name]
        log(f"[decode] {name} split-KV: {t['split'][0]} slots a block, "
            f"{t['split'][1]} ranges a (sequence, kv head); kv_len as an "
            f"int32 device tensor {t['ms_dev_len']:.4f} ms on the call's "
            f"clock (as an int {t['ms']:.4f})")
    for name in ("ssm_scan", "ssm_scan@prefill"):
        t = times[name]
        log(f"[scan] {name}: {t['exps'] / (t['device_ms'] * 1e-3) / 1e12:.3f}"
            f"e12 exponentials/s in the device time alone "
            f"({t['device_ms']:.4f} ms), {100 * t['bound_ms'] / t['device_ms']:.1f}%"
            f" of its bound ({t['bound_by']}; {EX2_PER_S / 1e12:.2f}e12 "
            f"MUFU.EX2/s at 16 a clock per SM, 1.98 GHz, 132 SMs)")
    u = times["flash_decode"]["host_us"]
    log(f"[host] flash_decode {times['flash_decode']['shape']}: one call "
        f"{u['whole']:.2f} us on the host = checks {u['checks']:.2f} + split "
        f"rule {u['split']:.2f} + two torch.empty {u['empty']:.2f} + stream "
        f"handle {u['stream']:.2f} + the ctypes call {u['ctypes']:.2f} + the "
        f"two launches {u['ctypes_launch'] - u['ctypes']:.2f} + the rest "
        f"{u['whole'] - u['checks'] - u['split'] - u['empty'] - u['stream'] - u['ctypes_launch']:.2f}"
        f"; SDPA {u['library']:.2f} us")
    u = times["rmsnorm"]["host_us"]
    log(f"[host] rmsnorm {times['rmsnorm']['shape']}: one call "
        f"{u['whole']:.2f} us on the host = checks and route "
        f"{u['checks']:.2f} + torch.empty {u['empty']:.2f} + stream handle "
        f"{u['stream']:.2f} + the ctypes call {u['ctypes']:.2f} + the launch "
        f"{u['ctypes_launch'] - u['ctypes']:.2f} + the rest "
        f"{u['whole'] - u['checks'] - u['empty'] - u['stream'] - u['ctypes_launch']:.2f}"
        f"; F.rms_norm {u['library']:.2f} us")
    for name in ("matmul", "lm_head_ce", "lm_head_bwd", "flash_fwd",
                 "flash_fwd@train", "flash_bwd", "ring_flash_fwd",
                 "ring_flash_bwd"):
        t = times[name]
        rate = t["flops"] / (t["ms"] * 1e-3) / 1e12
        issued = ("" if "tc_flops" not in t else
                  f"; {t['tc_flops'] / (t['ms'] * 1e-3) / 1e12:.1f} TFLOP/s "
                  f"issued on the tensor cores ({issued_as[name]})")
        if "device_ms" in t:
            issued += (f"; {t['flops'] / (t['device_ms'] * 1e-3) / 1e12:.1f} "
                       f"TFLOP/s in the kernel's device time alone, "
                       f"{t['device_ms']:.4f} ms")
        log(f"[tflops] {name}: {rate:.1f} TFLOP/s of the function's "
            f"{t['flops'] / 1e12:.4f} TFLOP in {t['ms']:.4f} ms{issued}")


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
        fn = spill = ""
        for line in text.splitlines():
            if "Compiling entry function" in line:
                fn = line.split("'")[1]
            elif "spill" in line:
                spill = line.strip()
            elif "registers" in line or "error" in line:
                log(f"[nvcc {name}] {fn}: {line.strip()}; {spill}")
    delta_kernel.build()
    log(f"[build] {len(logs)} CUDA sources compiled in "
        f"{time.perf_counter() - t0:.1f}s")
    tc_sass_check()

    # 2a. kernels vs plain, f32 small shapes
    small_f32_checks(dev)
    small_f32_train_checks(dev)
    small_f32_app_checks(dev)
    small_f32_static_checks(dev)
    small_decode_scan_checks(dev)
    small_f32_ring_checks(dev)
    small_tc_checks(dev)

    cfg = get_config("llama3_2_1b")
    page, num_pages, slots = 512, 8 * 4 + 1, 8
    reqs = traffic(0, 16, cfg.vocab_size)
    sq = max(len(p) for p, _ in reqs)               # longest admission
    lens = [len(p) + 16 for p, _ in reqs[:slots]]   # a decode step's kv

    # 3. 2-layer f32: card vs CPU, serving and training
    two_layer_f32_check(cfg)
    two_layer_f32_train_check(cfg)
    two_layer_static_f32_checks()

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
    errs["flash_fwd"] = max(errs["flash_fwd"], errs.pop("flash_fwd@train"))
    times.update(time_train_kernels(dev, cfg, embed))
    del model, embed

    # 9. the apps path: FD, SEM and DG at full size through their entry
    # points
    acounts, astate = apps_main_path(dev)
    log("app kernels: " + ", ".join(f"{k}={acounts[k]}" for k in APP_KERNELS))
    counts.update({k: acounts[k] for k in APP_KERNELS})

    # 10. where an LSERK step's time goes; 2b and 8 for the app kernels
    swe = astate["swe"]
    profile_swe_step(swe["solver"], swe["Q"], swe["dt"])
    sem_global_breakdown(astate["op"], astate["u_glob"])
    errs.update(full_size_app_checks(astate))
    times.update(time_app_kernels(astate))
    del astate, swe

    # 11. the static path: musicgen_medium through generate, where its
    # decode step's time goes, the conditioning prefix
    mcounts, model, params, mstats = musicgen_main_path()
    counts["flash_decode"] = mcounts["flash_decode"]
    del model, params
    torch.cuda.empty_cache()

    # 12. falcon_mamba_7b through generate, forward vs prefill
    fcounts, model, params, fstats = falcon_main_path()
    counts["ssm_scan"] = fcounts["ssm_scan"]
    del model, params
    torch.cuda.empty_cache()

    # 2b and 8 for the static path's kernels
    errs.update(full_width_static_checks(dev))
    times.update(time_static_kernels(dev))
    torch.cuda.empty_cache()

    # 13. the ring (local and replayed rank by rank) and matmul; 2b and 8
    # for their kernels
    rcounts, errs["matmul"] = ring_main_path(dev)
    counts.update({k: rcounts[k] for k in RING_KERNELS})
    ring_errs, pairs = ring_kernel_checks(dev)
    errs.update(ring_errs)
    torch.cuda.empty_cache()
    times.update(time_ring_kernels(dev, pairs))
    del pairs
    log_times(times)
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
