#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
GPU: builds the port's seventeen hand-written Hopper kernels from
``src/``, holds each against its plain PyTorch version, serves
``llama3_2_1b`` through the continuous-batching engine, trains it through
``TrainLoop``, runs the paper's FD, SEM and DG apps at full size, serves
``musicgen_medium`` and ``falcon_mamba_7b`` through the static-batch path,
runs sequence-parallel ring attention at ``llama3_2_1b``'s widths and the
blocked matmul op, serves the whole ``deepseek_v2_lite`` (MLA + MoE) and
``mixtral_8x22b`` at 4 of its 56 layers (MoE, window) and the whole
``zamba2_7b`` (mamba2 + a shared attention block) through the static path,
serves the whole ``paligemma_3b`` (MQA at head dim 256, a vision-stub
prefix under the prefix-LM mask) through the engine, the static path and
a prefix prefill, trains the whole ``paligemma_3b`` and
``deepseek_v2_lite`` and ``zamba2_7b`` at reduced depth through
``TrainLoop``, and times each kernel. Every decode step of the engine and
the static path after the first of a run, and every train step of
``TrainLoop`` after its first, is a CUDA graph's replay
(``parallel.build_serve_step``/``build_paged_serve_step``/
``build_train_step``), held against the eager step and timed beside it;
each captured graph's kernel nodes must hold every hand-written kernel as
often as its capture counted the kernel's wrapper (``keep_graphs``,
``check_graph_kernels``).

  python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

1. build: one nvcc per CUDA source, all in parallel (each kernel's
   registers and spills printed); the SASS of the matmul, CE-head and decode-head libraries must hold HGMMA
   (wgmma) and UTMALDG (TMA loads), the CE forward's own tensor-core kernel
   HGMMA, that of the flash_fwd, flash_bwd and ring_flash libraries HGMMA
   and LDGSTS (cp.async), the ring step forward's own tensor-core kernel
   too, those of paged_decode and flash_decode LDGSTS;
2. kernels vs plain versions on the card: f32 at small shapes (tolerance
   1e-4; the app kernels at ragged shapes, 2e-5 for FD and 2e-4 of
   max|ref| for SEM/DG, SEM on both routes; flash_decode on positional and rotated caches,
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
   tied and untied, each launch's route counted; flash_fwd at d_qk 192 /
   d_v 128 on both kernels at ragged Sq != Skv, Sq off the 64-row tile, v
   the projection's strided view, flash_fwd with a window and flash_decode
   at mixtral's group of 6 query heads, d = 128; MLA's absorbed decode in bf16
   at deepseek's widths, its products' f32 results and its output against
   the CPU's; ssm_scan at n = 64 in f32 at L and dm off its tile, with and
   without h0 and with a per-head-broadcast A, and in bf16 at zamba2's
   prefill shape (4 x 512 x 7168); flash_fwd at d = 112 on both kernels at
   ragged Sq != Skv, q, k and v the projections' views), bf16 at
   the main paths' full-width shapes (the ring kernels at every launch
   shape and offset of phase 13: 4 local steps, 16 replayed pairs) and f32
   at the apps' full-size shapes (tolerances stated beside each check; the
   DG kernels and SEM also on the apps path's own state, both versions
   against the f64 result within the f32 rounding bound of their summed
   terms);
3. llama3_2_1b at full width with 2 layers in f32, one set of weights on
   the card (kernels) and on the CPU (plain versions): prefill logits and
   the first 8 greedy tokens must agree; the training loss and every
   parameter's gradient must agree; musicgen_medium, falcon_mamba_7b and a
   windowed (64) llama3_2_1b through ``generate`` on the static path
   (200-token prompt, 80 new tokens across the wrap): equal tokens, close
   logits; llama's static tokens equal its engine tokens; internlm2_1_8b
   (head_dim 128) through prefill and the engine, card vs CPU;
   deepseek_v2_lite with 2 layers (the dense one and one MoE layer) and
   mixtral_8x22b with 1 layer, weights drawn on the card and copied to the
   CPU: prefill logits of 2 x 64 tokens within 1e-3 of the largest logit
   and the first 8 greedy tokens equal, with the smallest gap between the
   k-th and (k+1)-th router probability printed; zamba2 at full width with
   3 layers (one group of 2 and the shared block, a tail of 1) the same
   way (1e-3 of the largest logit, 8 tokens equal); the compiled decode
   steps (``parallel.build_serve_step``/``build_paged_serve_step``: CUDA
   graphs) in bf16 at llama3_2_1b's width with 2 layers against the eager
   steps, tokens and launch and route counts equal, logits compared: the
   engine's step with sequences admitted and retired between replays, a
   window-64 step whose cache wraps during the replays, one step that
   refuses a second cache, and the sampled static loop and engine (the
   same generator seed each way, equal tokens);
4. the serving path: the full 16-layer bf16 llama3_2_1b through ``Engine``
   (8 slots, max_len 2048, page 512, 16 requests of 33-1000 prompt tokens
   and 32-64 new tokens; its decode step compiled, captured once and
   replayed). Launch counts (a replay adds the captured step's) are zeroed
   just before and read just after; every serving kernel must have
   launched, flash_fwd and the decode head on their tensor-core routes
   every time, rmsnorm on its 16-byte vector route every time, every
   request complete, every logit of the compiled step's outputs finite;
5. where the serving time goes: eight decode steps of a full engine on the
   host clock and under ``torch.profiler``, with the eager step and then
   the compiled one in one call (device busy share, top device ops, the
   rmsnorm and paged decode kernels' rows from the eager profile; the
   graph's device time from CUDA events around back-to-back replays), and
   one admission prefill;
6. the training path: the full 16-layer bf16 llama3_2_1b through
   ``TrainLoop`` (global batch 4, seq_len 1024, 6 steps, no checkpoints)
   through the compiled train step (``build_train_step``: one eager step,
   one capture, replays), beside two eager runs of the same loop from the
   same initial state (``train_three_ways``). Launch counts are zeroed just
   before the compiled run and read just after;
   every training kernel (and rmsnorm, flash_fwd) must have launched, the
   bf16 CE forward and backward, flash_fwd and flash_bwd on their
   tensor-core routes every time, flash_delta on its 16-byte vector route
   every time, every loss be
   finite; its losses, gradient norms and final parameters equal the eager
   runs' bit for bit where those are (else within their own difference);
   its graph's kernel nodes hold every launch its capture counted, the
   backward's too; then a 2-layer copy through ``TrainLoop`` with
   checkpoints at steps 2 and 3, whose latest must restore bit-equal to the
   parameters and optimizer state saved; then the 2-layer copy with
   ``accum_steps=2`` eager twice and compiled from one state (held the
   same way, its graph checked), and its loss through the einsum head
   (``fused_head=False``) with ``ce_chunks=4`` and without, within
   UNFUSED_REL of the fused head's;
7. where the training time goes: the host's enqueue time (until
   ``train_step`` returns, before the synchronize), one eager train step
   on the host clock and under ``torch.profiler`` (the tensor-core CE
   forward's and backward's launches and flash_bwd's two kernels among its
   device rows, each with its TFLOP/s); the ``[train compiled]`` line:
   the capture's seconds, host ms a step eager and compiled, the graph's
   device ms (CUDA events around back-to-back replays), busy share,
   tokens/s, peak allocated and reserved memory eager and compiled; one
   eager step with ``remat`` "none" (twice), "full" and "dots" at the
   learning rate 0 (peak memory, ms, launch counts; the loss and gradient
   norm within the "none" steps' difference);
8. per-kernel times at the main paths' shapes beside their bound, the
   plain version's time and one library call's time (null where no single
   PyTorch call computes the function), flash_fwd and rmsnorm also at the
   train step's shape, flash_decode also at paligemma's d = 256, g = 8 and
   ssm_scan at falcon's prefill shape; the device time alone of flash_fwd,
   rmsnorm, paged decode, flash_decode, ssm_scan, flash_delta and the app
   kernels fd2d, sem_apply and dg_volume, their GB/s (the
   scan's exponentials/s), and the host cost of the pieces of one rmsnorm
   and one flash_decode call; the decode head, the CE forward, flash_bwd and the ring step
   forward also on their CUDA-core kernels on the same inputs (a copy 2
   bytes off the alignment the tensor-core route needs), their bf16 outputs
   held to the full-width limits; the tensor-core kernels' TFLOP/s, the
   decode head's GB/s;
9. the apps path, its drivers building their kernels through the host
   API on ``Device("cuda")`` (the bound hand-written kernels), launch
   counts zeroed just before and read just after,
   each app kernel launched exactly as often as its calls say (sem_apply
   on its templated instance every time): ``FDWave``
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
    ``generate`` (8 prompts of 512 tokens, 64 new, its decode step a CUDA
    graph; launch counts zeroed just before and read just after,
    flash_decode exactly 48 x 64), where its decode step's time goes (host
    clock, profiler), its decode step eager and compiled on the same
    prompts (``compiled_static_pair``, as for every static model below:
    16 greedy steps each way, tokens and launch counts equal, logits
    compared bit for bit; eager and compiled host ms, the graph's device
    ms, busy share, tokens/s and the capture's time), and prefill with 16
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
    on the CPU only (``tests/test_torch_ring.py``, gloo);
14. the whole 27-layer bf16 deepseek_v2_lite through ``generate`` (4
    prompts of 512 tokens, 32 new; launch counts zeroed just before and
    read just after): flash_fwd exactly 27, all on the tensor cores,
    flash_decode 0 (the absorbed decode is matmuls), rmsnorm 33 x (3 x 27
    + 1) and the decode head 33; its decode step's profile beside the
    bytes of weights the step reads; prefill's last logits against
    forward's (5% of the largest logit), every logit finite, and the gather
    dispatch against the einsum's at every MoE layer, teacher forced (both
    fed the einsum model's input to that layer; MOE_TWIN_REL of each
    token's largest output);
15. the same for mixtral_8x22b at 4 of its 56 layers (every width as
    published): flash_fwd exactly 4, flash_decode 4 x 32, rmsnorm
    33 x (2 x 4 + 1); then (8) flash_fwd at deepseek's prefill shape (d_qk
    192, d_v 128) and at mixtral's, and flash_decode at mixtral's decode
    shape, each held against its plain version and timed;
16. bf16 zamba2_7b at full width and 45 of its 81 layers (7 groups of 6
    and the tail of 3, as the whole model's 13 groups and tail; cut for
    the smoke's time) through ``generate`` (4 prompts of
    512 tokens, 32 new; launch counts zeroed just before and read just
    after): ssm_scan exactly 45 (n = 64), flash_fwd exactly 7 (d = 112,
    all on the tensor cores), flash_decode 7 x 32, rmsnorm 33 x (45 + 2 x
    7 + 1), the decode head 33; its decode step's profile; on three
    prompt sets, each mamba2 mixer's and each shared-attention
    application's decode against its forward, teacher forced (3% of the
    token's largest output), with planted cache faults reading above that
    at every layer, every logit finite; ``forward`` on B = 1, S = 2048 (ssm_scan exactly 45) against
    prefill's last logits; then (8) ssm_scan at its forward and prefill
    shapes and flash_fwd at its prefill shape, held and timed;
17. the whole 18-layer bf16 paligemma_3b (launch counts zeroed just before
    each run and read just after, each exact; flash_fwd and the decode
    head on their tensor-core routes every time): the engine on phase 4's
    traffic (8 slots, page 512; flash_fwd 18 a prefill, paged_decode 18 a
    step at d = 256, g = 8) and its decode step's profile; ``generate``
    on the static path (4 prompts of 512 tokens, 32 new; flash_decode
    18 x 32) and its profile; a prefill of 4 x (256 vision-stub prefix
    embeddings + 512 tokens), one decode step and 16 greedy steps
    (flash_fwd 18, flash_decode 18 x 17), the prefill against forward over
    the same sequence (1e-3) and the decode step against forward one token
    longer (5% of the largest logit); tokens/s, host ms a step against
    busy ms, prefill ms, parameters and peak memory; then (8) flash_fwd at
    its prefix-LM prefill shape and paged decode at d = 256 over the
    serving step's lengths, held and timed. Phase 2a holds flash_fwd at
    d = 256 and under the prefix mask (prefix 0, off the tile, a whole
    tile, past Sq; with and without a window; d 64/128/256) on both
    kernels, shows that a prefix held against the causal-only plain
    version fails and holds paged decode at d = 256, g = 8 in f32 and
    bf16 at every split length; phase 3 runs paligemma at full width with
    2 layers in f32, card vs CPU (prefill over 256 prefix embeddings
    within 1e-3 of the largest logit; 8 greedy tokens equal on the engine
    and the static path, and engine == static);
18. training the wide architectures in bf16 through ``TrainLoop`` (4
    steps each, no checkpoints, through the compiled train step beside
    two eager runs, held and checked as in phase 6; launch counts zeroed
    just before each compiled run and read just after, each exact:
    flash_fwd, flash_delta and flash_bwd
    once an attention layer a step, on the tensor cores and the vector
    route; the CE head once a step; ssm_scan once a mamba2 layer a step;
    every loss and gradient norm finite; tokens/s, step ms, peak memory,
    a profiled eager step's split and the ``[train compiled]`` line): the
    whole paligemma_3b (B = 4, 256
    prefix embeddings + 512 tokens), deepseek_v2_lite at 4 layers (1
    dense + 3 MoE; B = 4 x 512), zamba2_7b at 7 (6 mamba2 layers with the
    shared block, a tail of 1; B = 2 x 512); then (8) flash_bwd at their
    training shapes, held (dq 2^-7 of its largest, dk and dv 1e-3 of each
    row's largest) and timed beside autograd of SDPA. Phase 2a holds
    flash_bwd and the flash_attention gradient at d 112, 128, 256 and
    (192, 128), groups 8 and 1, ragged Sq != Skv, prefix 0 / off the tile
    / a tile / past Sq with and without a window, and dead rows, on both
    routes (bf16 views on the tensor cores at 2^-7 / 1e-3, f32 on the
    CUDA cores at 1e-4 of the largest), shows a prefix gradient held
    against the causal-only plain backward failing, and wants the ring
    to refuse f32 d = 112 and 256 gradients before any launch; phase 3 holds
    the f32 training loss (1e-4) and every gradient (1e-3 of its largest)
    card vs CPU for 2-layer paligemma, deepseek (its CPU MoE layers
    routed as the card's, teacher forced; the smallest router gap
    printed) and 3-layer zamba2.
20. (run after 10) the kernel language and the OCCA host API: the six
    specs bound to hand-written kernels (fd2d, sem_ax, dg_swe_volume,
    dg_swe_surface at the apps path's shapes, matmul at 4096 x 2048 @
    2048 x 8192 bf16, rmsnorm at 8 x 2048 bf16) built on the cuda, torch
    and loops backends from one builder: each cuda Kernel call launches
    its wrapper's kernel once and writes its Memory output in place, and
    matches the torch expansion on the card and the plain version; the
    loops expansion at a small shape matches the kernel there; an
    unbound spec and a refused define raise in ``build_kernel``; the host
    us a call through a Kernel against the wrapper, and of an FD step
    through the Kernel and swap chain.
21. (run after 20) the ops over their builders: each of the 13
    registered ops on CUDA tensors (backend auto: its spec's cuda
    binding) at the main paths' full shapes, its outputs bit-equal to its
    wrapper's direct call and the wrappers' launch counts moved exactly as
    that call moves them; flash_attention's o, dq, dk, dv through its
    OpVJP (the delta and backward builders) and lm_head_ce's loss, dx, dw
    through its OpVJP (the CE backward builder) bit-equal to the wrappers'
    autograd; ssm_scan's gradients through ``selective_scan_assoc`` at
    zamba2's 2 x 512 (dm 7168, n 64) in f32 within 1e-3 of max |g| of
    autograd through ``selective_scan_ref``. The eleven specs of the
    attention, head and scan builders built on the cuda backend and held
    against their torch expansion on the card (f32 1e-4 of max |ref|,
    bf16 inputs 2^-7), at the full shapes (the torch expansion's tiles
    chosen large: they do not change its function); an f32 ring backward
    at d = 112 refused inside ``build_kernel``; ``python -m
    repro_torch.lint_kernels --strict --cost`` in process (exit 0); each
    bound spec's cost model at its kernel's row shape (``[lang cost]``,
    printed at the end beside the row's bound) and the shared memory a
    block of its kernels really takes, from the profiler's kernel records
    (``[lang smem]``); the host us of an op call over its wrapper's at the
    decode shapes (``[lang host]``).
22. (run after 19) the mesh: two ranks spawned on the card, joined over
    gloo (a file rendezvous; ``nvidia-smi``'s compute mode printed first;
    the kernels built in phase 1 load in each). They serve the whole bf16
    llama3_2_1b through ``Engine(mesh=)`` on a (data 1, model 2) mesh (8
    slots, phase 4's first 8 prompts, 16 new tokens each): both ranks
    emit the same tokens, the first decode step's gathered logits are
    held against the one-rank engine's in this process, teacher forced
    (each within 2^-4 of the largest |logit|; the argmax equal wherever
    the top-2 gap exceeds twice the largest error). They train llama3_2_1b
    at full width, 2 layers, f32, global batch 2 x 1024, 3 steps in three
    layouts, (1, 2), (2, 1) with zero1, (2, 1) with fsdp, each held
    against the one-rank step on the same init and batches here (losses
    and gradient norms within 1e-5 relative, each parameter leaf's
    position-weighted sums within 1e-5 of their size). Each rank's launch
    counts, zeroed before and read after each run, equal the one-rank
    run's for rmsnorm, flash_fwd, paged_decode and the decode head
    (serving) and rmsnorm, flash_fwd, flash_bwd, flash_delta, lm_head_ce
    and lm_head_bwd (training); every sharded step records its eager run.
    While the ranks start: the one-rank train reference and the ring
    step kernels at d = 112 and 256 (bf16, the tensor cores:
    ``ring_flash_wide.cu``) against their plain versions. After them:
    paged decode at 4 kv heads, the decode head on a 64128-column vocab
    shard (two shards' argmaxes combined at the offset), the CE forward
    and backward on a shard with labels outside it (bf16 and f32), held
    against their plain versions and timed (``[time] ...@tp`` rows); last
    a ``[mesh time]``
    line with the phase's seconds and each rank's step host ms and
    collective ms (gloo on one host, not NCCL).
23. (run after 22) every kind on the mesh: two ranks spawned on the card
    as in 22; while they start this process makes the one-rank f32 train
    references, then lets them go. On (data 1, model 2) each rank draws
    the weights leaf by leaf in the one-rank order, keeping its shard
    (``LM.init(placements=)``), and serves 4 of phase 4's prompts cut to
    32 tokens, 6 new tokens each: the whole bf16 deepseek_v2_lite through
    ``generate(mesh=)`` (MLA, 32 experts a rank), the whole paligemma_3b
    through ``Engine(mesh=)`` (its one kv head replicated in the pools)
    and through the static path after the 256-embedding prefix (the
    prefill's cache moved into the decode layout: the sequence split,
    ``flash_decode`` with lse on each half, merged by lse), falcon_mamba_7b
    at 8 and zamba2_7b at 13 layers through ``generate(mesh=)``. Both
    ranks emit the same tokens. Each run's first decode step keeps its
    input state on the host (the cache it read, whole; its tokens; each
    block's input; the MoE routing); after the ranks, each model once on
    one rank (each freed before the next: deepseek's whole one-rank copy
    never sits beside the ranks) repeats the run (each rank's launch
    counts equal its: rmsnorm, flash_fwd, flash_decode, paged_decode,
    ssm_scan, the decode head) and that first step from the ranks' state,
    teacher forced by layer and routing (bf16 sums in another order move
    a random-init deepseek's later routers across near ties, and the
    rounding compounds over 27 layers): each block's output and the
    whole logits within 2^-4 of the largest |value| (the argmax rule of
    22). paligemma's merged attention on the real shards is held against
    one ``flash_decode`` on the gathered cache, with the query past the
    second shard too. The ranks train deepseek_v2_lite at 2 layers (2 x
    512) and zamba2_7b at one group (2 x 256), f32, 3 steps, against the
    one-rank steps (22's limits and counts), and run llama3_2_1b's 4 dense
    blocks in f32 as 2 pipeline stages (4 microbatches of 1 x 256) against
    the sequential run (outputs and gradients within 1e-5). Then the
    kernels at the shard shapes against their plain versions and timed
    (``[time] flash_decode@sp``, ``paged_decode@ptp``, ``flash_fwd@mtp``,
    ``ssm_scan@tp``, ``ssm_scan@ztp``); a ``[tp time]`` line gives each
    rank's step host ms, collective ms, bytes gathered a step and peak
    memory (gloo on one host, not NCCL).

The last three lines of standard output are the card's name and power
limit, a JSON object with one entry per kernel, and the result line.
"""

from __future__ import annotations

import dataclasses
import functools
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
    "flash_delta": ("cuda", "src/repro_torch/csrc/flash_delta.cu",
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
# the compiled train step's graph device time: CUDA events around this many
# back-to-back replays
TRAIN_REPLAYS = 2
# the einsum head's loss (fused_head=False, f32 products of the bf16 hidden
# states and head) against the fused CE head's on a 2-layer llama3_2_1b:
# the same products summed in another order (the tensor cores truncate each
# k16 step's add), ~1e-6 of the loss expected
UNFUSED_REL = 1e-4
APP_KERNELS = ("fd2d", "sem_apply", "dg_volume", "dg_surface")
RING_KERNELS = ("ring_flash_fwd", "ring_flash_bwd", "matmul")
# the apps main path: the FD wave on 8192^2 (radius 4, 200 steps), the SEM
# operator on 32^3 elements of N = 7 (each apply timed over SEM_REPEATS
# calls), the DG solver on 2 x 256^2 triangles of N = 5 (100 LSERK steps)
FD_SIZE, FD_RADIUS, FD_STEPS = 8192, 4, 200
SEM_ELEMS, SEM_N, SEM_REPEATS, SEM_SOLVE_ELEMS = 32, 7, 5, 8
DG_NX, DG_N, DG_STEPS = 256, 5, 100
# autotuning: REPRO_CACHE_DIR is a fresh directory of this run, so every
# phase before 9a runs on the ops' rules and defaults. Phase 9a tunes the
# apps at the apps path's shapes (FD 8192^2 radius 4, SEM 32^3 and the
# PCG's 8^3 at N = 7, DG 2 x 256^2 at N = 5), phase 19 the ops of a
# granite_3_8b engine (8 slots, max_len 2048)
APPS_TUNE_ARGV = ["--apps", "--fd-size", str(FD_SIZE), "--fd-radius",
                  str(FD_RADIUS), "--sem-elems", str(SEM_ELEMS),
                  str(SEM_SOLVE_ELEMS), "--sem-n", str(SEM_N), "--dg-nx",
                  str(DG_NX), "--dg-n", str(DG_N)]
GRANITE_SLOTS, GRANITE_MAX_LEN = 8, 2048
# the decode probe's live lengths come from the untuned run's traffic
# (--paged-lens: the step whose live lengths sum to the median of all steps)
GRANITE_TUNE_ARGV = ["--arch", "granite_3_8b", "--serve", "--batch",
                     str(GRANITE_SLOTS), "--max-len", str(GRANITE_MAX_LEN),
                     "--prompt-len", "1000"]
# granite's engine on the tuned split against the untuned one, each decode
# row of a request whose tokens still agree: the limit on max |logit
# difference| over the row's largest |logit|. A split changes the order of
# paged decode's merge, so bf16 rounds differently through 40 layers: that
# read at most 2.370e-02 on the H100; a faulty split, the merge of the
# first range dropped, read at least 3.392e-01 (PERF.md). The limit sits
# near their geometric middle, and the control runs in every smoke and must
# fail it. A token may differ only at a near tie: where the untuned top-2
# gap is within the same limit of the row's largest |logit|
GRANITE_REL = 0.1
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
# the MoE and MLA paths: deepseek_v2_lite whole (27 layers) and
# mixtral_8x22b at 4 of its 56 layers, every width as published, each on 4
# prompts of 512 tokens, 32 new
MOE_BATCH, MOE_PROMPT, MOE_GEN, MIXTRAL_LAYERS = 4, 512, 32, 4
# gather vs einsum dispatch on one MoE layer's same input: the limit on
# max |gather - einsum| over the largest |einsum| of the token's row. The
# H100 read 1.29-1.67% at deepseek_v2_lite's 26 MoE layers and 0.78% (one
# bf16 step) at mixtral's (the einsum rounds its combine once, the gather
# each of k index_add_ steps); a gather that drops a choice reads ~100%
MOE_TWIN_REL = 0.04
# the hybrid path: zamba2_7b at 45 of its 81 mamba2 layers (the shared
# attention block 7 times, a tail of 3: the whole model's structure; cut
# from 81 by PR 33 to keep the smoke under 600 s on a slow host) on 4
# prompts of 512 tokens, 32 new, and a forward of B = 1, S = 2048
ZB_BATCH, ZB_PROMPT, ZB_GEN, ZB_FWD_SEQ = 4, 512, 32, 2048
ZB_LAYERS = 45
# decode against the forward, teacher forced at each mamba2 mixer and each
# application of the shared attention (``_DecodeTwin``), on ZB_TWIN_SEEDS
# prompt sets of 2 x 64 tokens and one decode step: the limit on max
# |decode - forward| over the largest |forward| of the token's row. Each
# planted cache fault must read above it at every layer. The H100 read at
# most 0.50% (mixers) and 0.76% (attention) on five prompt sets, and the
# planted faults at least 10.25% (SSD state zeroed), 67.5% (conv tail one
# row late) and 10.65% (attention one position early)
ZB_TWIN_REL, ZB_TWIN_SEEDS = 0.03, (71, 74, 75)
# the vision-language path: paligemma_3b whole (18 layers, 8 query heads of
# 256 over one kv head, vocab 257216) on the engine's serving traffic, on
# the static path (4 prompts of 512 tokens, 32 new) and through a prefill
# of 4 x (256 vision-stub prefix embeddings + 512 tokens) with 16 greedy
# steps after it
PG_BATCH, PG_PROMPT, PG_GEN, PG_STEPS = 4, 512, 32, 16
# each static model's decode step eager and compiled on the same prompts
# (compiled_static_pair): STEP_PAIR_STEPS greedy steps each way. The logits
# are compared bit for bit; were they not equal (cuBLAS may pick another
# kernel on the capture's stream), a difference past STEP_PAIR_REL of the
# largest |logit| fails. The H100 gave equal bits at every reduced program
# of the card tests
STEP_PAIR_STEPS, STEP_PAIR_REL = 16, 1e-3
# the device kernel that a wrapper of the decode steps runs once a launch
# (substrings of its mangled name; the split-K decode kernels and the LM
# head also run a combine or reduce kernel after it): a compiled step's
# CUDA graph must hold each wrapper's kernel as often as its capture
# counted the wrapper (check_graph_kernels)
LAUNCH_KERNEL = {
    "rmsnorm": ("rmsnorm_vec_kernel", "rmsnorm_elem_kernel"),
    "paged_decode": ("paged_decode_split_kernel",),
    "flash_decode": ("flash_decode_split_kernel",),
    "lm_head": ("lm_head_reduce",),
    # the train steps' wrappers: flash_fwd's forward on either route (the
    # ring's shares fwd_tc_kernel, but no compiled step runs the ring),
    # flash_bwd's dq kernel, the CE forward's merge (both routes), the CE
    # backward's first product (its dl epilogue) or CUDA-core dlogits
    "flash_fwd": ("fwd_tc_kernel", "flash_fwd_kernel",
                  "flash_fwd_wide_kernel"),
    "flash_delta": ("delta_vec_kernel", "delta_scalar_kernel"),
    "flash_bwd": ("dq_tc_kernel", "dq_kernel"),
    "lm_head_ce": ("ce_merge_kernel",),
    "lm_head_bwd": ("DlEpi", "ce_dlogits_kernel"),
    "ssm_scan": ("ssm_scan_kernel",),
}
# phase 18, training the wide architectures through TrainLoop in bf16:
# (arch, config changes, global batch, attention layers, mamba2 layers);
# seq_len WT_SEQ tokens (paligemma's 256 prefix embeddings come on top),
# WT_STEPS steps each
WIDE_TRAIN = (("paligemma_3b", {}, 4, 18, 0),
              ("deepseek_v2_lite", dict(n_layers=4), 4, 4, 0),
              ("zamba2_7b", dict(n_layers=7), 2, 1, 7))
WT_SEQ, WT_STEPS = 512, 4
# phase 8's flash_bwd rows at those models' training shapes: (row, B, S,
# H, Hk, d_qk, d_v, prefix_len)
WIDE_BWD_SHAPES = (("flash_bwd@paligemma", 4, 768, 8, 1, 256, 256, 256),
                   ("flash_bwd@mla", 4, 512, 16, 16, 192, 128, 0),
                   ("flash_bwd@zamba", 2, 512, 32, 32, 112, 112, 0))


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
    from repro_torch.parallel import GraphStep
    from repro_torch.serving import Engine

    eng = Engine(model, params, batch=8, max_len=2048)
    if eng.page_size != 512:
        fail(f"engine page size {eng.page_size} != 512")
    step = eng._step
    if not isinstance(step, GraphStep):
        fail(f"engine step {type(step).__name__}: want the compiled step")
    bad = torch.zeros((), dtype=torch.int64, device=model.device)
    calls = {"prefill": 0, "decode": 0}
    prefill = model.prefill

    def checked_prefill(p, t, max_len=None):
        logits, cache = prefill(p, t, max_len)
        bad.add_((~torch.isfinite(logits)).sum())
        calls["prefill"] += 1
        return logits, cache

    def checked_step(p, c, t):
        # the compiled step's outputs, read after each replay (the next
        # one overwrites them)
        nxt, logits, c = step(p, c, t)
        bad.add_((~torch.isfinite(logits)).sum())
        calls["decode"] += 1
        return nxt, logits, c

    model.prefill, eng._step = checked_prefill, checked_step
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
        del model.prefill
    if step.captures != 1:
        fail(f"engine step captured {step.captures} times, want once")
    check_graph_kernels("serving path: engine step", step.counts)
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
    """Where the time of the main path goes, for the eager and the compiled
    engine step side by side in one call: a fresh engine fills its 8 slots
    (no slot retires inside the window), then ``nsteps`` decode steps run
    once on the host clock and once under ``torch.profiler``, first with
    the eager ``paged_greedy_step`` in the engine, then with the engine's
    own compiled step (captured at its second step). The compiled step's
    device time comes from CUDA events around ``nsteps`` back-to-back
    replays (``replay_ms``; the profiler's count of a replay's device
    events is printed beside the eager step's), its per-kernel breakdown
    from the eager profile; its graph must hold each hand-written kernel
    as often as the capture counted it (``check_graph_kernels``). Also
    the host time of one B=1 prefill of the longest prompt. Returns
    {"eager_ms", "eager_busy_ms", "graph_ms", "graph_dev_ms"}: host and
    device ms a step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving import Engine

    name, out, events = model.cfg.name, {}, {}
    for mode in ("eager", "compiled"):
        eng = Engine(model, params, batch=8, max_len=2048)
        if mode == "eager":
            eng._step = lambda p, c, t: model.paged_greedy_step(p, t, c)
        for p, _ in reqs[:8]:
            eng.submit(p, 64)
        for _ in range(3):                     # admissions, then warm steps
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
        events[mode] = (sum(r[1] for r in rows), busy_ms)
        if mode == "eager":
            log(f"[profile] {name} decode step (8 slots, "
                f"{model.cfg.n_layers} layers), eager: host {step_ms:.3f} "
                f"ms/step ({prof_step_ms:.3f} under the profiler); device "
                f"busy {busy_ms:.3f} ms/step = "
                f"{100 * busy_ms / step_ms:.1f}% of the unprofiled step, "
                f"idle {100 * (1 - busy_ms / step_ms):.1f}%")
            for ms, n, key in rows[:12]:
                log(f"[profile]   {ms:8.4f} ms/step  {n:4d} calls/step  "
                    f"{key[:90]}")
            for kern in ("paged_decode", "rmsnorm"):
                mine = [r for r in rows if kern in r[2]]
                if not mine:
                    fail(f"profile: no {kern} kernel among the decode step's "
                         "device rows")
                for ms, n, key in mine:
                    log(f"[profile] {kern}: {ms:8.4f} ms/step  {n:4d} "
                        f"calls/step  {key[:80]}")
            out.update(eager_ms=step_ms, eager_busy_ms=busy_ms)
        else:
            if eng._step.captures != 1:
                fail(f"profile: the engine step captured "
                     f"{eng._step.captures} times, want once")
            check_graph_kernels(f"{name} engine step", eng._step.counts)
            tok = torch.from_numpy(eng._pending.reshape(-1, 1)).to(
                model.device)
            dev_ms = replay_ms(eng._step, eng.params, eng.cache, tok, nsteps)
            eager_ms = out["eager_ms"]
            log(f"[profile] {name} decode step (8 slots), compiled: host "
                f"{step_ms:.3f} ms/step ({prof_step_ms:.3f} under the "
                f"profiler) against eager {eager_ms:.3f}; graph device "
                f"{dev_ms:.3f} ms/replay (CUDA events around {nsteps} "
                f"back-to-back replays) = {100 * dev_ms / step_ms:.1f}% of "
                f"the compiled host step, idle "
                f"{100 * (1 - dev_ms / step_ms):.1f}%; "
                f"{8e3 / step_ms:.1f} tok/s against eager "
                f"{8e3 / eager_ms:.1f}; the profiler recorded "
                f"{events[mode][0]} device events/step ({busy_ms:.3f} ms) "
                f"against eager's {events['eager'][0]} "
                f"({events['eager'][1]:.3f} ms)")
            out.update(graph_ms=step_ms, graph_dev_ms=dev_ms)
        del eng

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
    return out


def replay_ms(step, params, cache, tok, n):
    """The device time of one call of a compiled step (a CUDA graph's
    replay) from CUDA events around ``n`` back-to-back calls, each fed the
    last call's tokens with no host read between them: the host enqueues
    a replay in far less than the graph runs, so the events time the
    device. Each call advances the cache, as serving would."""
    import torch

    tok = step(params, cache, tok)[0][:, None]
    torch.cuda.synchronize()
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    s.record()
    for _ in range(n):
        tok = step(params, cache, tok)[0][:, None]
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / n


_GRAPH = [None]   # a weak reference to the last graph steps.capture made


def keep_graphs():
    """Route ``parallel.steps.capture`` through a CUDA graph that keeps its
    description (``keep_graph=True``, instantiated right after the capture
    as the default graph is), so ``check_graph_kernels`` can list the
    nodes of the last one; the graph is held by a weak reference only."""
    import weakref

    import torch

    from repro_torch.parallel import steps

    def capture(fn):
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(graph):
            out = fn()
        graph.instantiate()
        _GRAPH[0] = weakref.ref(graph)
        return graph.replay, out

    steps.capture = capture


def check_graph_kernels(tag, counts):
    """Hold a compiled step's launch counts against its CUDA graph, the
    last one captured: its kernel nodes (``debug_dump``, one label line a
    node, ``ID | n (topoId: m) | <mangled name><<<grid, block, smem>>>``)
    must hold each wrapper's once-a-launch kernel (LAUNCH_KERNEL) as often
    as the capture counted the wrapper (``counts``, a compiled step's
    ``counts``: what a replay adds to the counts), and no other wrapper's
    kernel. A replay runs every node once, so the replayed counts are read
    off the graph, not only carried over from the capture's Python. (The
    profiler cannot count them: it drops device records, eager ones too.)
    Returns the number of kernel nodes."""
    import re

    want = {name: k for name, (k, _) in counts.items()}
    unknown = set(want) - set(LAUNCH_KERNEL)
    if unknown:
        fail(f"{tag}: no device kernel known for {sorted(unknown)}")
    graph = _GRAPH[0]() if _GRAPH[0] is not None else None
    if graph is None:
        fail(f"{tag}: no kept CUDA graph to read")
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "graph.dot")
        graph.debug_dump(path)
        with open(path) as f:
            names = re.findall(r"ID \| \d+ \(topoId: \d+\) \| ([^\s|}]+)",
                               f.read())
    seen = {}
    for name, keys in LAUNCH_KERNEL.items():
        k = sum(any(key in n for key in keys) for n in names)
        if k:
            seen[name] = k
    if seen != want:
        fail(f"{tag}: the CUDA graph's {len(names)} kernel nodes hold "
             f"{seen} hand-written kernels; the capture counted {want}")
    log(f"[compiled] {tag}: the graph's {len(names)} kernel nodes hold "
        f"the captured launches, {dict(sorted(seen.items()))} a replay")
    return len(names)


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


def device_ms(fn, kernel, n=20, launches=None):
    """The device time of one call's launches of ``kernel`` (a substring of
    the CUDA kernel's name), from ``torch.profiler``'s device rows over n
    calls: the kernel alone, without the host gaps that cuda_ms's
    back-to-back calls measure when a call is shorter than its wrapper's
    Python. A session that records no device event at all (the profiler
    does so now and then late in a long run, and then goes on doing so) is
    run again, up to three times, and then the call is timed by event_ms
    instead, with a line that says so; a session whose device rows lack
    ``kernel`` fails at once. Given ``launches`` (the kernel's launches a
    call), a session that recorded fewer than launches * n of them is not
    trusted either: the call is timed by event_ms, with a line that says
    how many the profiler saw."""
    import torch
    from torch.autograd import DeviceType
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
    if launches is not None:
        seen = sum(e.count for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and kernel in e.key)
        if seen != launches * n:
            ev = event_ms(fn, n)
            log(f"[time] {kernel}: the profiler recorded {seen} of the "
                f"{launches * n} launches ({ms:.4f} ms a call from them); "
                f"device time {ev:.4f} ms from CUDA events behind a queued "
                "sleep (event_ms)")
            return ev
    return ms


def bound(bytes_, flops, dtype):
    tb, tf = bytes_ / HBM_BPS, flops / PEAK_FLOPS[dtype]
    return (max(tb, tf) * 1e3, "bytes" if tb >= tf else "operations")


def flash_times(q, k, v, iters, plain_iters, profile=True):
    """Causal flash_attention_fwd on q, k, v (the projections' views): the
    call's time back to back (cuda_ms), the kernel's device time alone on
    these inputs and on contiguous copies of k and v (the layout is the
    only difference; ``profile=False`` skips these two profiler runs), the
    plain version's time and SDPA's on contiguous copies of all three."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (flash_attention_fwd,
                                                     flash_fwd_ref)

    qc, kc, vc = (t.contiguous() for t in (q, k, v))

    def run(kk, vv):
        return lambda: flash_attention_fwd(q, kk, vv, causal=True)

    out = dict(
        ms=cuda_ms(run(k, v), iters),
        plain_ms=cuda_ms(lambda: flash_fwd_ref(q, k, v, causal=True),
                         plain_iters, 1),
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            qc, kc, vc, is_causal=True, enable_gqa=True), iters),
        library="F.scaled_dot_product_attention(is_causal, enable_gqa) on "
                "contiguous q, k, v")
    if profile:
        out["device_ms"] = device_ms(run(k, v), "fwd_tc_kernel", launches=1)
        out["device_ms_contig"] = device_ms(run(kc, vc), "fwd_tc_kernel",
                                            launches=1)
    return out


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


def paged_times(dev, cfg, lens, page, num_pages, gen, profile=True):
    """paged_decode at a decode step of ``cfg`` over slots holding ``lens``
    tokens (each layer's pools on shuffled pages, cycled as a step cycles
    them, so L2 does not hold them), held against its plain version first:
    the call's time, the kernel's device time alone, the plain version's
    and the library's (the pages gathered, then SDPA with the mask),
    beside its bound (the live K and V, q and o, the pages' positions and
    the table once each), and the kernel's max |err| (``"err"``).
    ``profile=False`` skips the profiler's device time."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (paged_decode_attention,
                                                     paged_decode_ref)
    from repro_torch.kernels.flash_attention import ops as attn_ops

    bf = torch.bfloat16
    h, hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    b = len(lens)
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

    # held first at full_width_bf16_checks' limits, on the first layer's
    # pools
    kw = dict(block_table=table, kv_len=kv_len, pos_pages=pos)
    err = check_close(
        f"paged bf16 {cfg.name} q ({b},{h},1,{hd}) lens={lens}",
        paged_decode_attention(qd, *pools[0], **kw),
        paged_decode_ref(qd, *pools[0], **kw), atol=2e-2, rtol=2e-2)

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
    out = dict(
        ms=cuda_ms(kernel, iters=64),
        plain_ms=cuda_ms(plain, iters=16),
        library_ms=cuda_ms(library, iters=16), bytes=nbytes,
        library="gather pages + F.scaled_dot_product_attention(attn_mask)",
        shape=f"q ({b},{h},1,{hd}) bf16, pools ({num_pages},{hk},{page},"
              f"{hd}), kv_len {lens}")
    out.update(zip(("bound_ms", "bound_by"), bound(
        nbytes, 4 * h * hd * ntok, "bfloat16")))
    if profile:
        out["device_ms"] = device_ms(kernel, "paged_decode", launches=2)
    out["split"] = attn_ops.paged_split(b, hk, table.shape[1], page)
    out["err"] = err
    del pools
    return out


def time_kernels(dev, cfg, params, sq, lens, page, num_pages):
    """{kernel: dict(ms, plain_ms, bound_ms, bound_by, library_ms)} at the
    main path's shapes: a decode step of len(lens) slots for rmsnorm, paged
    decode and the LM head; the longest admission prefill for flash."""
    import torch
    import torch.nn.functional as F

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

    out["paged_decode"] = paged_times(dev, cfg, lens, page, num_pages, gen)

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


def checkpoint_round_trip(cfg):
    """``TrainLoop``'s checkpoints on a 2-layer bf16 model of ``cfg`` (the
    full model's ~12 GB checkpoints took half of the training phase's
    wall time): 3 steps of 4 x 1024 tokens, a checkpoint at step 2 and the
    final one at 3, then the latest restored into a fresh tree must be
    bit-equal to the parameters and optimizer state the loop returned.
    Returns the restore's seconds."""
    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch import train as train_mod
    from repro_torch.models import LM
    from repro_torch.tree import leaves, tree_map

    model = LM(dataclasses.replace(cfg, n_layers=2))
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_ckpt_", dir=_ckpt_root())
    out = train_mod.TrainLoop(model=model, global_batch=TRAIN_BATCH,
                              seq_len=TRAIN_SEQ, steps=3, ckpt_dir=ckpt,
                              ckpt_every=2, verbose=False).run()
    t0 = time.perf_counter()
    saved = (out["params"], out["opt"])
    template = tree_map(lambda t: torch.empty_like(t, device="meta"), saved)
    step, restored, _ = CheckpointManager(ckpt).restore(template,
                                                        device=model.device)
    if step != 3:
        fail(f"latest checkpoint is step {step}, not 3")
    for a, b_ in zip(leaves(restored), leaves(saved)):
        if a.dtype != b_.dtype or not torch.equal(a, b_.detach()):
            fail("checkpoint restore is not bit-equal to the saved state")
    restore_s = time.perf_counter() - t0
    shutil.rmtree(ckpt, ignore_errors=True)
    return restore_s


def run_train_loop(loop, compiled):
    """``loop.run()`` with ``TrainLoop``'s ``build_train_step`` routed
    through a recorder: the compiled step (``compiled``; it must be a CUDA
    graph step) or the eager ``train_step``, each call timed on the host
    clock to a synchronize, with its peak allocated and reserved memory
    (peaks reset just before) and its gradient norm. Returns (the loop's
    result, {"ms", "peak", "gnorm": one entry a step, "step": the built
    step, "batch": the last step's batch})."""
    import torch

    from repro_torch.launch import train as train_mod
    from repro_torch.parallel import steps

    real = train_mod.build_train_step
    rec = dict(ms=[], peak=[], gnorm=[], step=None, batch=None)

    def build(model, optimizer, **kw):
        step, info = real(model, optimizer, **kw)
        if not info["cuda_graph"]:
            fail(f"{model.cfg.name}: the train step is not compiled")
        if not compiled:
            def step(params, opt_state, batch):
                return steps.train_step(model, optimizer, params,
                                        opt_state, batch, **kw)
        rec["step"] = step

        def timed(params, opt_state, batch):
            torch.cuda.synchronize()
            if compiled and len(rec["ms"]) == 1:
                # the capture's call empties the cache first (as the step
                # does): its reserved peak is the state and the graph's pool
                torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = step(params, opt_state, batch)
            torch.cuda.synchronize()
            rec["ms"].append((time.perf_counter() - t0) * 1e3)
            rec["peak"].append((torch.cuda.max_memory_allocated() / 1e9,
                                torch.cuda.max_memory_reserved() / 1e9))
            rec["gnorm"].append(float(out[3]["grad_norm"]))
            rec["batch"] = batch
            return out
        return timed, info

    train_mod.build_train_step = build
    try:
        out = loop.run()
    finally:
        train_mod.build_train_step = real
    return out, rec


def _digest(params):
    """Two sums of each leaf's bits, computed on the card in chunks: plain
    and weighted by position (int64, wrapping). Equal digests mean equal
    bits but for a collision; copying a whole model's parameters to the
    host to compare them took seconds a run."""
    import torch

    from repro_torch.tree import leaves

    out, chunk = [], 1 << 26
    for p in leaves(params):
        bits = p.detach().reshape(-1).view(
            {2: torch.int16, 4: torch.int32}[p.element_size()])
        plain = weighted = 0
        for i in range(0, bits.numel(), chunk):
            c = bits[i:i + chunk].to(torch.int64)
            plain += int(c.sum())
            weighted += int((c * torch.arange(i + 1, i + 1 + c.numel(),
                                              device=c.device)).sum())
        out.append((plain, weighted))
    return out


def _held_by_eager(tag, eager, compiled):
    """The yardstick for "compiled equals eager": two eager runs from one
    state, ``eager`` = [(losses, gradient norms, params' ``_digest``)] x 2,
    and one compiled run from it, ``compiled`` likewise. Where the eager
    runs are bit-equal, the compiled one must be too; otherwise its losses
    and norms must stay as close to the nearer eager run's as the eager
    runs are to each other (the embedding backward's atomics may reorder
    sums; a digest gives no distance, so the parameters are then not
    compared). Returns the line's description."""
    def diff(x, y):
        return max(abs(u - v) for u, v in zip(x[0] + x[1], y[0] + y[1]))

    if eager[0] == eager[1]:
        if compiled != eager[0]:
            fail(f"{tag}: the eager steps are bit-equal run to run, the "
                 f"compiled ones differ (losses and norms by "
                 f"{diff(compiled, eager[0]):.3e}, parameters' digests "
                 f"{'equal' if compiled[2] == eager[0][2] else 'differ'})")
        return ("compiled = eager bit for bit (the eager runs bit-equal; "
                "parameters by digest)")
    yard = diff(*eager)
    near = min(diff(compiled, e) for e in eager)
    if near > yard:
        fail(f"{tag}: compiled losses and norms differ from eager by "
             f"{near:.3e}, past the eager runs' own {yard:.3e}")
    return (f"compiled within {near:.3e} of eager (losses and norms), eager "
            f"run to run {yard:.3e}")


def train_replay_ms(step, params, opt_state, batch, n=TRAIN_REPLAYS):
    """The device time of one compiled train step: CUDA events around
    ``n`` back-to-back replays with no host read between them (each copies
    the batch in and trains on, as the loop would; the loop's own replays
    warmed the graph)."""
    import torch

    torch.cuda.synchronize()
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    s.record()
    for _ in range(n):
        step(params, opt_state, batch)
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / n


def train_three_ways(tag, make_loop, *, eager_first=2):
    """A model's training main path: ``make_loop()``'s ``TrainLoop`` run
    twice eagerly (the eager step's run-to-run difference, the yardstick)
    and once through the compiled step, each from the seed's initial state
    on the same data: ``eager_first`` eager runs before the compiled one,
    the rest after it, and only if the compiled run is not bit-equal to
    the first eager run (a run equal to one eager run passes whatever the
    second gives, so the verdict is the same). Launch counts are zeroed
    just before the compiled run and read just after. Its losses, gradient
    norms and final parameters (by ``_digest``) are held against the eager
    runs' (``_held_by_eager``); its
    graph must hold each captured kernel launch (``check_graph_kernels``:
    the backward's among them); then its graph's device time
    (``train_replay_ms``). The eager runs' state is dropped, the compiled
    run's step with its graph after the timing. Returns (the compiled
    loop's result, its counts, routes, and stats: "eager" / "compiled"
    records (``run_train_loop``), "hold", "capture_s", "dev_ms", "wall_s",
    "nodes": the graph's kernel nodes)."""
    import torch

    from repro_torch.kernels import launch_counts, reset_launches

    def eager_run():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        out, rec = run_train_loop(make_loop(), compiled=False)
        # the final parameters by digest: the compiled run needs the card's
        # memory for the state and the graph's pool
        eager.append((out["history"], rec["gnorm"], _digest(out["params"]),
                      rec))

    t_start = time.perf_counter()
    eager = []
    for _ in range(eager_first):
        eager_run()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reset_launches()
    t0 = time.perf_counter()
    out, rec = run_train_loop(make_loop(), compiled=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, routes = launch_counts(), route_counts()
    hist = out["history"]
    if not all(map(lambda v: v == v and abs(v) != float("inf"),
                   hist + rec["gnorm"])):
        fail(f"{tag}: non-finite loss or gradient norm: {hist}, "
             f"{rec['gnorm']}")
    t1 = time.perf_counter()
    ran = (hist, rec["gnorm"], _digest(out["params"]))
    if len(eager) == 1 and ran != eager[0][:3]:
        eager_run()
    hold = (_held_by_eager(tag, [e[:3] for e in eager], ran)
            if len(eager) == 2 else
            "compiled = the eager run bit for bit (parameters by digest; the "
            "second eager run not needed)")
    step = rec["step"]
    if step.captures != 1:
        fail(f"{tag}: {step.captures} captures, wanted 1")
    t2 = time.perf_counter()
    nodes = check_graph_kernels(f"{tag} train step", step.counts)
    t3 = time.perf_counter()
    dev_ms = train_replay_ms(step, out["params"], out["opt"], rec["batch"])
    stats = dict(eager=eager[0][3], compiled=rec, hold=hold, wall_s=wall,
                 capture_s=step.capture_s, dev_ms=dev_ms, nodes=nodes)
    n_eager = len(eager)
    del eager, step
    rec["step"] = rec["batch"] = None
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"[train compiled] {tag}: seconds: {n_eager} eager runs "
        f"{t0 - t_start + t2 - t1:.1f} with the comparison, compiled run "
        f"{wall:.1f}, the graph's "
        f"nodes {t3 - t2:.1f}, replays {time.perf_counter() - t3:.1f}")
    return out, counts, routes, stats


def log_train_compiled(tag, stats, tokens, eager_busy_ms):
    """The ``[train compiled]`` line: the capture's seconds, host ms a step
    eager (the eager loop's steps after its first) and compiled (the
    replays after the capture's step), the graph's device ms, its busy
    share of the compiled host step and the eager profile's, tokens/s both
    ways, and peak allocated / reserved memory of an eager step and of the
    capture's step (the graph's private pool beside the state). Returns
    (eager ms, compiled ms)."""
    e, c = stats["eager"], stats["compiled"]
    eager_ms = sum(e["ms"][1:]) / len(e["ms"][1:])
    graph_ms = sum(c["ms"][2:]) / len(c["ms"][2:])
    pe = max(p[0] for p in e["peak"]), max(p[1] for p in e["peak"])
    pc = c["peak"][1]
    log(f"[train compiled] {tag}: capture {stats['capture_s']:.3f} s "
        f"({stats['nodes']} kernel nodes); host ms a step eager "
        f"{eager_ms:.3f} -> compiled {graph_ms:.3f}; graph device "
        f"{stats['dev_ms']:.3f} ms = {100 * stats['dev_ms'] / graph_ms:.1f}% "
        f"busy (eager profile {eager_busy_ms:.3f} ms = "
        f"{100 * eager_busy_ms / eager_ms:.1f}%); {tokens * 1e3 / eager_ms:.1f}"
        f" -> {tokens * 1e3 / graph_ms:.1f} tokens/s; peak allocated / "
        f"reserved eager {pe[0]:.2f} / {pe[1]:.2f} GB, compiled "
        f"{pc[0]:.2f} / {pc[1]:.2f} GB; {stats['hold']}")
    return eager_ms, graph_ms


def two_layer_train_options(cfg):
    """The train step's other options on a 2-layer bf16 copy of ``cfg``
    (B = TRAIN_BATCH x TRAIN_SEQ, seeded weights): ``accum_steps=2`` run
    eagerly twice and through the compiled step (its first call eager, then
    the capture's replay) from one state (a snapshot on the card restored
    before each), held by ``_held_by_eager``, its graph's kernel nodes
    against the capture's counts (every kernel twice: two micro-batches);
    then the einsum head (``fused_head=False``) with ``ce_chunks=4`` (1023
    labels a row: 3 chunks) and with the full logits, each loss within
    UNFUSED_REL of the fused head's (the same bf16 products, summed in
    another order), the gradient norms and peak memory printed."""
    import torch

    from repro_torch.data import SyntheticLMData
    from repro_torch.models import LM
    from repro_torch.optim import AdamW, global_norm
    from repro_torch.parallel import build_train_step
    from repro_torch.parallel.steps import train_step
    from repro_torch.tree import leaves

    t_setup = time.perf_counter()
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    model = LM(cfg2)
    params = model.init(torch.Generator(device=model.device).manual_seed(5))
    for p in leaves(params):
        p.requires_grad_()
    opt = AdamW()
    state = opt.init(params)
    batch = {"tokens": torch.from_numpy(SyntheticLMData(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
        global_batch=TRAIN_BATCH, seed=5).batch(0)).to(model.device)}
    snap = [t.detach().clone() for t in leaves((params, state))]

    def restore():
        with torch.no_grad():
            for t, c in zip(leaves((params, state)), snap, strict=True):
                t.copy_(c)

    t0 = time.perf_counter()
    log(f"[train options] seconds: {t0 - t_setup:.1f} to draw the 2-layer "
        "model and its batch")
    eager = []
    for _ in range(2):
        restore()
        _, _, loss, met = train_step(model, opt, params, state, batch,
                                     accum_steps=2)
        eager.append(([float(loss)], [float(met["grad_norm"])],
                      _digest(params)))
    restore()
    step, info = build_train_step(model, opt, accum_steps=2)
    if not info["cuda_graph"]:
        fail("2-layer accum_steps=2: the train step is not compiled")
    step(params, state, batch)
    restore()
    _, _, loss, met = step(params, state, batch)
    hold = _held_by_eager("2-layer accum_steps=2", eager, (
        [float(loss)], [float(met["grad_norm"])], _digest(params)))
    check_graph_kernels("2-layer accum_steps=2 train step", step.counts)
    log(f"[train options] {cfg.name} 2 layers accum_steps=2 (2 micro-"
        f"batches of {TRAIN_BATCH // 2}x{TRAIN_SEQ}): loss {float(loss)!r}, "
        f"gradient norm {float(met['grad_norm'])!r}; {hold}")
    log(f"[train options] seconds: {time.perf_counter() - t0:.1f} for the "
        "accumulation's eager and compiled steps")
    del step, eager, snap, state

    heads = {}
    for name, m in (("fused", model),
                    ("einsum ce_chunks=4", LM(cfg2, fused_head=False,
                                              ce_chunks=4)),
                    ("einsum", LM(cfg2, fused_head=False))):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        loss, _ = m.loss(params, batch)
        gn = float(global_norm(torch.autograd.grad(loss, leaves(params))))
        torch.cuda.synchronize()
        heads[name] = (float(loss.detach()), gn,
                       torch.cuda.max_memory_allocated() / 1e9,
                       (time.perf_counter() - t1) * 1e3)
    ref = heads["fused"][0]
    for name, (loss, gn, peak, ms) in heads.items():
        if abs(loss - ref) > UNFUSED_REL * abs(ref):
            fail(f"2-layer {name} head: loss {loss} differs from the fused "
                 f"head's {ref} by more than {UNFUSED_REL} of it")
        log(f"[train options] {cfg.name} 2 layers, {name} head: loss "
            f"{loss!r} ({abs(loss - ref) / abs(ref):.2e} of the fused "
            f"head's), gradient norm {gn!r}, peak allocated {peak:.2f} GB, "
            f"loss and gradients {ms:.1f} ms")
    del params
    torch.cuda.empty_cache()


def train_main_path(cfg):
    """Drive ``TrainLoop`` on the full bf16 model (global batch 4, seq_len
    1024, TRAIN_STEPS steps, no checkpoints: checkpoint_round_trip holds
    them on 2 layers) through the compiled step, beside two eager runs
    (``train_three_ways``). Returns (model, launch counts, stats, the
    compiled loop's result)."""
    from repro_torch.launch import train as train_mod
    from repro_torch.models import LM

    model = LM(cfg)

    def make_loop():
        return train_mod.TrainLoop(model=model, global_batch=TRAIN_BATCH,
                                   seq_len=TRAIN_SEQ, steps=TRAIN_STEPS,
                                   log_every=1)

    out, counts, routes, stats = train_three_ways(cfg.name, make_loop)
    hist = out["history"]
    if len(hist) != TRAIN_STEPS or out["final_step"] != TRAIN_STEPS:
        fail(f"training ran {len(hist)} steps to {out['final_step']}")
    for name in TRAIN_KERNELS + ("rmsnorm", "flash_fwd"):
        if counts[name] <= 0:
            fail(f"kernel {name} never launched on the training path")
    if routes["lm_head_bwd"] != {"wgmma": counts["lm_head_bwd"], "simt": 0}:
        fail(f"training path: CE backward routes {routes['lm_head_bwd']}; "
             "every bf16 backward must take the tensor-core route")
    check_tc_routes("training path: flash_fwd", routes["flash_fwd"],
                    counts["flash_fwd"])
    check_tc_routes("training path: CE forward", routes["lm_head_ce"],
                    counts["lm_head_ce"])
    check_tc_routes("training path: flash_bwd", routes["flash_bwd"],
                    counts["flash_bwd"])
    if routes["flash_delta"] != {"vec": counts["flash_delta"], "scalar": 0}:
        fail(f"training path: flash_delta routes {routes['flash_delta']}; "
             "every launch must take the 16-byte vector route")
    steady = stats["compiled"]["ms"][2:]
    stats.update(history=hist, step_ms=stats["compiled"]["ms"],
                 tok_s=TRAIN_BATCH * TRAIN_SEQ * len(steady) / (
                     sum(steady) / 1e3),
                 peak_gb=max(p[0] for p in stats["compiled"]["peak"]))
    return model, counts, stats, out


def remat_steps(cfg, params, opt_state, batch):
    """One eager train step of the full model with each ``remat`` ("none"
    twice: the yardstick) on one state, the AdamW learning rate 0 so that
    the parameters stay as they are (the moments move; the step computes
    all the same): peak allocated and reserved memory (the allocator's
    cache emptied and the peaks reset before each), host ms to a
    synchronize, the step's launch counts (a recomputed layer launches its
    kernels again), and the loss and gradient norm, held by the two "none"
    steps' difference (bit-equal where theirs is)."""
    import torch

    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.models import LM
    from repro_torch.optim import AdamW, WarmupCosine
    from repro_torch.parallel.steps import train_step

    opt = AdamW(schedule=WarmupCosine(peak_lr=0.0))
    runs = []
    for remat in ("none", "none", "full", "dots"):
        model = LM(cfg, remat=remat)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        _, _, loss, met = train_step(model, opt, params, opt_state, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        runs.append((remat, float(loss), float(met["grad_norm"]), ms,
                     torch.cuda.max_memory_allocated() / 1e9,
                     torch.cuda.max_memory_reserved() / 1e9,
                     {k: v for k, v in launch_counts().items() if v}))
    yard = max(abs(runs[0][1] - runs[1][1]), abs(runs[0][2] - runs[1][2]))
    for remat, loss, gn, ms, pa, pr, cnt in runs:
        d = max(abs(loss - runs[0][1]), abs(gn - runs[0][2]))
        if d > yard:
            fail(f"remat {remat}: loss {loss} / gradient norm {gn} differ "
                 f"from none's by {d:.3e}, past none's run to run "
                 f"{yard:.3e}")
        log(f"[remat] {cfg.name} B={TRAIN_BATCH} S={TRAIN_SEQ} remat="
            f"{remat}: one eager step {ms:.3f} ms, peak allocated / reserved"
            f" {pa:.2f} / {pr:.2f} GB; loss {loss!r}, gradient norm {gn!r} "
            f"(within none's run to run {yard:.3e}); launches {cnt}")
    return runs


def profile_train_step(model, params, opt_state):
    """Where an eager train step's time goes (the device work the compiled
    step replays): the host's enqueue time (until ``train_step`` returns)
    against the step's for two steps, then one step under
    ``torch.profiler`` (device-side events only). Returns (host ms, busy
    ms)."""
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
    step_ms = sum(b for _, b in enq) / len(enq)
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
    reset_launches()
    delta_ms = cuda_ms(lambda: flash_delta(do, o), 100)
    check_routes("timed flash_delta", flash_delta, {"vec": 103, "scalar": 0})
    out["flash_delta"] = dict(
        ms=delta_ms,
        device_ms=device_ms(lambda: flash_delta(do, o), "delta_vec_kernel",
                            launches=1),
        plain_ms=cuda_ms(lambda: flash_delta_ref(do, o), 100),
        library_ms=cuda_ms(lambda: (do * o).sum(-1), 100),
        library="(do * o).sum(-1) in bf16",
        bytes=2 * b * h * s * hd * 2 + b * h * s * 4,
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
    (tolerance 2e-5); SEM with E not a multiple of eb, nq in {2, 5, 8} (the
    templated instances) and 11 (the generic kernel), and
    DG with N in {1, 3, 5}, E not a multiple of eb (2e-4 of max|ref|: f32
    contractions summed in another order). Then the two routes of each
    redesigned kernel (small_fd2d_route_checks, small_dg_volume_checks)."""
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
    for E, nq, eb in ((7, 2, 4), (13, 5, 4), (37, 8, 32), (70, 8, 32),
                      (9, 11, 2)):
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
    small_fd2d_route_checks(rnd)
    small_dg_volume_checks(rnd)
    torch.cuda.synchronize()


def check_routes(what, wrapper, want):
    """``wrapper.routes`` since the last reset_launches is exactly want."""
    if dict(wrapper.routes) != want:
        fail(f"{what}: routes {dict(wrapper.routes)}, expected {want}")


def small_fd2d_route_checks(rnd):
    """fd2d at every r 1..8 on fields whose tiles' windows wrap on each
    side: on the "vec" route (w and bw multiples of 4), within 2e-5 of the
    plain version and bit-equal to fd2d_stream_ref (the kernel's own chain
    of f32 roundings) and to the "scalar" route on a copy one float off
    alignment; fields with w % 4 != 0 and a field narrower than the
    stencil on the "scalar" route. Every launch's route is counted."""
    import torch

    from repro_torch.apps.numerics import fd_second_derivative_weights
    from repro_torch.kernels import reset_launches
    from repro_torch.kernels.apps import fd2d, fd2d_ref, fd2d_stream_ref

    reset_launches()
    nvec = nscalar = 0
    for r in range(1, 9):
        wts = tuple(float(x) for x in fd_second_derivative_weights(r))
        for h, w, block in ((40 + r, 64, (16, 32)), (21 + r, 61 + 2 * r,
                                                     (8, 20)),
                            (2 * r + 1, 12, (0, 0)), (5, 3 + r, (4, 0))):
            u1, u2 = rnd(h, w), rnd(h, w)
            dx = 2.0 / w
            dt = 0.3 * dx / 2 ** 0.5
            tag = f"fd2d f32 ({h},{w}) r={r} tile {block}"
            got = fd2d(u1, u2, weights=wts, dx=dx, dt=dt, block=block)
            check_close(tag, got, fd2d_ref(u1, u2, wts, dx, dt), atol=2e-5,
                        rtol=2e-5, quiet=True)
            vec = w % 4 == 0 and min(block[1] or w, w) % 4 == 0
            nvec, nscalar = nvec + vec, nscalar + (not vec)
            if not torch.equal(got, fd2d_stream_ref(u1, u2, wts, dx, dt)):
                fail(f"{tag}: not bit-equal to fd2d_stream_ref")
            if vec:
                other = fd2d(_unaligned(u1), u2, weights=wts, dx=dx, dt=dt,
                             block=block)
                nscalar += 1
                if not torch.equal(got, other):
                    fail(f"{tag}: the vec and scalar routes differ")
    check_routes("fd2d route checks", fd2d, {"vec": nvec, "scalar": nscalar})
    log(f"[check] fd2d r = 1..8, windows wrapping on each side: {nvec} vec "
        f"and {nscalar} scalar launches, each within 2e-5 of the plain "
        "version and bit-equal to fd2d_stream_ref; vec == scalar on the "
        "same values")


def small_dg_volume_checks(rnd):
    """dg_volume at N = 1..8 (np 3..45; N = 8 on the generic instance, and
    np = 4 too), E not a multiple of eb, eb = 1 and eb past a chunk of 128
    elements (at N = 7 and 8 a chunk smaller still, to fit shared memory), q one float off alignment, against volume_ref within 2e-4 of
    max|ref| and volume_folded_ref (the kernel's order) within 2e-5;
    every launch's instance counted."""
    from repro_torch.kernels import reset_launches
    from repro_torch.kernels.apps import (dg_volume, volume_folded_ref,
                                          volume_ref)

    reset_launches()
    want = {"templated": 0, "generic": 0}
    cases = [(n, E, eb) for n in range(1, 9)
             for E, eb in ((37, 8), (13, 1), (300, 200))]
    for n, E, eb in cases + [(None, 29, 4)]:
        np_ = 4 if n is None else (n + 1) * (n + 2) // 2
        q = 0.1 * rnd(E, np_, 3)
        q[..., 0] += 1.5
        args = (q, rnd(E, 4), rnd(E, np_, 2), rnd(np_, np_), rnd(np_, np_))
        for qq in (q, _unaligned(q)):
            got = dg_volume(qq, *args[1:], eb=eb)
            want["templated" if n is not None and n <= 7 else "generic"] += 1
            tag = f"dg_volume f32 np={np_} E={E} eb={eb}" + (
                "" if qq is q else " (q off alignment)")
            check_rel(tag, got, volume_ref(*args), 2e-4, quiet=True)
            check_rel(tag + " vs the folded model", got,
                      volume_folded_ref(*args), 2e-5, quiet=True)
    check_routes("dg_volume checks", dg_volume, want)
    log(f"[check] dg_volume N = 1..8 and np = 4, ragged E, eb 1..200, q "
        f"aligned and not: {want}, each within 2e-4 of volume_ref and 2e-5 "
        "of volume_folded_ref")


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


class _LaunchArgs:
    """Records the arguments of each call of the named C entry points (the
    launch arguments the wrappers pass, tuned knobs among them) while it is
    active: the kernel modules' ``load`` hands out a recording view of each
    library, and the entries the wrappers bind once are unbound before and
    after, so they bind through it."""

    MODULES = {"repro_torch.kernels.apps.fd2d": ("_ENTRY",),
               "repro_torch.kernels.apps.sem": ("_ENTRY",),
               "repro_torch.kernels.apps.dg": ("_VOL_ENTRY",),
               "repro_torch.kernels.flash_attention.ops": ("_DECODE_ENTRY",)}

    def __init__(self, *names):
        self.names, self.calls, self._saved = set(names), [], []

    def __enter__(self):
        rec = self

        class View:
            def __init__(self, lib):
                self._lib = lib

            def __getattr__(self, name):
                fn = getattr(self._lib, name)
                if name not in rec.names:
                    return fn

                def entry(*args):
                    rec.calls.append((name, args))
                    return fn(*args)
                return entry

        for mod, entries in self.MODULES.items():
            m = sys.modules[mod]
            self._saved.append((m, m.load))
            m.load = lambda name, sig, real=m.load: View(real(name, sig))
            for e in entries:
                setattr(m, e, None)
        return self

    def __exit__(self, *exc):
        for m, load in self._saved:
            m.load = load
            for e in self.MODULES[m.__name__]:
                setattr(m, e, None)
        self._saved = []

    def args(self, name):
        return [a for n, a in self.calls if n == name]


def _default_knobs(name, r):
    """The knobs an untuned driver takes at the shapes of tune result
    ``r``: the op's default fitted by ``fit_block``."""
    from repro_torch.core import get_op
    from repro_torch.device import fit_block

    d = get_op(name).defaults
    if name == "fd2d":
        return {"bh": fit_block(d["bh"], r["h"]),
                "bw": fit_block(d["bw"], r["w"])}
    return {"eb": fit_block(d["eb"], r["E"])}


def log_tune_table(results):
    """A ``[tune table]`` line per tuned probe: the default knobs and the
    winner with the sweep's time for each (device ms a launch: CUDA events
    around launches queued behind a sleep), candidates timed, pruned and
    skipped, and the sweep's seconds."""
    from repro_torch.core import get_op

    for name, r in results:
        knobs = sorted(get_op(name).sweep)
        ms = {tuple(c[k] for k in knobs): sec * 1e3 for c, sec in r.trials}
        win = {k: r[k] for k in knobs}
        shape = {k: v for k, v in r.items() if k not in knobs}
        dflt = _default_knobs(name, r) if name in APP_KERNELS else None
        d_ms = ms.get(tuple(dflt[k] for k in knobs)) if dflt else None
        log(f"[tune table] {name} {shape}: "
            + (f"default {dflt} {d_ms:.4f} ms, " if d_ms is not None else "")
            + f"winner {win} {ms[tuple(win[k] for k in knobs)]:.4f} ms; "
            f"{len(r.trials)} timed, {len(r.pruned)} pruned, "
            f"{len(r.skipped) - len(r.pruned)} skipped; sweep "
            f"{r.seconds:.2f} s")


def tune_twice(argv, tag):
    """``tune_cli`` with ``argv`` twice: the first run must time every
    candidate left after pruning (a candidate the wrapper refuses may be
    skipped; one whose outputs miss the plain version's fails the smoke),
    the second must be all cache hits with nothing timed. Returns the
    first run's [(op, TuneResult)]."""
    from repro_torch import tune_cli

    t0 = time.perf_counter()
    code, res = tune_cli.run(argv + ["--repeats", "20"])
    first_s = time.perf_counter() - t0
    if code or not res:
        fail(f"tune_cli {tag}: exit {code}, {len(res)} results")
    for name, r in res:
        bad = [(c, why) for c, why in r.skipped if why.startswith(
            "validation")]
        if r.cached or not r.trials or bad:
            fail(f"tune_cli {tag}: {name} cached {r.cached}, "
                 f"{len(r.trials)} trials, failing candidates {bad}")
    t0 = time.perf_counter()
    code, again = tune_cli.run(argv)
    if code or len(again) != len(res) or any(
            not r.cached or r.trials for _, r in again):
        fail(f"tune_cli {tag}: the second run was not all cache hits")
    log(f"[tune] {tag}: the first run {first_s:.1f}s; the second "
        f"{time.perf_counter() - t0:.2f}s, {len(again)} cache hits, 0 timed "
        "trials")
    log_tune_table(res)
    return res


def apps_main_path(dev, tuned):
    """Drive the three apps once through their entry points at full size,
    their drivers built with ``block=None`` / ``eb=None``: they adopt the
    winners ``tuned`` ({(op, E or (h, w)): knobs}, phase 9a). Launch counts
    are zeroed just before and read just after. Then one more call of each
    driver runs under the launch-argument recorder, apart from the timed
    runs (it wraps every C entry in Python): its launch arguments must
    show the adopted knobs. Then the same runs on the default knobs
    from the same states: bit-equal outputs (the knobs of these kernels
    change no output's arithmetic: ``Op.exact_knobs``), the PCG solve
    (``index_add_``'s atomics sum in no fixed order) within 2e-4 of its
    largest value. Returns (counts, state for the later phases)."""
    import copy

    import numpy as np
    import torch

    from repro_torch.apps.dg_swe import dg_surface_builder, dg_volume_builder
    from repro_torch.apps.fd2d import FDWave, fd2d_builder, fd_flops_per_step
    from repro_torch.apps.sem import (SEMOperator, sem_builder,
                                      sem_flops_per_element)
    from repro_torch.core import get_op
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.launch import apps

    for name in APP_KERNELS:
        if not get_op(name).exact_knobs:
            fail(f"{name}: its knobs are declared to change its arithmetic")
    torch.cuda.synchronize()
    reset_launches()
    t_phase = time.perf_counter()

    # FD: 8192^2, radius 4 (8th order), 200 leapfrog steps
    t0 = time.perf_counter()
    fd = FDWave(width=FD_SIZE, height=FD_SIZE, radius=FD_RADIUS)
    setup_s = time.perf_counter() - t0
    fd_start = (fd.u1.clone(), fd.u2.clone())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fd.run(FD_STEPS)                      # synchronizes the card
    wall = time.perf_counter() - t0
    err = float(np.abs(fd.solution - fd.analytic()).max())
    n2 = FD_SIZE * FD_SIZE
    log(f"[fd] {FD_SIZE}x{FD_SIZE}, radius {FD_RADIUS}, tile {fd.block} "
        f"(tuned: {fd.tuned}), "
        f"{FD_STEPS} steps to t={fd.current_time:.5f}: {wall:.3f}s = "
        f"{1e3 * wall / FD_STEPS:.4f} ms/step, "
        f"{n2 * FD_STEPS / wall / 1e6:.1f} MNodes/s, "
        f"{fd_flops_per_step(FD_SIZE, FD_SIZE, FD_RADIUS) * FD_STEPS / wall / 1e9:.1f}"
        f" GFLOP/s; max|u - analytic| {err:.3e} (setup {setup_s:.1f}s; the "
        "window-staging kernel read 0.5072 ms/step, 132310 MNodes/s on an "
        "H100 80GB HBM3 at 700 W)")
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
    log(f"[sem] E={op.E} ({SEM_ELEMS}^3), N={SEM_N}, eb={op.eb} (tuned: "
        f"{op.tuned}), dofs={op.nglob}: "
        f"apply_local {local_ms:.4f} ms = {flops / local_ms / 1e6:.1f} "
        f"GFLOP/s, apply_global {global_ms:.4f} ms = "
        f"{flops / global_ms / 1e6:.1f} GFLOP/s (host clock, mean of "
        f"{SEM_REPEATS} after one warm call; setup {setup_s:.1f}s)")
    solve = apps.sem_solve(n=SEM_N, elems=SEM_SOLVE_ELEMS, log=log)
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
    for what, drv in (("FDWave", fd), ("SEMOperator", op),
                      ("sem_solve", solve["op"]), ("swe_run", swe["solver"])):
        if drv.occa.backend != "cuda":
            fail(f"{what}: built on {drv.occa!r}, not the cuda backend")
    expected = {"fd2d": FD_STEPS + 200,
                "sem_apply": 3 * (SEM_REPEATS + 1) + 1 + 1 + solve["iters"],
                "dg_volume": 5 * DG_STEPS, "dg_surface": 5 * DG_STEPS}
    for name, want in expected.items():
        if counts[name] != want:
            fail(f"kernel {name} launched {counts[name]} times on the apps "
                 f"path, expected {want}")
    from repro_torch.kernels.apps import dg_volume, fd2d, sem_apply
    check_routes("sem_apply on the apps path", sem_apply,
                 {"templated": expected["sem_apply"], "generic": 0})
    check_routes("fd2d on the apps path", fd2d,
                 {"vec": expected["fd2d"], "scalar": 0})
    check_routes("dg_volume on the apps path", dg_volume,
                 {"templated": expected["dg_volume"], "generic": 0})

    # the tuned knobs, as the drivers took them and as launched: one more
    # call of each driver, recorded (after the counts)
    sol = swe["solver"]
    fd_once = copy.copy(fd)           # its own Memory: swaps stay its own
    fd_once.o_u1, fd_once.o_u2, fd_once.o_u3 = (
        fd.occa.malloc(m.data) for m in (fd.o_u1, fd.o_u2, fd.o_u3))
    with _LaunchArgs(*APP_KERNELS) as rec:
        fd_once.timestep()
        op.apply_local(u_loc)
        solve["op"].apply_global(solve["u"])
        sol.step(swe["Q"], swe["dt"])
        torch.cuda.synchronize()
    del fd_once
    took = {("fd2d", (FD_SIZE, FD_SIZE)): (fd.tuned, fd.block),
            ("sem_apply", op.E): (op.tuned, op.eb),
            ("sem_apply", solve["op"].E): (solve["op"].tuned,
                                           solve["op"].eb),
            ("dg_volume", sol.E): (sol.tuned, sol.eb),
            ("dg_surface", sol.E): (sol.surf_tuned, sol.surf_eb)}
    launched = {}
    for a in rec.args("fd2d"):
        launched.setdefault(("fd2d", (a[4], a[5])), set()).add((a[10], a[11]))
    for name, e_at, k_at in (("sem_apply", 5, 7), ("dg_volume", 7, 9),
                             ("dg_surface", 5, 8)):
        for a in rec.args(name):
            launched.setdefault((name, a[e_at]), set()).add(a[k_at])
    for key, (won, knob) in took.items():
        want = tuned.get(key)
        if won != want:
            fail(f"{key}: the driver took {won}, the tuned winner is {want}")
        knob_want = (want["bh"], want["bw"]) if key[0] == "fd2d" else \
            want["eb"]
        if knob != knob_want or launched.get(key) != {knob_want}:
            fail(f"{key}: launched with {launched.get(key)}, driver knob "
                 f"{knob}, winner {want}")
    log("[tune] apps path on the tuned knobs, as launched: " + ", ".join(
        f"{k[0]}@{k[1]} {sorted(v)}" for k, v in sorted(
            launched.items(), key=str)))

    # the same runs on the default knobs (after the counts: comparisons)
    twin = copy.copy(fd)
    twin.o_u1, twin.o_u2 = (fd.occa.malloc(t) for t in fd_start)
    twin.o_u3, twin.current_time = fd.occa.malloc(fd.u3.shape), 0.0
    dflt = _default_knobs("fd2d", dict(h=FD_SIZE, w=FD_SIZE))
    twin.block = (dflt["bh"], dflt["bw"])
    twin.fd2d = fd.occa.build_kernel(fd2d_builder,
                                     dict(fd.fd2d.defines, **dflt))
    twin.run(FD_STEPS)
    _bit_equal(f"fd2d: {FD_STEPS} steps on the tile {fd.block} and on "
               f"{twin.block}", fd.u1, twin.u1)
    del twin, fd_start
    sem_twin = copy.copy(op)
    sem_twin.eb = _default_knobs("sem_apply", dict(E=op.E))["eb"]
    sem_twin.kernel = op.occa.build_kernel(
        sem_builder, dict(op.kernel.defines, eb=sem_twin.eb))
    _bit_equal(f"sem_apply E={op.E}: eb {op.eb} and {sem_twin.eb}",
               op.apply_local(u_loc), sem_twin.apply_local(u_loc))
    plain = apps.sem_solve(n=SEM_N, elems=SEM_SOLVE_ELEMS, eb=_default_knobs(
        "sem_apply", dict(E=solve["op"].E))["eb"], log=log)
    check_rel(f"PCG solve E={solve['op'].E}: eb {solve['op'].eb} against "
              f"{plain['op'].eb} (iterations {solve['iters']}, "
              f"{plain['iters']})", solve["u"], plain["u"], 2e-4)
    dg_twin = copy.copy(sol)
    dg_twin.eb = _default_knobs("dg_volume", dict(E=sol.E))["eb"]
    dg_twin.surf_eb = _default_knobs("dg_surface", dict(E=sol.E))["eb"]
    dg_twin.kernel = sol.occa.build_kernel(
        dg_volume_builder, dict(sol.kernel.defines, eb=dg_twin.eb))
    dg_twin.surf_kernel = sol.occa.build_kernel(
        dg_surface_builder, dict(sol.surf_kernel.defines, eb=dg_twin.surf_eb))
    Q = apps.hump_state(sol)
    for _ in range(DG_STEPS):
        Q = dg_twin.step(Q, swe["dt"])
    _bit_equal(f"SWE: {DG_STEPS} LSERK steps on eb {sol.eb}/{sol.surf_eb} "
               f"and {dg_twin.eb}/{dg_twin.surf_eb}", swe["Q"], Q)
    del dg_twin, Q, plain
    return counts, dict(fd=fd, op=op, u_loc=u_loc, u_glob=u_glob, swe=swe)


def _bit_equal(what, got, want):
    import torch

    if not torch.equal(got, want):
        fail(f"{what}: not bit-equal (max |diff| "
             f"{float((got - want).abs().max()):.3e})")
    log(f"[tune check] {what}: bit-equal")


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
        + ", ".join(f"{k} {v:.4f} ms" for k, v in parts.items())
        + " (the parent kernel read 0.4722 ms, apply_global 0.7706, on an "
        "H100 80GB HBM3 at 700 W)")
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
    vol = sum(r[0] for r in rows if "dg_volume_kernel" in r[2])
    log(f"[profile swe] dg_volume {vol:.4f} ms of the {step_ms:.4f} ms step "
        f"({100 * vol / step_ms:.1f}%; the unfolded kernel read 0.3965 of "
        "3.33 ms on an H100 80GB HBM3 at 700 W)")
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
                surf=(QM, QP, sol.nrm, sol.lift, sol.surf_eb))


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
    |terms| (``check_rounding``); so is sem_apply on the main path's field,
    its summed |terms| apply_ref of the absolute values."""
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
    u, geo, dmat, eb = m["sem"]
    nq = u.shape[1]
    a64 = [t.double() for t in (u, geo, dmat)]
    check_rounding(f"sem_apply {tuple(u.shape)} (main path state)",
                   dict(kernel=sem_apply(u, geo, dmat, eb=eb),
                        plain=apply_ref(u, geo, dmat)),
                   apply_ref(*a64), apply_ref(*(t.abs() for t in a64)),
                   (2 * nq + 16) * 2.0 ** -24)
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


def dg_volume_host_split(q, geom, db, dr, ds, *, eb, n=200):
    """Host microseconds of one dg_volume call on the main path's inputs and
    of its pieces, each run n times back to back on the host clock, as
    rmsnorm_host_split splits rmsnorm's: the checks and route (what the
    wrapper reads before it allocates), torch.empty, the stream handle,
    the ctypes call refused before its launch (E = 0), the ctypes call
    that launches. n stays small enough that the launches never fill the
    card's queue, where the host would wait for the kernels and time
    them instead of itself."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.apps import dg as dg_ops
    from repro_torch.kernels.apps import dg_volume

    E, np_ = q.shape[0], q.shape[1]
    lib, fn = dg_ops._volume_entry()
    o = torch.empty_like(q)
    ptrs = [t.data_ptr() for t in (q, geom, db, dr, ds, o)]
    st = _build.stream()

    def checks():
        dg_ops.app_on_cpu("dg_volume", q, geom, db, dr, ds)
        dg_ops.volume_route(np_)
        if dg_ops.volume_refusal(E, np_, eb):
            fail("dg_volume: the main path's eb refused")
        return (tuple(q.shape), tuple(geom.shape), tuple(db.shape),
                tuple(dr.shape), tuple(ds.shape))

    def per_call(f):                 # the host's time, the card's queue not waited on
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            f()
        dt = (time.perf_counter() - t0) * 1e6 / n
        torch.cuda.synchronize()
        return dt

    if fn(1, *ptrs, 0, np_, eb, dg_ops.GRAV, st) == 0:
        fail("dg_volume: the entry point launched with E = 0")
    return dict(
        whole=per_call(lambda: dg_volume(q, geom, db, dr, ds, eb=eb)),
        checks=per_call(checks),
        empty=per_call(lambda: torch.empty_like(q)),
        stream=per_call(_build.stream),
        ctypes=per_call(lambda: fn(1, *ptrs, 0, np_, eb, dg_ops.GRAV, st)),
        ctypes_launch=per_call(
            lambda: fn(1, *ptrs, E, np_, eb, dg_ops.GRAV, st)))


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
    from repro_torch.kernels import reset_launches
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

    def kernel_fd():
        return fd2d(u1, u2, weights=wts, dx=dx, dt=dt, block=block, out=u3)

    out["fd2d"] = dict(
        ms=cuda_ms(kernel_fd, 50),
        device_ms=device_ms(kernel_fd, "fd2d_rows_kernel", launches=1),
        plain_ms=cuda_ms(lambda: fd2d_ref(u1, u2, wts, dx, dt), 5, 1),
        library_ms=cuda_ms(library_fd, 10),
        library="F.conv2d of the circular-padded field with the cross "
                "filter (cuDNN, TF32 off) + the update",
        bytes=3 * h * w * 4,
        shape=f"u1/u2/u3 ({h},{w}) f32, r={r}, tile {block}")
    out["fd2d"].update(zip(("bound_ms", "bound_by"), bound(
        3 * h * w * 4, fd_flops_per_step(w, h, r), "float32")))

    none = "none: no single PyTorch call computes it"
    u, geo, dmat, eb = a["sem"]
    E, nq = u.shape[0], u.shape[1]
    reset_launches()
    sem_ms = cuda_ms(lambda: sem_apply(u, geo, dmat, eb=eb), 20)
    check_routes("timed sem_apply", sem_apply,
                 {"templated": 23, "generic": 0})
    out["sem_apply"] = dict(
        ms=sem_ms,
        device_ms=device_ms(lambda: sem_apply(u, geo, dmat, eb=eb),
                            "sem_templated_kernel", launches=1),
        plain_ms=cuda_ms(lambda: apply_ref(u, geo, dmat), 5, 1),
        library_ms=None, library=none,
        bytes=sem_bytes_per_element(nq, 4) * E,
        shape=f"u ({E},{nq},{nq},{nq}), geo ({E},7,...) f32, eb={eb}")
    out["sem_apply"].update(zip(("bound_ms", "bound_by"), bound(
        sem_bytes_per_element(nq, 4) * E, sem_flops_per_element(nq) * E,
        "float32")))

    *args, eb = a["vol"]
    E, np_ = args[0].shape[0], args[0].shape[1]
    out["dg_volume"] = dict(
        ms=cuda_ms(lambda: dg_volume(*args, eb=eb), 50),
        device_ms=device_ms(lambda: dg_volume(*args, eb=eb),
                            "dg_volume_kernel", launches=1),
        plain_ms=cuda_ms(lambda: volume_ref(*args), 10),
        library_ms=None, library=none,
        bytes=dg_bytes_per_element(np_, 4) * E,
        host_us=dg_volume_host_split(*args, eb=eb),
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


def _full_model(arch, seed, **changes):
    """``arch`` in bf16 at full width (``changes`` to its config, e.g. a cut
    depth) and its parameters drawn on the card from ``seed``."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import LM

    model = LM(dataclasses.replace(get_config(arch), **changes))
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=model.device).manual_seed(seed))
    torch.cuda.synchronize()
    log(f"[model] {arch} bf16 {changes or ''}: {model.param_count(params)} "
        f"parameters, init {time.perf_counter() - t0:.1f}s")
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
    out, stats = generate(model, params, prompts, gen_tokens=ngen,
                          engine="static")
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
        f"idle {100 * (1 - busy_ms / step_ms):.1f}%; "
        f"{sum(r[1] for r in rows)} device events/step recorded")
    for ms, n, key in rows[:12]:
        log(f"[profile {name}]   {ms:8.4f} ms/step  {n:4d} calls/step  "
            f"{key[:90]}")
    compiled_static_pair(model, params, prompts, step_ms, busy_ms)
    return step_ms, busy_ms


def route_counts():
    """Every wrapper's launches by route (the wrappers with routes)."""
    from repro_torch.kernels import KERNELS

    return {n: dict(fn.routes) for n, fn in KERNELS.items()
            if hasattr(fn, "routes")}


def compiled_static_pair(model, params, prompts, prof_ms, prof_busy_ms,
                         nsteps=STEP_PAIR_STEPS, replays=8):
    """The static decode step eager and compiled on the same prompts, in
    one call: two prefills of ``prompts``, then ``nsteps`` greedy steps on
    each cache, eagerly through ``model.greedy_step`` and through
    ``build_serve_step``'s CUDA graph (one eager step, one capture, then
    replays), each step timed on the host clock up to its tokens' read, as
    the serving loop reads them. The tokens must be equal and the launch
    and route counts too; the logits are compared bit for bit, and a
    difference, printed, must stay within STEP_PAIR_REL of the largest
    |logit|. The graph must hold each hand-written kernel as often as the
    capture counted it (``check_graph_kernels``). Then the graph's device
    time (``replay_ms``). Prints eager and
    compiled host ms a step (the mean past the first two steps), the
    graph's device ms and busy share, tokens/s both ways and the capture's
    own time, beside ``prof_ms``/``prof_busy_ms``, the eager step's
    profile."""
    import torch

    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.parallel import GraphStep, build_serve_step

    b, plen = prompts.shape
    max_len = plen + nsteps + replays + 2
    toks = torch.from_numpy(prompts).to(model.device)
    runs = {}
    for mode in ("eager", "compiled"):
        with torch.no_grad():
            logits, cache = model.prefill(params, toks, max_len=max_len)
            tok = model.greedy_token(logits)[:, None]
        if mode == "eager":
            def step(p, c, t):
                return model.greedy_step(p, t, c)
        else:
            step, _ = build_serve_step(model, batch=b)
            if not isinstance(step, GraphStep):
                fail(f"{model.cfg.name}: the static step is not compiled")
        torch.cuda.synchronize()
        reset_launches()
        out, lgs, host = [], [], []
        with torch.no_grad():
            for _ in range(nsteps):
                t0 = time.perf_counter()
                nxt, lg, cache = step(params, cache, tok)
                out.append(nxt.to("cpu", copy=True))
                host.append((time.perf_counter() - t0) * 1e3)
                lgs.append(lg.clone())
                tok = nxt[:, None]
        torch.cuda.synchronize()
        runs[mode] = (torch.stack(out), torch.stack(lgs), launch_counts(),
                      route_counts(), sum(host[2:]) / (nsteps - 2))
        if mode == "compiled":
            check_graph_kernels(f"{model.cfg.name} static step",
                                step.counts)
            dev_ms = replay_ms(step, params, cache, tok, replays)
            capture_ms = step.capture_s * 1e3
        del cache
    (te, le, ce, re_, eager_ms), (tg, lg_, cg, rg, graph_ms) = (
        runs["eager"], runs["compiled"])
    name = model.cfg.name
    if not torch.equal(te, tg):
        fail(f"{name}: compiled static tokens {tg.tolist()} != eager "
             f"{te.tolist()}")
    if ce != cg or re_ != rg:
        fail(f"{name}: compiled step launch counts {cg} routes {rg} != "
             f"eager {ce} {re_}")
    diff = float((lg_ - le).abs().max())
    scale = float(le.abs().max())
    same = "bit for bit" if torch.equal(lg_, le) else (
        f"max|diff| {diff:.3e} of max|logit| {scale:.3e}")
    if diff > STEP_PAIR_REL * scale:
        fail(f"{name}: compiled logits differ from eager by {diff:.3e}, "
             f"past {STEP_PAIR_REL} of max|logit| {scale:.3e}")
    log(f"[compiled {name}] static decode step B={b}: eager host "
        f"{eager_ms:.3f} ms/step ({prof_ms:.3f} in the profiled loop, "
        f"{prof_busy_ms:.3f} busy); compiled host {graph_ms:.3f} ms/step, "
        f"graph device {dev_ms:.3f} ms/replay = "
        f"{100 * dev_ms / graph_ms:.1f}% busy; {b * 1e3 / eager_ms:.1f} -> "
        f"{b * 1e3 / graph_ms:.1f} tok/s; capture {capture_ms:.1f} ms; "
        f"{nsteps} tokens a row equal, logits {same}; launch counts equal")
    return dict(eager_ms=eager_ms, graph_ms=graph_ms, graph_dev_ms=dev_ms,
                capture_ms=capture_ms)


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
                  k.stride(1), v.stride(0), v.stride(1), st, None)

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


def _scan_bytes(bt, L, dm, n, xbytes):
    """x, delta, y, B, C, A (dm, n), D and hT of ssm_scan once each."""
    return (bt * L * dm * (2 * xbytes + 4) + 2 * bt * L * n * xbytes
            + dm * n * 4 + dm * 4 + bt * dm * n * 4)


def scan_bound(bt, L, dm, n, xbytes):
    """(bound ms, "bytes" or "operations") of ssm_scan: its bytes against
    its bt * L * dm * n exponentials at EX2_PER_S."""
    tb = _scan_bytes(bt, L, dm, n, xbytes) / HBM_BPS
    te = bt * L * dm * n / EX2_PER_S
    return max(tb, te) * 1e3, "bytes" if tb >= te else "operations"


def scan_head_bound(bt, L, dm, n, xbytes):
    """(bound ms, "bytes" or "operations") of the same scan where A is
    constant along n, as mamba2's per-head A is: one exponential a (t, c)
    at EX2_PER_S and two f32 FMAs a state and step (the update and C's
    sum) at the f32 peak, the larger of the two, against the same
    bytes."""
    tb = _scan_bytes(bt, L, dm, n, xbytes) / HBM_BPS
    to = max(bt * L * dm / EX2_PER_S,
             4 * bt * L * dm * n / PEAK_FLOPS["float32"])
    return max(tb, to) * 1e3, "bytes" if tb >= to else "operations"


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
# cp.async copies (LDGSTS) in the attention kernels' and the app kernels'
TC_LIBS = {"matmul": ("HGMMA", "UTMALDG"), "lm_head_ce": ("HGMMA", "UTMALDG"),
           "lm_head": ("HGMMA", "UTMALDG"),
           "flash_fwd": ("HGMMA", "LDGSTS"), "flash_bwd": ("HGMMA", "LDGSTS"),
           "ring_flash": ("HGMMA", "LDGSTS"),
           "ring_flash_wide": ("HGMMA", "LDGSTS"), "paged_decode": ("LDGSTS",),
           "flash_decode": ("LDGSTS",), "fd2d": ("LDGSTS",),
           "dg": ("LDGSTS",)}
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
    d = 128 flash_attention (f32 ones, on the CUDA cores, are held in
    small_wide_bwd_checks)."""
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
    # bf16 once)
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
# phase 20: the kernel language and the host API on the card
# ---------------------------------------------------------------------------

def _lang_cases(dev, gen):
    """The six bound specs: (builder, defines at the main paths' full
    shapes, defines at a small shape, inputs(defines) on the card, the
    plain version, its checker, the wrapper). Full shapes: the apps path's
    (FD 8192^2 at r = 4 on its default tile, SEM 32^3 elements of N = 7,
    DG 2 x 256^2 triangles of N = 5 with the random state and bathymetry
    gradient of ``full_size_app_checks``), matmul at the ring path's
    4096 x 2048 @ 2048 x 8192 bf16, rmsnorm at the decode step's 8 x 2048
    bf16 (f32 weight)."""
    import torch

    from repro_torch.apps.dg_swe import dg_surface_builder, dg_volume_builder
    from repro_torch.apps.fd2d import fd2d_builder
    from repro_torch.apps.numerics import fd_second_derivative_weights
    from repro_torch.apps.sem import sem_builder
    from repro_torch.device import fit_block
    from repro_torch.kernels.apps import (apply_ref, dg_surface, dg_volume,
                                          fd2d, fd2d_ref, sem_apply,
                                          surface_ref, volume_ref)
    from repro_torch.kernels.matmul import matmul, matmul_builder, matmul_ref
    from repro_torch.kernels.rmsnorm import (rmsnorm, rmsnorm_builder,
                                             rmsnorm_ref)

    def rnd(*shape, scale=1.0, dtype=torch.float32):
        return (scale * torch.randn(shape, generator=gen, device=dev)).to(
            dtype)

    def fd_d(n, r, bh, bw):
        dx = 2.0 / n
        return dict(w=n, h=n, r=r, bh=bh, bw=bw, dx=dx,
                    dt=0.5 * dx / 2 ** 0.5, dtype="float32",
                    weights=tuple(float(x)
                                  for x in fd_second_derivative_weights(r)))

    def water(E, n):
        q = rnd(E, n, 3) * torch.tensor([0.1, 0.3, 0.3], device=dev)
        q[..., 0] += 1.5
        return q

    def normals(E, n):
        theta = rnd(E, n)
        return torch.stack([theta.cos(), theta.sin(), rnd(E, n).abs()],
                           -1).contiguous()

    E_sem, nq = SEM_ELEMS ** 3, SEM_N + 1
    E_dg, np_, nfp3 = 2 * DG_NX ** 2, (DG_N + 1) * (DG_N + 2) // 2, \
        3 * (DG_N + 1)
    m, kk, nn = MM_SHAPE
    fd_tol = lambda tag, g, r: check_close(tag, g, r, atol=2e-5,  # noqa: E731
                                           rtol=2e-5)
    rel = lambda x: lambda tag, g, r: check_rel(tag, g, r, x)  # noqa: E731
    bf16_rows = lambda tag, g, r: check_close(  # noqa: E731
        tag, g, r, atol=1e-6, rtol=2 ** -7)
    return {
        "fd2d": (fd2d_builder,
                 fd_d(FD_SIZE, FD_RADIUS, fit_block(32, FD_SIZE),
                      fit_block(256, FD_SIZE)),
                 fd_d(64, 2, 16, 32),
                 lambda d: (rnd(d["h"], d["w"]), rnd(d["h"], d["w"])),
                 lambda d, u1, u2: fd2d_ref(u1, u2, d["weights"], d["dx"],
                                            d["dt"]), fd_tol, fd2d),
        "sem_ax": (sem_builder,
                   dict(E=E_sem, nq=nq, eb=fit_block(8, E_sem),
                        dtype="float32"),
                   dict(E=12, nq=4, eb=2, dtype="float32"),
                   lambda d: (rnd(d["E"], d["nq"], d["nq"], d["nq"]),
                              rnd(d["E"], 7, d["nq"], d["nq"], d["nq"]),
                              rnd(d["nq"], d["nq"])),
                   lambda d, *a: apply_ref(*a), rel(2e-4), sem_apply),
        "dg_swe_volume": (dg_volume_builder,
                          dict(E=E_dg, np_=np_, eb=fit_block(64, E_dg),
                               g=9.81, dtype="float32"),
                          dict(E=16, np_=10, eb=4, g=9.81, dtype="float32"),
                          lambda d: (water(d["E"], d["np_"]),
                                     rnd(d["E"], 4),
                                     rnd(d["E"], d["np_"], 2, scale=50.0),
                                     rnd(d["np_"], d["np_"]),
                                     rnd(d["np_"], d["np_"])),
                          lambda d, *a: volume_ref(*a, d["g"]), rel(2e-4),
                          dg_volume),
        "dg_swe_surface": (dg_surface_builder,
                           dict(E=E_dg, np_=np_, nfp3=nfp3,
                                eb=fit_block(64, E_dg), g=9.81,
                                dtype="float32"),
                           dict(E=16, np_=6, nfp3=9, eb=4, g=9.81,
                                dtype="float32"),
                           lambda d: (water(d["E"], d["nfp3"]),
                                      water(d["E"], d["nfp3"]),
                                      normals(d["E"], d["nfp3"]),
                                      rnd(d["np_"], d["nfp3"])),
                           lambda d, *a: surface_ref(*a, d["g"]), rel(2e-4),
                           dg_surface),
        # bf16 products are exact in f32; both sum K of them in f32 and
        # round once to bf16 (as ring_main_path holds matmul)
        "matmul": (matmul_builder,
                   dict(M=m, K=kk, N=nn, bm=fit_block(256, m),
                        bk=fit_block(256, kk), bn=fit_block(256, nn),
                        dtype="bfloat16"),
                   dict(M=32, K=48, N=24, bm=8, bk=16, bn=8,
                        dtype="bfloat16"),
                   lambda d: (rnd(d["M"], d["K"], dtype=torch.bfloat16),
                              rnd(d["K"], d["N"], scale=d["K"] ** -0.5,
                                  dtype=torch.bfloat16)),
                   lambda d, *a: matmul_ref(*a), rel(2 ** -7), matmul),
        "rmsnorm": (rmsnorm_builder,
                    dict(rows=8, d=2048, block_rows=1, eps=1e-6,
                         dtype="bfloat16", wdtype="float32"),
                    dict(rows=12, d=64, block_rows=4, eps=1e-6,
                         dtype="bfloat16", wdtype="float32"),
                    lambda d: (rnd(d["rows"], d["d"], dtype=torch.bfloat16),
                               rnd(d["d"])),
                    lambda d, x, w: rmsnorm_ref(x, w, eps=d["eps"]),
                    bf16_rows, rmsnorm),
    }


def _host_us(fn, n=100):
    """Host microseconds a call of fn over n back-to-back calls, the card's
    queue not waited on (n launches stay far below its depth)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / n
    torch.cuda.synchronize()
    return us


def language_phase(dev):
    """Phase 20: the kernel language and the OCCA host API on the card.

    Each of the six bound specs (``_lang_cases``) is built by
    ``Device("cuda")``, ``Device("torch")`` and ``Device("loops")`` from
    one builder and one set of defines. At the full shapes the cuda
    Kernel, called on a Memory output, must launch its wrapper's kernel
    exactly once (no other wrapper's) and write the output in place; it
    must match the torch expansion on the card (the spec's body, vmapped
    over the grid) and the plain version at the tolerance stated in
    ``_lang_cases``. At the small shape the loops expansion is held to the
    cuda kernel the same way. A spec with no binding and a define the
    binding refuses must raise inside ``build_kernel``. Then the host's
    microseconds a call through a Kernel against the wrapper called
    directly, each kernel on its full-shape inputs, and an FD step through
    ``FDWave``'s Kernel and swap chain against the wrapper with a Python
    rotation (host us and device ms a step). Launch counts are not summed
    into the kernels line."""
    import torch

    from repro_torch.core import Device, Spec, Tile, defines_namespace
    from repro_torch.kernels import KERNELS, launch_counts, reset_launches

    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(20)
    cuda, tor, loops = Device("cuda"), Device("torch"), Device("loops")
    host = {}
    cases = _lang_cases(dev, gen)
    for name, (builder, full, small, make, plain, held, wrapper) in \
            cases.items():
        wname = next(k for k, w in KERNELS.items() if w is wrapper)
        kc = cuda.build_kernel(builder, full)
        if kc.binding is None or kc.binding.wrapper is not wrapper:
            fail(f"lang {name}: bound to {kc.binding}, not {wname}")
        ins = make(full)
        (t,) = kc.spec.outputs
        out = cuda.malloc(t.shape, t.dtype)
        ptr = out.data.data_ptr()
        torch.cuda.synchronize()
        reset_launches()
        kc(*ins, out)
        torch.cuda.synchronize()
        got = launch_counts()
        want = {k: int(k == wname) for k in KERNELS}
        if got != want or out.data.data_ptr() != ptr:
            fail(f"lang {name}: a Kernel call launched "
                 f"{ {k: v for k, v in got.items() if v} }, expected "
                 f"{wname} once, its output in place")
        t0 = time.perf_counter()
        # the footprint gate prices the spec's tiles for a block's shared
        # memory, which the torch expansion does not use: off for this
        # reference (SEM's default tile at nq 8 prices 295,168 B)
        (expanded,) = tor.build_kernel(builder, full, analyze="off").run(
            *ins)
        torch.cuda.synchronize()
        t_exp = time.perf_counter() - t0
        if launch_counts() != want:
            fail(f"lang {name}: the torch expansion launched a kernel")
        shape = "x".join(str(x) for x in t.shape)
        held(f"lang {name} cuda vs torch expansion ({shape}, "
             f"{t.dtype})", out.data, expanded)
        held(f"lang {name} cuda vs plain", out.data, plain(full, *ins))
        D = defines_namespace(full)
        host[name] = [(_host_us(lambda: kc(*ins, out), 50),
                       _host_us(lambda: kc.binding.launch(
                           D, ins, (out.data,)), 50)) for _ in range(3)]
        del ins, out, expanded
        # the loops expansion at a small shape, against the kernel there
        ins = make(small)
        (ref,) = cuda.build_kernel(builder, small).run(*ins)
        (lp,) = loops.build_kernel(builder, small).run(*ins)
        held(f"lang {name} loops vs cuda (small: {small})", lp, ref)
        log(f"[lang] {name}: torch expansion at full shape {t_exp:.2f}s")
        torch.cuda.empty_cache()

    def unbound(D):
        return Spec("saxpy", grid=(2,),
                    inputs=[Tile("x", (8,), "float32", block=(4,))],
                    outputs=[Tile("y", (8,), "float32", block=(4,))],
                    body=lambda ctx, x, y: y.__setitem__(Ellipsis, x[...]))

    from repro_torch.apps.sem import sem_builder
    for what, builder, defines in (
            ("an unbound spec", unbound, {}),
            ("sem_ax at nq = 25", sem_builder,
             dict(E=4, nq=25, eb=2, dtype="float32"))):
        try:
            cuda.build_kernel(builder, defines)
        except ValueError as e:
            log(f"[lang] {what} refused at build_kernel: {e}")
        else:
            fail(f"lang: {what} built on the cuda backend")
    for name, rows in host.items():
        k_us, w_us = min(r[0] for r in rows), min(r[1] for r in rows)
        log(f"[lang host] {name}: {k_us:.1f} us a Kernel call, {w_us:.1f} "
            f"us its binding's launch (the wrapper call; matmul and rmsnorm "
            f"with their copy), {k_us - w_us:+.1f} us; the least of 3 "
            f"alternations of 50 calls each "
            f"{[tuple(round(x, 1) for x in r) for r in rows]}")
    builder, full, _, make = cases["fd2d"][:4]
    _fd_step_host(cuda, cuda.build_kernel(builder, full), *make(full))
    torch.cuda.empty_cache()
    log(f"[lang] phase {time.perf_counter() - t_phase:.1f}s")


def _fd_step_host(cuda, kernel, u1, u2):
    """An FD step on ``kernel`` (fd2d at 8192^2, r = 4) as ``FDWave.
    timestep`` takes it (the Kernel on three Memory handles, then two
    swaps) against the wrapper on three tensors rotated in Python: host us
    a step (``_host_us``) and device ms a step (``cuda_ms``), alternated
    three times; the least of each is printed."""
    import torch

    from repro_torch.kernels.apps import fd2d

    D = kernel.defines
    o = [cuda.malloc(u1), cuda.malloc(u2), cuda.malloc(u1.shape)]
    bufs = [o[0].data.clone(), o[1].data.clone(), torch.empty_like(u1)]

    def step():
        kernel(*o)
        o[1].swap(o[2])
        o[0].swap(o[1])

    def direct():
        a, b, c = bufs
        fd2d(a, b, weights=D["weights"], dx=D["dx"], dt=D["dt"],
             block=(D["bh"], D["bw"]), out=c)
        bufs[:] = [c, a, b]

    rows = []
    for _ in range(3):
        rows.append((_host_us(step), _host_us(direct), cuda_ms(step, 50),
                     cuda_ms(direct, 50)))
    k_us, w_us = min(r[0] for r in rows), min(r[1] for r in rows)
    log(f"[lang host] FD step {u1.shape[0]}^2 r = {D['r']}: {k_us:.1f} us "
        f"through the Kernel and swap chain, {w_us:.1f} us the wrapper and "
        f"a Python rotation ({k_us - w_us:+.1f} us); device ms a step "
        f"{min(r[2] for r in rows):.4f} vs {min(r[3] for r in rows):.4f} "
        f"(each reading {[tuple(round(x, 4) for x in r) for r in rows]})")
    del o, bufs


# ---------------------------------------------------------------------------
# phase 21: the ops over their builders
# ---------------------------------------------------------------------------

# each bound spec -> its kernel's name in the kernels line
SPEC_KERNEL = {
    "rmsnorm": "rmsnorm", "matmul": "matmul", "fd2d": "fd2d",
    "sem_ax": "sem_apply", "dg_swe_volume": "dg_volume",
    "dg_swe_surface": "dg_surface", "flash_attention_fwd": "flash_fwd",
    "flash_delta": "flash_delta", "flash_attention_bwd": "flash_bwd",
    "flash_decode": "flash_decode", "flash_decode_paged": "paged_decode",
    "ring_flash_fwd": "ring_flash_fwd", "ring_flash_bwd": "ring_flash_bwd",
    "lm_head_logits": "lm_head", "lm_head_ce": "lm_head_ce",
    "lm_head_ce_bwd": "lm_head_bwd", "ssm_scan": "ssm_scan"}
# the ops' full shapes: llama3_2_1b's train attention (B, H, Hk, S, d),
# musicgen_medium's static decode (B, H, S, d, kv_len), llama's paged
# decode (B, H, Hk, page, pages a sequence, d), the ring step at llama's
# widths (H, Hk, S a shard, d), the head (decode rows, train rows, d,
# vocab), rmsnorm at the train step's rows, and zamba2_7b's mamba2 scan at
# its train shape (B, L, dm, n), for the scan's gradients
LANG21_ATTN = (4, 32, 8, 1024, 64)
LANG21_DECODE = (8, 24, 576, 64, 300)
LANG21_PAGED = (8, 32, 8, 512, 4, 64)
LANG21_RING = (32, 8, 4096, 64)
LANG21_HEAD = (8, 4096, 2048, 128256)
LANG21_NORM = (4, 1024, 2048)
ZB_SCAN = (2, 512, 7168, 64)
LANG21_SCAN = (1, 2048, 8192, 16)     # falcon_mamba_7b's prefill, bf16
LANG21_GRAD_REL = 1e-3


def _op_inputs(dev, gen):
    """The 13 ops' inputs at the main paths' full shapes: {op name: (args,
    params, direct)} with ``direct()`` the wrapper's own call on the same
    inputs (what the op's cuda binding must launch, bit for bit)."""
    import torch

    from repro_torch.apps.numerics import fd_second_derivative_weights
    from repro_torch.kernels import (fd2d, flash_attention_fwd, flash_decode,
                                     lm_head_logits, matmul,
                                     paged_decode_attention, rmsnorm,
                                     ring_flash_fwd, sem_apply, ssm_scan_fwd)
    from repro_torch.kernels.apps import dg_surface, dg_volume
    from repro_torch.kernels.flash_attention.ops import paged_positions
    from repro_torch.kernels.lm_head import lm_head_ce

    bf = torch.bfloat16

    def rnd(*shape, scale=1.0, dtype=torch.float32):
        return (scale * torch.randn(shape, generator=gen, device=dev)).to(
            dtype)

    def water(E, n):
        q = rnd(E, n, 3) * torch.tensor([0.1, 0.3, 0.3], device=dev)
        q[..., 0] += 1.5
        return q

    cases = {}
    x, w = rnd(*LANG21_NORM, dtype=bf), rnd(LANG21_NORM[-1])
    cases["rmsnorm"] = ((x, w), dict(eps=1e-5),
                        lambda: rmsnorm(x, w, eps=1e-5))
    m, k_, n = MM_SHAPE
    a, b = rnd(m, k_, dtype=bf), rnd(k_, n, dtype=bf)
    cases["matmul"] = ((a, b), {}, lambda: matmul(a, b))
    B, H, Hk, S, d = LANG21_ATTN
    q = rnd(B, H, S, d, dtype=bf)
    kk, vv = rnd(B, Hk, S, d, dtype=bf), rnd(B, Hk, S, d, dtype=bf)
    cases["flash_attention"] = ((q, kk, vv), dict(causal=True),
                                lambda: flash_attention_fwd(q, kk, vv)[0])
    B, H, S, d, n_kv = LANG21_DECODE
    qd = rnd(B, H, 1, d, dtype=bf)
    kd, vd = rnd(B, H, S, d, dtype=bf), rnd(B, H, S, d, dtype=bf)
    cases["flash_decode"] = ((qd, kd, vd), dict(kv_len=n_kv),
                             lambda: flash_decode(qd, kd, vd, kv_len=n_kv))
    B, H, Hk, page, nsp, d = LANG21_PAGED
    npages = B * nsp + 1
    qp = rnd(B, H, 1, d, dtype=bf)
    kp, vp = (rnd(npages, Hk, page, d, dtype=bf),
              rnd(npages, Hk, page, d, dtype=bf))
    perm = torch.randperm(B * nsp,
                          generator=torch.Generator().manual_seed(21))
    table = (perm.reshape(B, nsp) + 1).to(torch.int32)
    cap = nsp * page
    # ragged live lengths, full to one token
    lens = torch.tensor([max(1, cap * (B - i) // B - 7 * i)
                         for i in range(B)], dtype=torch.int32)
    pos = torch.from_numpy(paged_positions(table.numpy(), lens.numpy(),
                                           npages, page))
    paged = dict(block_table=table.to(dev), kv_len=lens.to(dev),
                 pos_pages=pos.to(dev))
    cases["flash_decode_paged"] = (
        (qp, kp, vp), paged,
        lambda: paged_decode_attention(qp, kp, vp, **paged))
    H, Hk, S, d = LANG21_RING
    qr = rnd(1, H, S, d, dtype=bf)
    kr, vr = rnd(1, Hk, S, d, dtype=bf), rnd(1, Hk, S, d, dtype=bf)
    # the last shard of a 4-shard ring against its second chunk
    starts = dict(q_start=torch.full((1, 1), 3 * S, dtype=torch.int32,
                                     device=dev),
                  k_start=torch.full((1, 1), S, dtype=torch.int32,
                                     device=dev))
    cases["ring_flash"] = ((qr, kr, vr), dict(starts, causal=True),
                           lambda: ring_flash_fwd(qr, kr, vr, *starts.values(),
                                                  causal=True)[0])
    rows, trows, d, vocab = LANG21_HEAD
    embed = rnd(vocab, d, scale=0.02, dtype=bf)
    xh = rnd(rows, d, dtype=bf)
    cases["lm_head_logits"] = ((xh, embed.T), dict(vocab=vocab),
                               lambda: lm_head_logits(xh, embed.T,
                                                      vocab=vocab))
    xc = rnd(trows, d, dtype=bf)
    labels = torch.randint(0, vocab, (trows, 1), generator=gen, device=dev,
                           dtype=torch.int32)
    cases["lm_head_ce"] = ((xc, embed.T, labels), dict(vocab=vocab),
                           lambda: lm_head_ce(xc, embed.T, labels,
                                              vocab=vocab))
    bt, L, dm, ns = ZB_SCAN
    sx = rnd(bt, L, dm)
    sdelta = torch.nn.functional.softplus(rnd(bt, L, dm) - 2.0)
    sA = -(rnd(dm, ns).abs() + 0.1)
    sB, sC, sD = rnd(bt, L, ns), rnd(bt, L, ns), rnd(dm)
    h0 = torch.zeros(bt, dm, ns, device=dev)
    scan = (sx, sdelta, sA, sB, sC, sD)
    cases["ssm_scan"] = (scan, {}, lambda: ssm_scan_fwd(*scan, h0=h0)[0])
    dx = 2.0 / FD_SIZE
    fd = dict(weights=tuple(float(v) for v in
                            fd_second_derivative_weights(FD_RADIUS)),
              dx=dx, dt=0.5 * dx / 2 ** 0.5)
    u1, u2 = rnd(FD_SIZE, FD_SIZE), rnd(FD_SIZE, FD_SIZE)
    cases["fd2d"] = ((u1, u2), fd, lambda: fd2d(u1, u2, **fd))
    E, nq = SEM_ELEMS ** 3, SEM_N + 1
    su, geo, dmat = rnd(E, nq, nq, nq), rnd(E, 7, nq, nq, nq), rnd(nq, nq)
    cases["sem_apply"] = ((su, geo, dmat), {},
                          lambda: sem_apply(su, geo, dmat))
    E, np_, nfp3 = 2 * DG_NX ** 2, (DG_N + 1) * (DG_N + 2) // 2, \
        3 * (DG_N + 1)
    vol = (water(E, np_), rnd(E, 4), rnd(E, np_, 2, scale=0.01),
           rnd(np_, np_), rnd(np_, np_))
    cases["dg_volume"] = (vol, {}, lambda: dg_volume(*vol))
    theta = rnd(E, nfp3)
    nrm = torch.stack([theta.cos(), theta.sin(), rnd(E, nfp3).abs()],
                      -1).contiguous()
    surf = (water(E, nfp3), water(E, nfp3), nrm, rnd(np_, nfp3))
    cases["dg_surface"] = (surf, {}, lambda: dg_surface(*surf))
    return cases


def _same_bits(name, got, want):
    import torch

    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        if g.shape != w.shape or g.dtype != w.dtype or not torch.equal(g, w):
            fail(f"lang21 {name}: output {i} ({tuple(g.shape)} {g.dtype}) "
                 f"is not bit-equal to the wrapper's ({tuple(w.shape)} "
                 f"{w.dtype}; max |diff| "
                 f"{float((g.float() - w.float()).abs().max()):.3e})")


def _moved(fn):
    """(fn's result, the wrappers' launch counts it moved)."""
    import torch

    from repro_torch.kernels import launch_counts

    torch.cuda.synchronize()
    before = launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v - before[k] for k, v in launch_counts().items()
                 if v != before[k]}


def _ops_bit_equal(cases):
    """Each op on CUDA tensors against its wrapper's direct call: the same
    bits and the same launches."""
    from repro_torch.core import get_op

    for name, (args, params, direct) in cases.items():
        op = get_op(name)
        got, moved = _moved(lambda: op(*args, **params))
        want, wmoved = _moved(direct)
        _same_bits(name, got, want)
        if moved != wmoved or not moved:
            fail(f"lang21 {name}: the op moved the launch counts {moved}, "
                 f"its wrapper's call {wmoved}")
        log(f"[lang21] {name}: op (backend auto -> cuda) bit-equal to its "
            f"wrapper, launches {moved}")


def _grads_bit_equal(cases, gen):
    """flash_attention and lm_head_ce through their OpVJPs against the
    wrappers' autograd: forward and gradients bit-equal, launches equal."""
    import torch

    from repro_torch.core import get_op
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.lm_head import lm_head_ce

    q, k, v = cases["flash_attention"][0]
    do = torch.randn(q.shape, generator=gen, device=q.device).to(q.dtype)
    x, wt, labels = cases["lm_head_ce"][0]
    g = torch.randn(x.shape[0], generator=gen, device=x.device)
    embed = wt.T

    def attn(fn):
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        o = fn(*leaves)
        return (o.detach(),) + torch.autograd.grad(o, leaves, do)

    def head(fn):
        xl, el = x.detach().requires_grad_(), embed.detach().requires_grad_()
        loss = fn(xl, el.T)
        return (loss.detach(),) + torch.autograd.grad(loss, (xl, el), g)

    vocab = LANG21_HEAD[-1]
    op_a, op_h = get_op("flash_attention"), get_op("lm_head_ce")
    for name, run, via_op, via_wrapper in (
            ("flash_attention", attn,
             lambda *t: op_a(*t, causal=True),
             lambda *t: flash_attention(*t, causal=True)),
            ("lm_head_ce", head,
             lambda xl, w: op_h(xl, w, labels, vocab=vocab),
             lambda xl, w: lm_head_ce(xl, w, labels, vocab=vocab))):
        got, moved = _moved(lambda: run(via_op))
        want, wmoved = _moved(lambda: run(via_wrapper))
        _same_bits(f"{name} forward and gradients", got, want)
        if moved != wmoved:
            fail(f"lang21 {name} gradients: launches {moved} through the "
                 f"OpVJP, {wmoved} through the wrapper's autograd")
        log(f"[lang21] {name}: forward and gradients through the OpVJP "
            f"bit-equal to the wrapper's autograd, launches {moved}")


def _scan_grads(cases):
    """ssm_scan's gradients through the op's OpVJP (selective_scan_assoc)
    against autograd through selective_scan_ref, f32, zamba2's train
    shape: within LANG21_GRAD_REL of each gradient's max |ref|."""
    import torch

    from repro_torch.core import get_op
    from repro_torch.kernels.ssm_scan import selective_scan_ref

    args = cases["ssm_scan"][0]
    gy = torch.randn(args[0].shape, device=args[0].device,
                     generator=torch.Generator(args[0].device).manual_seed(3))
    op = get_op("ssm_scan")
    leaves = [t.detach().requires_grad_() for t in args]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    got = torch.autograd.grad(op(*leaves), leaves, gy)
    torch.cuda.synchronize()
    t_op = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    leaves = [t.detach().requires_grad_() for t in args]
    t0 = time.perf_counter()
    want = torch.autograd.grad(selective_scan_ref(*leaves)[0], leaves, gy)
    torch.cuda.synchronize()
    t_ref = time.perf_counter() - t0
    for nm, a, b in zip(("x", "delta", "A", "B", "C", "D"), got, want):
        check_rel(f"lang21 ssm_scan d{nm} (assoc vs ref, {ZB_SCAN})", a, b,
                  LANG21_GRAD_REL)
    log(f"[lang21] ssm_scan gradients at zamba2's {ZB_SCAN}: op forward + "
        f"backward {t_op:.3f} s (peak {peak:.2f} GB allocated), autograd "
        f"through selective_scan_ref {t_ref:.3f} s (host clock)")


def _spec_cases(cases, gen):
    """The eleven specs of the attention, head and scan builders at the
    full shapes: (builder, the op's defines, the torch expansion's tiles,
    inputs)."""
    import torch

    from repro_torch.core import fit_block, get_op
    from repro_torch.kernels import (flash_attention_fwd, flash_delta,
                                     ring_flash_fwd)
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.lm_head import kernel as lk
    from repro_torch.kernels.lm_head import lm_head_ce
    from repro_torch.kernels.ssm_scan import kernel as sk

    def prep(name, **kw):
        args, params, _ = cases[name]
        op = get_op(name)
        _, p = op._resolve(dict(params, **kw))
        run_args, defines, _ = op._prepare(args, p)
        return defines, run_args

    out = {}
    D, ins = prep("flash_attention")
    o, lse = flash_attention_fwd(*ins, causal=True)
    do = torch.randn(o.shape, generator=gen, device=o.device).to(o.dtype)
    delta = flash_delta(do, o)
    big = dict(block_q=512, block_kv=512)
    big = {k: fit_block(v, LANG21_ATTN[3]) for k, v in big.items()}
    out["flash_attention_fwd"] = (fk.flash_fwd_builder, D, big, ins)
    out["flash_delta"] = (fk.flash_delta_builder, D, big, (do, o))
    out["flash_attention_bwd"] = (fk.flash_bwd_builder, D, big,
                                  (*ins, do, lse, delta))
    D, ins = prep("flash_decode")
    out["flash_decode"] = (fk.flash_decode_builder, D, {}, ins)
    D, ins = prep("flash_decode_paged")
    out["flash_decode_paged"] = (fk.paged_decode_builder, D, {}, ins)
    D, ins = prep("ring_flash")
    rb = fit_block(1024, LANG21_RING[2])
    out["ring_flash_fwd"] = (fk.ring_flash_fwd_builder, D,
                             dict(block_q=rb, block_kv=rb), ins)
    ro, rlse = ring_flash_fwd(*ins, causal=True)
    rdo = torch.randn(ro.shape, generator=gen, device=ro.device).to(ro.dtype)
    rdelta = flash_delta(rdo, ro)
    out["ring_flash_bwd"] = (fk.ring_flash_bwd_builder, D,
                             dict(block_q=rb, block_kv=rb),
                             (*ins[:3], rdo, rlse, rdelta, *ins[3:]))
    rows, trows, d, vocab = LANG21_HEAD
    D, ins = prep("lm_head_logits")
    vb = fit_block(vocab // 16, vocab)
    out["lm_head_logits"] = (lk.lm_head_builder, D,
                             dict(block_v=vb, block_k=d), ins)
    D, ins = prep("lm_head_ce")
    out["lm_head_ce"] = (lk.lm_head_builder, D,
                         dict(block_r=fit_block(512, trows), block_v=vb,
                              block_k=d), ins)
    lse_c, _ = lm_head_ce.raw(*ins, vocab=vocab)
    gc = torch.randn((ins[0].shape[0], 1), generator=gen,
                     device=ins[0].device)
    out["lm_head_ce_bwd"] = (lk.lm_head_bwd_builder, D,
                             dict(block_r=trows, block_v=vb),
                             (*ins, lse_c, gc))
    # the scan's main path in bf16: falcon_mamba_7b's prefill
    sgen = torch.Generator(device=ins[0].device).manual_seed(13)

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=sgen, device=ins[0].device).to(
            dtype)

    bt, L, dm, n = LANG21_SCAN
    scan = (rnd(bt, L, dm, dtype=torch.bfloat16),
            torch.nn.functional.softplus(rnd(bt, L, dm) - 2.0),
            -(rnd(dm, n).abs() + 0.1), rnd(bt, L, n, dtype=torch.bfloat16),
            rnd(bt, L, n, dtype=torch.bfloat16), rnd(1, dm),
            torch.zeros(bt, dm, n, device=ins[0].device))
    out["ssm_scan"] = (sk.ssm_scan_builder,
                       dict(bt=bt, L=L, dm=dm, n=n, chunk=fit_block(64, L),
                            d_block=fit_block(512, dm), dtype="bfloat16"),
                       dict(chunk=fit_block(256, L), d_block=dm), scan)
    return out


def _specs_vs_torch(specs):
    """Each spec's cuda build against its torch expansion on the card (the
    expansion built with large tiles, which change nothing of its
    function, and without the footprint gate, which prices Pallas-style
    tiles that the expansion does not keep in shared memory)."""
    import torch

    from repro_torch.core import Device

    cuda, tor = Device("cuda"), Device("torch")
    for name, (builder, D, tiles, ins) in specs.items():
        kc = cuda.build_kernel(builder, D)
        if kc.spec.name != name or kc.binding is None:
            fail(f"lang21 {name}: built {kc.spec.name} bound to "
                 f"{kc.binding}")
        got = kc.run(*ins)
        t0 = time.perf_counter()
        want = tor.build_kernel(builder, dict(D, **tiles),
                                analyze="off").run(*ins)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        bf16 = ins[0].dtype == torch.bfloat16
        rel = 2 ** -7 if bf16 else 1e-4
        for t, g, w in zip(kc.spec.outputs, got, want, strict=True):
            tag = (f"lang21 {name}.{t.name} cuda vs torch expansion "
                   f"({'x'.join(map(str, t.shape))} {t.dtype})")
            if t.dtype == torch.int32:       # the argmax: a maximal logit
                logits = want[0]
                at = logits.gather(1, g.long())
                check_close(tag + " (the logit at the kernel's argmax)",
                            at, want[1], atol=rel * float(
                                logits.abs().max()), rtol=0)
                continue
            check_close(tag, g, w, atol=rel * float(w.float().abs().max()),
                        rtol=0)
        log(f"[lang21] {name}: torch expansion at the full shape "
            f"{secs:.2f} s (tiles {tiles or 'the op defines'})")
        del got, want
        torch.cuda.empty_cache()
    log("[lang21] cut: none (every spec at its main path's full shape; the "
        "torch expansion's tiles enlarged, its function unchanged)")


def _spec_costs(cases, specs):
    """The cost model of each bound spec at its kernel's row shape: the
    op's own defines (the builders' fitting), or for the aux specs the
    defines their ops build them with."""
    from repro_torch.core import (bound_specs, defines_namespace,
                                  estimate_cost, get_op)
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.lm_head import kernel as lk

    rows = {}

    def price(spec_name, builder, D):
        Dn = defines_namespace(D)
        rep = estimate_cost(builder(Dn), Dn)
        rows[spec_name] = rep

    for name, (args, params, _) in cases.items():
        op = get_op(name)
        _, p = op._resolve(params)
        _, D, _ = op._prepare(args, p)
        price(op.builder(defines_namespace(D)).name, op.builder, D)
        if name == "flash_attention":
            price("flash_delta", fk.flash_delta_builder, D)
            price("flash_attention_bwd", fk.flash_bwd_builder, D)
        if name == "ring_flash":
            price("ring_flash_bwd", fk.ring_flash_bwd_builder, D)
        if name == "lm_head_ce":     # as the OpVJP builds it on cuda
            price("lm_head_ce_bwd", lk.lm_head_bwd_builder,
                  {k: D[k] for k in ("R", "d", "V", "vocab", "block_r",
                                     "block_v", "dtype")})
    for name, (builder, D, _, _) in specs.items():
        if name == "ssm_scan":   # the scan's row: falcon's prefill in bf16
            price(name, builder, D)
    missing = set(bound_specs()) - set(rows)
    if missing:
        fail(f"lang21: no cost for the bound specs {sorted(missing)}")
    return rows


def _kernels_smem(cases, specs):
    """The shared memory a block of each bound spec's kernels really takes
    (static + dynamic, as the profiler's kernel records give it), for the
    footprint table beside the cost model's: the eleven new specs' cuda
    builds on their inputs, the other six through their ops. A spec whose
    kernels the profiler did not record prints "not recorded"."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import Device, get_op

    cuda = Device("cuda")
    calls = {name: (lambda b=b, D=D, ins=ins: cuda.build_kernel(b, D).run(
        *ins)) for name, (b, D, _, ins) in specs.items()}
    for name, spec in (("rmsnorm", "rmsnorm"), ("matmul", "matmul"),
                       ("fd2d", "fd2d"), ("sem_apply", "sem_ax"),
                       ("dg_volume", "dg_swe_volume"),
                       ("dg_surface", "dg_swe_surface")):
        args, params, _ = cases[name]
        calls[spec] = (lambda op=get_op(name), a=args, p=params: op(*a, **p))
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        seen = {}
        for _ in range(3):      # the profiler drops records now and then
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    fn()
                torch.cuda.synchronize()
            with tempfile.TemporaryDirectory() as tmp:
                path = os.path.join(tmp, "trace.json")
                prof.export_chrome_trace(path)
                with open(path) as f:
                    events = json.load(f).get("traceEvents", [])
            for e in events:
                if e.get("cat") == "kernel":
                    a = e.get("args", {})
                    seen[e.get("name", "?")[:72]] = (
                        a.get("shared memory"), a.get("registers per thread"))
            if seen:
                break
        log(f"[lang smem] {name}: " + ("; ".join(
            f"{k} {v[0]} B, {v[1]} registers" for k, v in seen.items())
            or "not recorded"))


def _op_host_us(dev, cases):
    """Host us of an op call over its wrapper's at the decode shapes: the
    least of 3 alternations of 50 calls each."""
    import torch

    from repro_torch.core import get_op
    from repro_torch.kernels import rmsnorm

    rows, _, d, _ = LANG21_HEAD
    x2 = torch.randn(rows, d, device=dev).to(torch.bfloat16)
    w2 = torch.randn(d, device=dev)
    decode = {"flash_decode": cases["flash_decode"],
              "flash_decode_paged": cases["flash_decode_paged"],
              "lm_head_logits": cases["lm_head_logits"],
              "rmsnorm": ((x2, w2), dict(eps=1e-5),
                          lambda: rmsnorm(x2, w2, eps=1e-5))}
    for name, (args, params, direct) in decode.items():
        op = get_op(name)
        op(*args, **params)
        rows = [(_host_us(lambda: op(*args, **params), 50),
                 _host_us(direct, 50)) for _ in range(3)]
        o_us, w_us = min(r[0] for r in rows), min(r[1] for r in rows)
        log(f"[lang host] {name} op: {o_us:.1f} us an op call, {w_us:.1f} "
            f"us the wrapper's, {o_us - w_us:+.1f} us; the least of 3 "
            f"alternations of 50 calls each "
            f"{[tuple(round(x, 1) for x in r) for r in rows]}")


def lang_ops_phase(dev):
    """Phase 21 (see the module docstring). Returns the cost model's
    report of every bound spec at its kernel's row shape, printed beside
    the rows' bounds once phase 8's are all known."""
    import torch

    from repro_torch import lint_kernels
    from repro_torch.core import Device
    from repro_torch.kernels.flash_attention import kernel as fk

    t_phase = time.perf_counter()

    def lap(what):
        log(f"[lang21] {what}: {time.perf_counter() - t_phase:.1f}s into "
            "the phase")

    gen = torch.Generator(device=dev).manual_seed(21)
    cases = _op_inputs(dev, gen)
    _ops_bit_equal(cases)
    lap("the 13 ops bit-equal")
    _grads_bit_equal(cases, gen)
    lap("the OpVJPs bit-equal")
    _scan_grads(cases)
    torch.cuda.empty_cache()
    lap("the scan's gradients")
    specs = _spec_cases(cases, gen)
    _specs_vs_torch(specs)
    lap("the eleven specs against their torch expansion")
    ring112 = dict(b=1, h=2, hk=1, sq=128, skv=128, d=112, dv=112,
                   block_q=64, block_kv=64, causal=True, window=None,
                   prefix_len=0, sm_scale=112 ** -0.5, dtype="float32",
                   ring_steps=1, mesh_axis="model")
    try:
        Device("cuda").build_kernel(fk.ring_flash_bwd_builder, ring112)
    except ValueError as e:
        log(f"[lang21] an f32 ring backward at d = 112 refused at "
            f"build_kernel: {e}")
    else:
        fail("lang21: the f32 ring backward built at d = 112")
    code = lint_kernels.main(["--strict", "--cost"])
    if code != 0:
        fail(f"lang21: lint_kernels --strict --cost exited {code}")
    lap("lint_kernels")
    costs = _spec_costs(cases, specs)
    lap("the cost model at the rows' shapes")
    _kernels_smem(cases, specs)
    lap("the kernels' shared memory")
    _op_host_us(dev, cases)
    del cases, specs
    torch.cuda.empty_cache()
    log(f"[lang21] phase {time.perf_counter() - t_phase:.1f}s")
    return costs


def log_spec_costs(costs, times):
    """The ``[lang cost]`` lines: each bound spec's footprint, device
    bytes and FLOPs by the cost model at its kernel's row shape, beside
    the row's bound and time (phase 8's)."""
    for name, rep in sorted(costs.items()):
        k = SPEC_KERNEL[name]
        t = times.get(k, {})
        fl = "?" if rep.flops is None else f"{rep.flops:,}"
        log(f"[lang cost] {name} ({k}): grid {rep.grid}, smem footprint "
            f"{rep.smem_bytes:,} B a block ({rep.smem_frac:.0%} of "
            f"{rep.smem_budget:,}), hbm {rep.hbm_bytes:,} B, flops {fl}; "
            f"the row's bound {t.get('bound_ms', float('nan')):.4f} ms by "
            f"{t.get('bound_by', '?')}, kernel {t.get('ms', float('nan')):.4f}"
            f" ms")


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

# ---------------------------------------------------------------------------
# MoE and MLA: flash_fwd at d_qk 192 / d_v 128 and at mixtral's group of 6;
# deepseek_v2_lite and mixtral_8x22b through the static path
# ---------------------------------------------------------------------------

def _mla_inputs(gen, b, s, h, dtype):
    """q, k (b, h, s, 192) and v (b, h, s, 128) as deepseek_v2_lite's
    prefill gives them: q and k concatenated (nope 128 + rope 64), v the
    strided view (b, s, h, 256) -> (b, h, s, 256)[..., 128:] of the
    latent's expansion."""
    import torch

    dev = gen.device
    q = torch.randn((b, h, s, 192), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, h, s, 192), generator=gen, device=dev).to(dtype)
    kv = torch.randn((b, s, h, 256), generator=gen, device=dev).to(dtype)
    return q, k, kv.transpose(1, 2)[..., 128:]


def small_mla_moe_attn_checks(dev):
    """The attention kernels at the new paths' shapes, against their plain
    versions at small sizes: flash_fwd at d_qk 192 / d_v 128 in f32 (the
    CUDA-core kernel; 1e-4) and bf16 (the tensor-core kernel, v the
    projection's strided view; check_flash_tc's limits) at ragged Sq != Skv
    and Sq off the 64-row tile, causal and not; flash_fwd with a window at
    mixtral's group of 6 query heads and d = 128 on both kernels; the same
    group through flash_decode on a rotated rolling cache (f32 1e-4, bf16
    1% of max|o| and 2^-7), kv_len as an int and as a device tensor. Each
    launch's route counted. Returns max |err| of flash_fwd's o."""
    import torch

    from repro_torch.kernels import reset_launches
    from repro_torch.kernels.flash_attention import (decode_ref,
                                                     flash_attention_fwd,
                                                     flash_decode,
                                                     flash_fwd_ref)

    gen = torch.Generator(device=dev).manual_seed(41)
    f32, bf = torch.float32, torch.bfloat16
    tol = dict(atol=1e-4, rtol=1e-4)
    reset_launches()
    err, ncase = 0.0, 0
    for sq, skv, causal in ((5, 5, True), (70, 70, True), (130, 200, True),
                            (100, 100, False), (1, 77, True)):
        tag = f"flash_fwd d_qk 192 / d_v 128 sq={sq} skv={skv} causal={causal}"
        q, k, v = _mla_inputs(gen, 2, skv, 4, f32)
        q = q[:, :, skv - sq:]
        o, lse = flash_attention_fwd(q, k, v, causal=causal)
        ro, rlse = flash_fwd_ref(q, k, v, causal=causal)
        check_close(tag + " f32 o", o, ro, **tol, quiet=True)
        check_close(tag + " f32 lse", lse, rlse, **tol, quiet=True)
        q, k, v = _mla_inputs(gen, 2, skv, 4, bf)
        err = max(err, check_flash_tc(tag + " bf16", q[:, :, skv - sq:], k,
                                      v, quiet=True, causal=causal))
        ncase += 1
    # mixtral's attention: 48 query heads over 8 kv heads, here 12 over 2
    for sq, skv, window in ((130, 130, 40), (64, 300, 100)):
        tag = f"flash_fwd group 6 d=128 sq={sq} skv={skv} window={window}"
        q, k, v = (_proj(gen, 2, s, n, 128) for s, n in ((sq, 12), (skv, 2),
                                                         (skv, 2)))
        err = max(err, check_flash_tc(tag + " bf16", q, k, v, quiet=True,
                                      window=window))
        qf, kf, vf = q.float(), k.float(), v.float()
        o, lse = flash_attention_fwd(qf, kf, vf, window=window)
        ro, rlse = flash_fwd_ref(qf, kf, vf, window=window)
        check_close(tag + " f32 o", o, ro, **tol, quiet=True)
        check_close(tag + " f32 lse", lse, rlse, **tol, quiet=True)
        ncase += 1
    want = {"wgmma": ncase, "simt": ncase}
    if flash_attention_fwd.routes != want:
        fail(f"flash_fwd routes {flash_attention_fwd.routes}, want {want}")
    m, kv_len, window = 300, 450, 200
    sp = torch.roll(torch.arange(kv_len - m, kv_len, dtype=torch.int32,
                                 device=dev), 17)    # a rotated window
    kl_dev = torch.tensor([kv_len], dtype=torch.int32, device=dev)
    for dtype in (f32, bf):
        q = torch.randn((3, 12, 1, 128), generator=gen, device=dev).to(dtype)
        k, v = (torch.randn((3, 2, m, 128), generator=gen, device=dev).to(
            dtype) for _ in range(2))
        ref = decode_ref(q, k, v, kv_len=kv_len, slot_pos=sp, window=window)
        lim = (tol if dtype == f32 else
               dict(atol=0.01 * float(ref.float().abs().max()),
                    rtol=2 ** -7))
        for kl in (kv_len, kl_dev):
            o = flash_decode(q, k, v, kv_len=kl, slot_pos=sp, window=window)
            check_close(f"flash_decode group 6 d=128 {dtype} kv_len "
                        f"{'tensor' if torch.is_tensor(kl) else 'int'}",
                        o, ref, **lim, quiet=True)
    if flash_decode.launches != 4:
        fail(f"flash_decode launched {flash_decode.launches} times, want 4")
    torch.cuda.synchronize()
    log(f"[check] flash_fwd at d_qk 192 / d_v 128 and group 6 / d 128: "
        f"{ncase} cases on each route agree (bf16 max|err| of o {err:.3e}); "
        "flash_decode at group 6 / d 128 on a rotated cache agrees")
    return err


def mla_decode_bf16_check(dev):
    """MLA's absorbed decode in bf16 at deepseek_v2_lite's widths (16 heads,
    lora 512, nope 128, rope 64, v 128), MOE_BATCH sequences at position
    MOE_PROMPT + 1 of a cache of random latents. Its products at those
    shapes (bf16 operands, f32 results by ``out_dtype``) each within 1e-4
    of the largest |ref| of the same product of f32 copies (an f32 sum in
    another order; a bf16 result would miss by ~2^-9), and the layer's
    output and cache writes on the card within 1e-2 of the largest value
    of the same call on the CPU (f32 copies there). Returns the output's
    max |err|."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.layers import attention as attn
    from repro_torch.models import tree_to

    cfg = get_config("deepseek_v2_lite")
    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(43)
    b, m, pos = MOE_BATCH, MOE_PROMPT + MOE_GEN, MOE_PROMPT + 1
    h, nope, rope, dv, lora = (cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim,
                               cfg.v_head_dim, cfg.kv_lora_rank)
    params = attn.mla_init(gen, cfg, bf, dev)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf)

    cache = {"ckv": rnd(b, m, lora), "krope": rnd(b, m, rope)}
    x = rnd(b, 1, cfg.d_model)
    wkv_b = params["wkv_b"].reshape(lora, h, nope + dv)
    for tag, a, w in (
            ("q_nope @ W_uk", rnd(h, b, nope),
             wkv_b[..., :nope].permute(1, 2, 0)),
            ("q_lat @ ckv^T", rnd(b, h, lora), cache["ckv"].transpose(1, 2)),
            ("q_rope @ krope^T", rnd(b, h, rope),
             cache["krope"].transpose(1, 2)),
            ("p @ ckv", torch.softmax(rnd(b, h, m).float(), -1).to(bf),
             cache["ckv"]),
            ("o_lat @ W_uv", rnd(h, b, lora),
             wkv_b[..., nope:].permute(1, 0, 2))):
        got = attn._bmm_f32(a, w)
        if got.dtype != torch.float32:
            fail(f"mla_decode {tag}: result {got.dtype}, want float32")
        check_rel(f"mla_decode bf16 {tag} {tuple(got.shape)}, f32 result",
                  got, torch.bmm(a.float(), w.float()), 1e-4)
    c_cpu = tree_to(cache, "cpu")
    y, _ = attn.mla_decode(params, x, cache, cfg, pos=pos)
    y_cpu, _ = attn.mla_decode(tree_to(params, "cpu"), x.cpu(), c_cpu, cfg,
                               pos=pos)
    err = check_rel(f"mla_decode bf16 B={b} m={m} pos={pos}, card vs CPU",
                    y.cpu(), y_cpu, 1e-2)
    for k in ("ckv", "krope"):
        check_rel(f"mla_decode bf16 cache write {k}, card vs CPU",
                  cache[k][:, pos].cpu(), c_cpu[k][:, pos], 1e-2)
    return err


class _DispatchTwin:
    """While active, each einsum-dispatch MoE layer also runs the gather
    dispatch on the same input (teacher forcing: the model goes on with the
    einsum's output) and records, layer by layer, the largest |gather -
    einsum| over the largest |einsum| of its token's row (a row both leave
    at zero counts 0; one only the gather fills, inf) and over the largest
    |einsum| of the layer. ``blocks.moe_forward`` is wrapped and restored
    on exit."""

    def __enter__(self):
        import torch

        from repro_torch.layers import blocks

        self.row, self.whole = [], []
        self._blocks, self._orig = blocks, blocks.moe_forward

        def twin(params, x, cfg, *, dispatch="einsum"):
            y, aux = self._orig(params, x, cfg, dispatch=dispatch)
            if dispatch == "einsum":
                with torch.no_grad():
                    yg, _ = self._orig(params, x, cfg, dispatch="gather")
                    err = (yg.float() - y.float()).abs()
                    ref = y.float().abs()
                    rows = err.amax(-1)
                    self.row.append(float(torch.where(
                        rows == 0, 0.0, rows / ref.amax(-1)).max()))
                    self.whole.append(float(err.max() / ref.max()))
            return y, aux

        blocks.moe_forward = twin
        return self

    def __exit__(self, *exc):
        self._blocks.moe_forward = self._orig


class _RouterGaps:
    """Records, while active, the smallest gap between the k-th and the
    (k+1)-th router probability of any token routed (the margin by which
    its expert choice stood; ``gap``, read on exit) and each eager call's
    expert choices, layer by layer. ``repro_torch.layers.moe._router`` is
    wrapped (``moe_forward`` looks it up at each call) and restored on
    exit. The gap is kept on the device by an in-place minimum, so a
    compiled decode step's replays record theirs too (a replay runs no
    Python); the first call must be eager (a prefill), which makes the
    running minimum."""

    def __enter__(self):
        import torch

        from repro_torch.layers import moe

        self.gap, self.idx, self._gap = float("inf"), [], None
        self._moe, self._orig = moe, moe._router

        def rec(params, x, cfg):
            out = self._orig(params, x, cfg)
            with torch.no_grad():
                p = torch.softmax(x.float() @ params["router"], dim=-1)
                top = torch.topk(p, cfg.n_experts_per_tok + 1, dim=-1).values
                gap = (top[..., -2] - top[..., -1]).min()
                if self._gap is None:
                    self._gap = gap.clone()
                else:
                    torch.minimum(self._gap, gap, out=self._gap)
                self.idx.append(out[1])
            return out

        moe._router = rec
        return self

    def __exit__(self, *exc):
        self._moe._router = self._orig
        if self._gap is not None:
            self.gap = float(self._gap)


def two_layer_moe_f32_checks():
    """deepseek_v2_lite with 2 layers (the dense one and one MoE layer: MLA
    attention, 64 routed and 2 shared experts) and mixtral_8x22b with 1
    layer (8 experts, window 4096), f32 at full width; one set of weights,
    drawn on the card and copied to the CPU (mixtral's expert leaves are
    9.7 GB), runs on the card (kernels) and on the CPU (plain versions).
    Prefill logits of 2 x 64 tokens within 1e-3 of the largest logit (f32
    sums in other orders), and ``generate``'s first 8 greedy tokens equal.
    Prints the smallest gap between the k-th and (k+1)-th router
    probability the card saw: an expert choice that flips across devices
    at such a near-tie is a tie, not a kernel fault (a failure names it).
    deepseek's training loss and every gradient on the same tokens, card
    vs CPU (_train_card_vs_cpu), with the CPU's MoE layers routed as the
    card's (_ForcedRoutes, teacher forced)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate
    from repro_torch.models import LM, tree_to

    for arch, nl in (("deepseek_v2_lite", 2), ("mixtral_8x22b", 1)):
        cfg = dataclasses.replace(get_config(arch), n_layers=nl,
                                  dtype="float32")
        cpu, gpu = LM(cfg, device="cpu"), LM(cfg)
        t0 = time.perf_counter()
        p_gpu = gpu.init(torch.Generator(device=gpu.device).manual_seed(13))
        p_cpu = tree_to(p_gpu, "cpu")
        tag = f"{nl}-layer f32 {arch} {[s.kind for s in gpu.program]}"
        log(f"[moe f32] {tag}: {gpu.param_count(p_gpu)} parameters, drawn "
            f"on the card and copied in {time.perf_counter() - t0:.1f}s")
        prompts = np.random.RandomState(14).randint(1, cfg.vocab_size,
                                                    (2, 64))
        toks = torch.from_numpy(prompts)
        with _RouterGaps() as gaps, torch.no_grad():
            lg, _ = gpu.prefill(p_gpu, toks.to(gpu.device))
            out_g, st = generate(gpu, p_gpu, prompts, gen_tokens=8)
        t0 = time.perf_counter()
        with torch.no_grad():
            lc, _ = cpu.prefill(p_cpu, toks)
            out_c, _ = generate(cpu, p_cpu, prompts, gen_tokens=8)
        cpu_s = time.perf_counter() - t0
        log(f"[moe f32] {tag}: smallest gap between the k-th and (k+1)-th "
            f"router probability on the card {gaps.gap:.3e}")
        check_rel(f"{tag} prefill logits, card vs CPU (gap {gaps.gap:.1e})",
                  lg.cpu(), lc, 1e-3)
        if st["engine"] or not np.array_equal(out_c, out_g):
            fail(f"{tag}: greedy tokens CPU {out_c.tolist()} != card "
                 f"{out_g.tolist()} (smallest router gap {gaps.gap:.3e})")
        log(f"[moe f32] {tag}: 8 static tokens agree, card == CPU (first "
            f"row {out_g[0].tolist()}; the CPU side took {cpu_s:.1f}s)")
        if arch == "deepseek_v2_lite":
            routes = _ForcedRoutes()
            _train_card_vs_cpu(tag, cpu, gpu, p_cpu, p_gpu, {"tokens": toks},
                               routes)
            log(f"[moe f32] {tag} train: smallest gap between the k-th and "
                f"(k+1)-th router probability on the card {routes.gap:.3e}; "
                f"the CPU's own top-k would route {routes.flips} tokens "
                "otherwise (its MoE layers take the card's choices, teacher "
                "forced)")
        del cpu, gpu, p_gpu, p_cpu
        torch.cuda.empty_cache()


def _decode_weight_bytes(model, params):
    """Bytes of the weights one decode step reads, counted once: every
    parameter but the embedding table (of which it reads a row a
    sequence), and of those the routed experts' alone (the einsum
    dispatch runs every expert on its slots, so each is read)."""
    from repro_torch.tree import leaves_with_path

    total = experts = 0
    for path, t in leaves_with_path(params):
        if path == "['embed']":
            continue
        n = t.numel() * t.element_size()
        total += n
        if "['moe']['w_" in path:
            experts += n
    return total, experts


def moe_main_path(arch, seed, **changes):
    """``arch`` in bf16 at full width (``changes`` cut its depth) through
    ``generate`` (the static path: mixtral's window and deepseek's MLA are
    not pageable): MOE_BATCH prompts of MOE_PROMPT tokens, MOE_GEN new,
    launch counts zeroed just before and read just after. flash_fwd must
    launch once per layer, on the tensor cores; flash_decode once per GQA
    layer and decode step (none for MLA: its absorbed decode is matmuls);
    rmsnorm three times a layer for MLA (norm1, kv_norm, norm2) and twice
    for GQA, plus the final norm, per prefill and decode step; the decode
    head once per pass. Then where a decode step's time goes, beside the
    bytes of weights it reads; prefill's last logits against forward's on
    the same tokens (the same MoE groups), every logit finite; and the
    gather dispatch against the einsum's. Their bf16 roundings differ
    (JAX's too: a bf16 gate product and adds against one f32 sum), and a
    token whose k-th and (k+1)-th router probabilities nearly tie can then
    pick another expert in a later layer, which moves its output by O(1):
    through the whole model the two prefills' logits are compared and
    their expert choices counted layer by layer, but not gated. The gate
    is teacher forced: in the einsum model's forward every MoE layer also
    runs the gather dispatch on the same input, and each layer's outputs
    must agree within MOE_TWIN_REL of the largest |output| of each token.
    Returns (counts, stats)."""
    import numpy as np
    import torch

    from repro_torch.kernels.rmsnorm import rmsnorm
    from repro_torch.models import LM

    model, params = _full_model(arch, seed, **changes)
    cfg = model.cfg
    b, plen, ngen = MOE_BATCH, MOE_PROMPT, MOE_GEN
    prompts = np.random.RandomState(seed).randint(0, cfg.vocab_size,
                                                  (b, plen))
    out, stats, counts = _static_run(model, params, prompts, ngen)
    nl, passes, mla = cfg.n_layers, ngen + 1, cfg.attn_type == "mla"
    want = {"flash_fwd": nl, "flash_decode": 0 if mla else nl * ngen,
            "rmsnorm": passes * ((3 if mla else 2) * nl + 1),
            "lm_head": passes}
    for name, n in want.items():
        if counts[name] != n:
            fail(f"{arch}: {name} launched {counts[name]} times in "
                 f"generate, want {n}")
    log(f"{arch} static path kernels: " + ", ".join(
        f"{k}={counts[k]}" for k in want) + f" (rmsnorm routes "
        f"{rmsnorm.routes})")
    log(f"[{arch}] generate B={b} prompt={plen} new={ngen} ({nl} layers): "
        f"prefill {stats['prefill_s'] * 1e3:.3f} ms, decode "
        f"{stats['decode_s']:.3f}s = {stats['decode_s'] * 1e3 / ngen:.3f} "
        f"ms/step, {stats['tokens_per_s']:.1f} tok/s; first row "
        f"{out[0, :12].tolist()}")
    step_ms, busy_ms = profile_static_step(model, params, prompts)
    wbytes, ebytes = _decode_weight_bytes(model, params)
    log(f"[{arch}] decode step bound: the routed experts' "
        f"{ebytes / 1e9:.2f} GB over {HBM_BPS / 1e12:.2f} TB/s = "
        f"{ebytes / HBM_BPS * 1e3:.3f} ms; every weight the step reads, "
        f"{wbytes / 1e9:.2f} GB = {wbytes / HBM_BPS * 1e3:.3f} ms; the step "
        f"took {step_ms:.3f} ms on the host clock, {busy_ms:.3f} ms busy")

    toks = torch.from_numpy(prompts).to(model.device)
    gm = LM(cfg, moe_dispatch="gather")
    with torch.no_grad():
        with _DispatchTwin() as twin:
            full, aux = model.forward(params, toks)
        with _RouterGaps() as ein:
            lp, cache = model.prefill(params, toks, max_len=plen + 1)
        nxt = model.greedy_token(lp)[:, None]
        ld, _ = model.decode_step(params, nxt, cache)
        with _RouterGaps() as gat:
            lg, _ = gm.prefill(params, toks)
    for what, t in (("forward", full), ("prefill", lp), ("decode_step", ld),
                    ("gather prefill", lg), ("forward aux", aux)):
        if not torch.isfinite(t).all():
            fail(f"{arch} bf16 {what}: non-finite values")
    check_rel(f"{arch} bf16 prefill vs forward last-position logits", lp,
              full[:, -1], 0.05)
    moved = [float((a != b).float().mean()) for a, b in zip(ein.idx, gat.idx)]
    err = (lg.float() - lp.float()).abs()
    scale = float(lp.float().abs().max())
    log(f"[{arch}] whole model, gather vs einsum dispatch prefill logits: "
        f"max|err| {float(err.max()):.3e} of max|logit| {scale:.3e}, "
        f"{100 * float((err <= 0.05 * scale).float().mean()):.1f}% within 5%"
        f"; same argmax {int((lg.argmax(-1) == lp.argmax(-1)).sum())} of "
        f"{lp.shape[0]}; share of expert choices that differ, layer by "
        f"layer: {[round(m, 4) for m in moved]} (smallest router gap "
        f"{ein.gap:.3e})")
    nmoe = sum(sp.n for sp in model.program if sp.kind == "moe")
    if len(twin.row) != nmoe:
        fail(f"{arch}: {len(twin.row)} MoE layers held gather against "
             f"einsum, want {nmoe}")
    log(f"[{arch}] gather vs einsum dispatch, teacher forced (each MoE "
        f"layer's same input): max|err| over the largest |output| of its "
        f"token, layer by layer {[f'{r:.3e}' for r in twin.row]}; over the "
        f"layer's largest |output| {[f'{r:.3e}' for r in twin.whole]}")
    worst = max(twin.row)
    if not worst <= MOE_TWIN_REL:
        fail(f"{arch}: gather vs einsum dispatch on a MoE layer's same "
             f"input differ by {worst:.3e} of a token's largest |output| "
             f"at layer {twin.row.index(worst)} (limit {MOE_TWIN_REL})")
    log(f"[{arch}] forward aux (moe_lb, moe_z summed over the layers) "
        f"{[round(float(a), 4) for a in aux]}")
    stats.update(step_ms=step_ms, busy_ms=busy_ms, bound_bytes=wbytes,
                 expert_bytes=ebytes)
    del model, params, full
    torch.cuda.empty_cache()
    return counts, stats


def time_moe_mla_kernels(dev):
    """flash_fwd at deepseek_v2_lite's prefill shape (q, k (4, 16, 512,
    192), v (4, 16, 512, 128), v the projection's view) and at mixtral's
    (q (4, 48, 512, 128), k/v (4, 8, 512, 128), window 4096), and
    flash_decode at mixtral's decode shape (q (4, 48, 1, 128) against 8
    rolling caches (4, 8, 544, 128), cycled as a step cycles its layers),
    each held against its plain version at that shape (flash_fwd at
    check_flash_tc's limits, flash_decode at 1% of max|o| and 2^-7), then
    timed beside its bound, the plain version and SDPA. The bound counts
    2 (d_qk + d_v) FLOPs a visible (query, key) pair and head, and each
    input and output byte once. Returns (times, max |err| of each)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (decode_ref,
                                                     flash_decode)

    gen = torch.Generator(device=dev).manual_seed(42)
    bf = torch.bfloat16
    b, s = MOE_BATCH, MOE_PROMPT
    out, errs = {}, {}
    pairs = b * s * (s + 1) // 2
    q, k, v = _mla_inputs(gen, b, s, 16, bf)
    errs["flash_fwd@mla"] = check_flash_tc(
        f"flash_fwd bf16 at deepseek's prefill q {tuple(q.shape)}, v "
        f"{tuple(v.shape)}", q, k, v, causal=True)
    out["flash_fwd@mla"] = dict(
        **flash_times(q, k, v, iters=30, plain_iters=5),
        flops=2 * 16 * (192 + 128) * pairs,
        shape=f"q/k ({b},16,{s},192), v ({b},16,{s},128) view bf16, causal")
    out["flash_fwd@mla"].update(zip(("bound_ms", "bound_by"), bound(
        2 * b * 16 * s * (192 * 2 + 128 * 2) + 4 * b * 16 * s,
        2 * 16 * (192 + 128) * pairs, "bfloat16")))
    del q, k, v

    h, hk, d, win = 48, 8, 128, 4096
    q, k, v = (_proj(gen, b, s, n, d) for n in (h, hk, hk))
    errs["flash_fwd@mixtral"] = check_flash_tc(
        f"flash_fwd bf16 at mixtral's prefill q {tuple(q.shape)}, window "
        f"{win}", q, k, v, causal=True, window=win)
    out["flash_fwd@mixtral"] = dict(
        **flash_times(q, k, v, iters=30, plain_iters=5),
        flops=4 * h * d * pairs,
        shape=f"q ({b},{h},{s},{d}), k/v ({b},{hk},{s},{d}) views bf16, "
              f"causal (window {win} >= S: SDPA's is_causal is the same "
              "function)")
    out["flash_fwd@mixtral"].update(zip(("bound_ms", "bound_by"), bound(
        2 * b * (2 * h + 2 * hk) * s * d + 4 * b * h * s,
        4 * h * d * pairs, "bfloat16")))
    del q, k, v

    m, nl = s + MOE_GEN, 8
    qd = torch.randn((b, h, 1, d), generator=gen, device=dev).to(bf)
    ks = [torch.randn((b, hk, m, d), generator=gen, device=dev).to(bf)
          for _ in range(nl)]
    vs = [torch.randn((b, hk, m, d), generator=gen, device=dev).to(bf)
          for _ in range(nl)]
    sp = torch.arange(m, dtype=torch.int32, device=dev)
    kw = dict(kv_len=m, slot_pos=sp, window=win)
    ref = decode_ref(qd, ks[0], vs[0], **kw)
    errs["flash_decode@mixtral"] = check_close(
        f"flash_decode bf16 at mixtral's decode q {tuple(qd.shape)}, cache "
        f"{tuple(ks[0].shape)}", flash_decode(qd, ks[0], vs[0], **kw), ref,
        atol=0.01 * float(ref.float().abs().max()), rtol=2 ** -7)
    it = iter(range(1 << 30))

    def cycle(fn):
        def run():
            i = next(it) % nl
            return fn(ks[i], vs[i])
        return run

    kernel = cycle(lambda kk, vv: flash_decode(qd, kk, vv, **kw))
    nbytes = 2 * b * hk * m * d * 2 + 2 * b * h * d * 2 + 4 * m
    out["flash_decode@mixtral"] = dict(
        ms=cuda_ms(kernel, iters=96),
        device_ms=device_ms(kernel, "flash_decode", launches=2),
        plain_ms=cuda_ms(cycle(lambda kk, vv: decode_ref(qd, kk, vv, **kw)),
                         iters=24),
        library_ms=cuda_ms(cycle(
            lambda kk, vv: F.scaled_dot_product_attention(
                qd, kk, vv, enable_gqa=True)), iters=96),
        library="F.scaled_dot_product_attention(enable_gqa): every slot "
                "visible, the same function at kv_len = m < window",
        bytes=nbytes,
        shape=f"q ({b},{h},1,{d}), k/v ({b},{hk},{m},{d}) bf16, kv_len {m}, "
              f"slot_pos, window {win}")
    out["flash_decode@mixtral"].update(zip(("bound_ms", "bound_by"), bound(
        nbytes, 4 * b * h * m * d, "bfloat16")))
    del ks, vs
    torch.cuda.empty_cache()
    return out, errs


# ---------------------------------------------------------------------------
# zamba2: ssm_scan at state size 64, flash_fwd at head dim 112, the hybrid
# ---------------------------------------------------------------------------

def _zamba_scan_inputs(dev, gen, bt, L, dtype):
    """The scan's inputs as mamba2 hands them over at zamba2_7b's widths
    (d_inner 7168, 112 heads of 64 channels, state 64): x, B, C in
    ``dtype``, delta f32 (a softplus-sized dt a head, repeated over its
    channels), A one negative value a head, repeated and broadcast along
    n (a contiguous copy, as the layer passes it), D = 1."""
    import torch

    from repro_torch.configs import get_config

    cfg = get_config("zamba2_7b")
    dm, n, p = cfg.resolved_d_inner, cfg.ssm_state, cfg.ssm_head_dim
    x = torch.randn((bt, L, dm), generator=gen, device=dev).to(dtype)
    dt = torch.nn.functional.softplus(
        torch.randn((bt, L, dm // p), generator=gen, device=dev) - 4)
    delta = dt.repeat_interleave(p, dim=-1)
    a = -(1 + 15 * torch.rand((dm // p,), generator=gen, device=dev))
    A = a.repeat_interleave(p)[:, None].expand(dm, n).contiguous()
    B = torch.randn((bt, L, n), generator=gen, device=dev).to(dtype)
    C = torch.randn((bt, L, n), generator=gen, device=dev).to(dtype)
    D = torch.ones(dm, device=dev)
    return x, delta, A, B, C, D


def small_zamba_kernel_checks(dev):
    """ssm_scan at n = 64 in f32 (1e-4) at L and dm off its tile, with and
    without h0, and with a per-head-broadcast A; in bf16 at zamba2's
    prefill shape (4 x 512 x 7168; y one bf16 rounding, hT 1e-3 of its
    largest). flash_fwd at d = 112 on both kernels at ragged Sq != Skv,
    causal: the tensor-core one on bf16 q, k and v laid out as the
    projections' strided views, at check_flash_tc's limits, the CUDA-core
    one on f32 copies of the same values within 1e-4.
    Returns (max |err| of ssm_scan, of flash_fwd)."""
    import torch

    from repro_torch.kernels.flash_attention import (flash_attention_fwd,
                                                     flash_fwd_ref)
    from repro_torch.kernels.ssm_scan import selective_scan_ref, ssm_scan_fwd

    g = torch.Generator(device=dev).manual_seed(61)
    tol = dict(atol=1e-4, rtol=1e-4)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev)

    n, serr, ferr = 64, 0.0, 0.0
    for bt, L, dm, head in ((2, 129, 17, 0), (1, 300, 40, 0), (2, 1, 5, 0),
                            (1, 1000, 33, 0), (1, 200, 96, 32)):
        x = rnd(bt, L, dm)
        delta = torch.nn.functional.softplus(rnd(bt, L, dm)) * 0.1
        if head:
            a = -(rnd(dm // head).abs() + 0.5)
            A = a.repeat_interleave(head)[:, None].expand(dm, n).contiguous()
        else:
            A = -(rnd(dm, n).abs() + 0.1)
        B, C, D = rnd(bt, L, n), rnd(bt, L, n), rnd(dm)
        for h0 in (rnd(bt, dm, n), None):
            y, hT = ssm_scan_fwd(x, delta, A, B, C, D, h0=h0)
            ry, rhT = selective_scan_ref(x, delta, A, B, C, D, h0=h0)
            tag = (f"ssm_scan f32 bt={bt} L={L} dm={dm} n={n} "
                   f"h0={h0 is not None} A {'a head' if head else 'free'}")
            serr = max(serr, check_close(tag + " y", y, ry, **tol))
            check_close(tag + " hT", hT, rhT, **tol)
    args = _zamba_scan_inputs(dev, g, ZB_BATCH, ZB_PROMPT, torch.bfloat16)
    y, hT = ssm_scan_fwd(*args)
    ry, rhT = selective_scan_ref(*args)
    serr = max(serr, check_close(
        f"ssm_scan bf16 y at zamba2's prefill {tuple(y.shape)}, n 64", y, ry,
        atol=1e-2, rtol=2 ** -7))
    check_rel("ssm_scan bf16 hT (f32) at zamba2's prefill", hT, rhT, 1e-3)
    del args, y, hT, ry, rhT

    d = 112
    for sq, skv in ((5, 5), (70, 70), (130, 200), (1, 77), (200, 333)):
        q = _proj(g, 2, skv, 4, d)[:, :, skv - sq:]
        k, v = _proj(g, 2, skv, 4, d), _proj(g, 2, skv, 4, d)
        ferr = max(ferr, check_flash_tc(
            f"flash_fwd bf16 d=112 sq={sq} skv={skv} (views)", q, k, v,
            causal=True))
        qf, kf, vf = (t.float() for t in (q, k, v))
        before = flash_attention_fwd.routes["simt"]
        o, lse = flash_attention_fwd(qf, kf, vf, causal=True)
        if flash_attention_fwd.routes["simt"] != before + 1:
            fail("flash_fwd f32 d=112: did not take the CUDA-core route")
        ro, rlse = flash_fwd_ref(qf, kf, vf, causal=True)
        ferr = max(ferr, check_close(
            f"flash_fwd f32 d=112 sq={sq} skv={skv} o", o, ro, **tol))
        check_close(f"flash_fwd f32 d=112 sq={sq} skv={skv} lse", lse, rlse,
                    **tol)
    torch.cuda.synchronize()
    return serr, ferr


def _zamba_cfg(**changes):
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("zamba2_7b"), **changes)


def two_layer_zamba_f32_checks():
    """zamba2 at full width with 3 layers in f32: one group of 2 mamba2
    layers and the shared attention block (shared_attn_every = 2), then a
    tail of 1; one set of weights, drawn on the card and copied to the CPU,
    runs on the card (kernels) and on the CPU (plain versions). Prefill
    logits of 2 x 64 tokens within 1e-3 of the largest logit (f32 sums in
    other orders), and ``generate``'s first 8 greedy tokens equal; the
    training loss and every gradient on the same tokens
    (_train_card_vs_cpu: the shared block's d = 112 backward)."""
    import numpy as np
    import torch

    from repro_torch.launch.serve import generate
    from repro_torch.models import LM, tree_to

    cfg = _zamba_cfg(n_layers=3, shared_attn_every=2, dtype="float32")
    cpu, gpu = LM(cfg, device="cpu"), LM(cfg)
    t0 = time.perf_counter()
    p_gpu = gpu.init(torch.Generator(device=gpu.device).manual_seed(15))
    p_cpu = tree_to(p_gpu, "cpu")
    kinds = [(s.kind, s.n, s.group) for s in gpu.program]
    tag = f"3-layer f32 zamba2 {kinds}"
    if kinds != [("zamba_group", 1, 2), ("mamba2", 1, 0)]:
        fail(f"{tag}: unexpected program")
    log(f"[zamba f32] {tag}: {gpu.param_count(p_gpu)} parameters, drawn on "
        f"the card and copied in {time.perf_counter() - t0:.1f}s")
    prompts = np.random.RandomState(16).randint(1, cfg.vocab_size, (2, 64))
    toks = torch.from_numpy(prompts)
    with torch.no_grad():
        lg, _ = gpu.prefill(p_gpu, toks.to(gpu.device))
        lc, _ = cpu.prefill(p_cpu, toks)
    out_g, st = generate(gpu, p_gpu, prompts, gen_tokens=8)
    out_c, _ = generate(cpu, p_cpu, prompts, gen_tokens=8)
    check_rel(f"{tag} prefill logits, card vs CPU", lg.cpu(), lc, 1e-3)
    if st["engine"] or not np.array_equal(out_c, out_g):
        fail(f"{tag}: greedy tokens CPU {out_c.tolist()} != card "
             f"{out_g.tolist()}")
    log(f"[zamba f32] {tag}: 8 static tokens agree, card == CPU (first row "
        f"{out_g[0].tolist()})")
    _train_card_vs_cpu(tag, cpu, gpu, p_cpu, p_gpu, {"tokens": toks})
    del cpu, gpu, p_gpu, p_cpu
    torch.cuda.empty_cache()


class _DecodeTwin:
    """While active, each mamba2 mixer's and each GQA attention's decode is
    held against its full-sequence forward, teacher forced: the input the
    prefill gave the mixer (or the attention) is recorded, and at the i-th
    decode call the forward runs over it with the decode's own input
    appended; the model goes on with the decode's output. Recorded, call
    by call: the largest |decode - forward's last row| over the largest
    |forward's last row| of the same token. The mixer's output is compared
    before the block's residual add, whose bf16 rounding at the residual's
    scale would hide it. Each mamba2 decode also runs on copies of its
    cache with a planted fault (the SSD state zeroed; the conv tail one
    row late), and each attention decode on a copy written one position
    early (the prompt's last key overwritten). ``mamba._mamba2_scan``,
    ``mamba.mamba2_decode``, ``attention.gqa_forward`` and
    ``attention.gqa_decode`` are wrapped and restored on exit."""

    FAULTS = ("SSD state zeroed", "conv tail one row late",
              "attention one position early")

    def __enter__(self):
        import torch

        from repro_torch.layers import attention, mamba

        self.err = {"mamba2": [], "attention": []}
        self.fault = {f: [] for f in self.FAULTS}
        pre = {"mamba2": [], "attention": []}
        ndec = {"mamba2": 0, "attention": 0}
        self._mods = (mamba, attention)
        self._orig = (mamba._mamba2_scan, mamba.mamba2_decode,
                      attention.gqa_forward, attention.gqa_decode)
        scan, m_dec, fwd, a_dec = self._orig

        def rel(y, ref):
            err = (y.float() - ref.float()).abs().amax(-1)
            return float((err / ref.float().abs().amax(-1)).max())

        def forward_row(kind, f, x):
            i = ndec[kind]
            ndec[kind] += 1
            return f(torch.cat([pre[kind][i], x], dim=1))[:, -1:]

        def rec_scan(params, x, cfg):
            pre["mamba2"].append(x.detach().clone())
            return scan(params, x, cfg)

        def twin_m(params, x, cache, cfg):
            with torch.no_grad():
                ref = forward_row("mamba2",
                                  lambda xs: scan(params, xs, cfg)[0], x)
                conv = cache["conv"]
                for name, c in (
                        ("SSD state zeroed",
                         {"conv": conv.clone(),
                          "h": torch.zeros_like(cache["h"])}),
                        ("conv tail one row late",
                         {"conv": torch.cat([conv[:, :1], conv[:, :-1]], 1),
                          "h": cache["h"].clone()})):
                    self.fault[name].append(rel(m_dec(params, x, c, cfg)[0],
                                                ref))
            y, cache = m_dec(params, x, cache, cfg)
            self.err["mamba2"].append(rel(y, ref))
            return y, cache

        def rec_fwd(params, x, cfg, **kw):
            if kw.get("return_kv"):
                pre["attention"].append(x.detach().clone())
            return fwd(params, x, cfg, **kw)

        def twin_a(params, x, cache, cfg, *, pos, split=None):
            with torch.no_grad():
                ref = forward_row("attention",
                                  lambda xs: fwd(params, xs, cfg), x)
                c = {k: v.clone() for k, v in cache.items()}
                self.fault["attention one position early"].append(
                    rel(a_dec(params, x, c, cfg, pos=pos - 1,
                              split=split)[0], ref))
            y, cache = a_dec(params, x, cache, cfg, pos=pos, split=split)
            self.err["attention"].append(rel(y, ref))
            return y, cache

        (mamba._mamba2_scan, mamba.mamba2_decode, attention.gqa_forward,
         attention.gqa_decode) = rec_scan, twin_m, rec_fwd, twin_a
        return self

    def __exit__(self, *exc):
        mamba, attention = self._mods
        (mamba._mamba2_scan, mamba.mamba2_decode, attention.gqa_forward,
         attention.gqa_decode) = self._orig


def zamba_decode_twin(model, params, seed):
    """Prefill 2 x 64 tokens and one decode step with ``_DecodeTwin``
    active: every mamba2 mixer and shared-attention application within
    ZB_TWIN_REL of its forward, and every planted fault above it. Also
    prints, not gated, the model's prefill + decode_step logits against
    ``forward`` over the same 65 tokens (a layer's bf16 roundings apart
    at each layer: products of other shapes, the recurrence against the
    scan). Returns (the largest reading, the smallest fault reading)."""
    import numpy as np
    import torch

    cfg = model.cfg
    toks = torch.from_numpy(np.random.RandomState(seed).randint(
        0, cfg.vocab_size, (2, 65))).to(model.device)
    with torch.no_grad():
        full, _ = model.forward(params, toks)
        with _DecodeTwin() as tw:
            lp, cache = model.prefill(params, toks[:, :64], max_len=96)
            ld, _ = model.decode_step(params, toks[:, 64:], cache)
    for what, t in (("forward", full), ("prefill", lp), ("decode_step", ld)):
        if not torch.isfinite(t).all():
            fail(f"zamba2_7b bf16 seed {seed} {what}: non-finite logits")
    napp = cfg.n_layers // cfg.shared_attn_every
    for kind, n in (("mamba2", cfg.n_layers), ("attention", napp)):
        if len(tw.err[kind]) != n:
            fail(f"zamba2_7b decode twin seed {seed}: {len(tw.err[kind])} "
                 f"{kind} decodes held, want {n}")
    worst = max(max(v) for v in tw.err.values())
    least = min(min(v) for v in tw.fault.values())
    whole = float((ld.float() - full[:, -1].float()).abs().max()
                  / full[:, -1].float().abs().max())
    log(f"[zamba twin] seed {seed}: decode vs forward, teacher forced, "
        f"largest over a row's largest: mamba2 mixers max "
        f"{max(tw.err['mamba2']):.4%} (median "
        f"{float(np.median(tw.err['mamba2'])):.4%}), attention max "
        f"{max(tw.err['attention']):.4%} (limit {ZB_TWIN_REL:.0%}); planted "
        "faults, smallest / median over the layers: " + "; ".join(
            f"{k} {min(v):.2%} / {float(np.median(v)):.2%}"
            for k, v in tw.fault.items())
        + f"; whole model prefill + decode_step vs forward (not gated) "
        f"{whole:.4%} of the largest logit")
    if worst > ZB_TWIN_REL:
        fail(f"zamba2_7b decode twin seed {seed}: a decode reads "
             f"{worst:.4%} off its forward (limit {ZB_TWIN_REL:.0%})")
    if least <= ZB_TWIN_REL:
        fail(f"zamba2_7b decode twin seed {seed}: a planted fault reads "
             f"{least:.4%}, within the limit {ZB_TWIN_REL:.0%}")
    return worst, least


def zamba_main_path():
    """zamba2_7b in bf16 at full width and ZB_LAYERS mamba2 layers (the
    shared attention block after every 6, each application with its own
    KV cache; a tail of 3) through ``generate`` (the static path: a zamba
    group is not pageable): ZB_BATCH prompts of ZB_PROMPT tokens, ZB_GEN
    new, launch counts zeroed just before and read just after. ssm_scan
    must launch once per mamba2 layer of the prefill, flash_fwd once per
    application (on the tensor cores), flash_decode once per application
    and decode step, rmsnorm (layers + 2 x applications + 1) per pass and
    the decode head once per pass.
    Then where a decode step's time goes; each mamba2 mixer's and each
    shared-attention application's decode against its forward, teacher
    forced, on ZB_TWIN_SEEDS prompt sets (``zamba_decode_twin``), every
    logit finite; ``forward`` on 1 x ZB_FWD_SEQ tokens (ssm_scan once a
    layer) against prefill's last logits. Returns (counts, stats)."""
    import numpy as np
    import torch

    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.kernels.rmsnorm import rmsnorm

    model, params = _full_model("zamba2_7b", 71, n_layers=ZB_LAYERS)
    cfg = model.cfg
    prog = [(s.kind, s.n, s.group) for s in model.program]
    if prog != [("zamba_group", ZB_LAYERS // 6, 6),
                ("mamba2", 3, 0)] or model.pageable:
        fail(f"zamba2_7b: program {prog}, pageable {model.pageable}")
    b, plen, ngen = ZB_BATCH, ZB_PROMPT, ZB_GEN
    prompts = np.random.RandomState(71).randint(0, cfg.vocab_size,
                                                (b, plen))
    out, stats, counts = _static_run(model, params, prompts, ngen)
    napp, passes = cfg.n_layers // cfg.shared_attn_every, ngen + 1
    want = {"ssm_scan": cfg.n_layers, "flash_fwd": napp,
            "flash_decode": napp * ngen,
            "rmsnorm": passes * (cfg.n_layers + 2 * napp + 1),
            "lm_head": passes}
    for name, n in want.items():
        if counts[name] != n:
            fail(f"zamba2_7b: {name} launched {counts[name]} times in "
                 f"generate, want {n}")
    log("zamba2_7b static path kernels: " + ", ".join(
        f"{k}={counts[k]}" for k in want) + f" (rmsnorm routes "
        f"{rmsnorm.routes})")
    log(f"[zamba2_7b] generate B={b} prompt={plen} new={ngen} "
        f"({cfg.n_layers} mamba2 layers, {napp} shared-attention "
        f"applications): prefill {stats['prefill_s'] * 1e3:.3f} ms, decode "
        f"{stats['decode_s']:.3f}s = {stats['decode_s'] * 1e3 / ngen:.3f} "
        f"ms/step, {stats['tokens_per_s']:.1f} tok/s; first row "
        f"{out[0, :12].tolist()}")
    step_ms, busy_ms = profile_static_step(model, params, prompts)
    wbytes, _ = _decode_weight_bytes(model, params)
    log(f"[zamba2_7b] decode step bound: every weight the step reads, "
        f"{wbytes / 1e9:.2f} GB over {HBM_BPS / 1e12:.2f} TB/s = "
        f"{wbytes / HBM_BPS * 1e3:.3f} ms; the step took {step_ms:.3f} ms "
        f"on the host clock, {busy_ms:.3f} ms busy")

    twin = [zamba_decode_twin(model, params, seed)
            for seed in ZB_TWIN_SEEDS]
    log(f"[zamba twin] over {len(twin)} prompt sets: decode vs forward at "
        f"most {max(w for w, _ in twin):.4%}, planted faults at least "
        f"{min(f for _, f in twin):.2%} (limit {ZB_TWIN_REL:.0%})")

    toks = torch.from_numpy(np.random.RandomState(72).randint(
        0, cfg.vocab_size, (1, ZB_FWD_SEQ))).to(model.device)
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
    if fcounts["ssm_scan"] != cfg.n_layers or fcounts["flash_fwd"] != napp:
        fail(f"zamba2_7b forward: ssm_scan launched {fcounts['ssm_scan']} "
             f"times (want {cfg.n_layers}), flash_fwd "
             f"{fcounts['flash_fwd']} (want {napp})")
    if not (torch.isfinite(full).all() and torch.isfinite(lp).all()):
        fail("zamba2_7b forward/prefill: non-finite logits")
    # the same kernels and the same bf16 ops on both sides: equal up to the
    # LM head's row count (1e-3 covers its f32 sums in another order)
    check_close("zamba2_7b bf16 forward vs prefill last-position logits",
                lp, full[:, -1], atol=1e-3, rtol=1e-3)
    log(f"[zamba2_7b] forward B=1 S={ZB_FWD_SEQ}: {fwd_ms:.3f} ms "
        f"(ssm_scan x{fcounts['ssm_scan']}, flash_fwd "
        f"x{fcounts['flash_fwd']}); prefill of the same tokens "
        f"{prefill_ms:.3f} ms")
    stats.update(step_ms=step_ms, busy_ms=busy_ms, fwd_ms=fwd_ms,
                 prefill_ms=prefill_ms)
    del model, params, full
    torch.cuda.empty_cache()
    return counts, stats


def time_zamba_kernels(dev):
    """ssm_scan at zamba2's forward (1 x 2048) and prefill (4 x 512)
    shapes, d_inner 7168, state 64 (library: none), and flash_fwd at its
    prefill shape (q, k, v (4, 32, 512, 112), the projections' views,
    causal; held at check_flash_tc's limits first; library: SDPA causal),
    each beside its bound and its plain version's time. The scan's bound
    counts L dm n exponentials (the TPU op's contract: A is (dm, n)); its
    per-head bound, beside it, what A constant along n needs
    (``scan_head_bound``);
    flash_fwd's 4 d H FLOPs a visible pair and each byte once. Returns
    (times, max |err| of flash_fwd)."""
    import torch

    from repro_torch.kernels.ssm_scan import selective_scan_ref, ssm_scan_fwd

    gen = torch.Generator(device=dev).manual_seed(73)
    out = {}
    for name, bt, L in (("ssm_scan@zamba", 1, ZB_FWD_SEQ),
                        ("ssm_scan@zamba_prefill", ZB_BATCH, ZB_PROMPT)):
        args = _zamba_scan_inputs(dev, gen, bt, L, torch.bfloat16)
        dm, n = args[0].shape[2], args[2].shape[1]
        out[name] = dict(
            ms=cuda_ms(lambda: ssm_scan_fwd(*args), iters=10, warmup=2),
            device_ms=device_ms(lambda: ssm_scan_fwd(*args), "ssm_scan",
                                n=10, launches=1),
            plain_ms=cuda_ms(lambda: selective_scan_ref(*args), iters=2,
                             warmup=1),
            library_ms=None,
            library="none: no single PyTorch call computes it",
            exps=bt * L * dm * n,
            shape=f"x ({bt},{L},{dm}) bf16, delta f32, A a head, B/C "
                  f"({bt},{L},{n}) bf16")
        out[name].update(zip(("bound_ms", "bound_by"),
                             scan_bound(bt, L, dm, n, 2)))
        out[name].update(zip(("head_bound_ms", "head_bound_by"),
                             scan_head_bound(bt, L, dm, n, 2)))
        del args

    cfg = _zamba_cfg()
    b, s, h, d = ZB_BATCH, ZB_PROMPT, cfg.n_heads, cfg.resolved_head_dim
    q, k, v = (_proj(gen, b, s, h, d) for _ in range(3))
    err = check_flash_tc(f"flash_fwd bf16 at zamba2's prefill q "
                         f"{tuple(q.shape)}", q, k, v, causal=True)
    pairs = b * s * (s + 1) // 2
    out["flash_fwd@zamba"] = dict(
        **flash_times(q, k, v, iters=30, plain_iters=5),
        flops=4 * h * d * pairs,
        shape=f"q/k/v ({b},{h},{s},{d}) views bf16, causal")
    out["flash_fwd@zamba"].update(zip(("bound_ms", "bound_by"), bound(
        2 * b * 4 * h * s * d + 4 * b * h * s, 4 * h * d * pairs,
        "bfloat16")))
    del q, k, v
    torch.cuda.empty_cache()
    return out, err


# ---------------------------------------------------------------------------
# phase 2a: the compiled decode steps against the eager ones
# ---------------------------------------------------------------------------

def greedy_steps(model, params, prompts, nsteps, max_len, step=None):
    """(tokens (nsteps, B), logits (nsteps, B, Vpad), launch counts, route
    counts) of ``nsteps`` greedy steps after a prefill of ``prompts``:
    through ``step`` (a built serve step), else ``model.greedy_step``
    eagerly; the counts cover the steps alone."""
    import torch

    from repro_torch.kernels import launch_counts, reset_launches

    toks = torch.as_tensor(prompts, device=model.device)
    with torch.no_grad():
        logits, cache = model.prefill(params, toks, max_len=max_len)
        tok = model.greedy_token(logits)[:, None]
        if step is None:
            def step(p, c, t):
                return model.greedy_step(p, t, c)
        torch.cuda.synchronize()
        reset_launches()
        out, lgs = [], []
        for _ in range(nsteps):
            nxt, lg, cache = step(params, cache, tok)
            out.append(nxt.clone())
            lgs.append(lg.clone())
            tok = nxt[:, None]
    torch.cuda.synchronize()
    return (torch.stack(out), torch.stack(lgs), launch_counts(),
            route_counts())


def _same_steps(tag, eager, graph):
    """Fail unless the compiled run's tokens and counts are the eager
    run's; returns how its logits compare."""
    import torch

    if not torch.equal(graph[0], eager[0]):
        fail(f"{tag}: compiled tokens {graph[0].tolist()} != eager "
             f"{eager[0].tolist()}")
    if graph[2:] != eager[2:]:
        fail(f"{tag}: compiled launch/route counts {graph[2:]} != eager "
             f"{eager[2:]}")
    if torch.equal(graph[1], eager[1]):
        return "bit for bit"
    return f"max|diff| {float((graph[1] - eager[1]).abs().max()):.3e}"


def small_compiled_step_checks(dev):
    """The compiled steps in bf16 at llama3_2_1b's full width with 2
    layers, each against the eager step on the same inputs (tokens, launch
    and route counts equal; logits compared and printed): (a) the engine's
    paged step on traffic that admits and retires sequences between
    replays (6 requests, 2 slots); (b) a window of 64 whose rolling cache
    wraps during the replays (40-token prompts, 60 steps); (c) one static
    step serving a cache, then handed the cache of a second prefill, which
    it refuses (it never replays onto the first cache's addresses); (d)
    the sampled paths, with the same generator seed each way: ``generate``
    on the static path and an engine, both with ``greedy=False``, their
    tokens and launch counts equal eager code's."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.launch import serve
    from repro_torch.models import LM
    from repro_torch.parallel import GraphStep, build_serve_step
    from repro_torch.serving import Engine

    def model_of(**changes):
        cfg = dataclasses.replace(get_config("llama3_2_1b"), n_layers=2,
                                  **changes)
        model = LM(cfg)
        return model, model.init(
            torch.Generator(device=dev).manual_seed(13))

    model, params = model_of()
    vocab = model.cfg.vocab_size
    rng = np.random.RandomState(14)
    traffic = [(rng.randint(0, vocab, n).tolist(), g)
               for n, g in ((5, 9), (70, 4), (3, 12), (130, 6), (8, 7),
                            (40, 5))]
    runs = []
    for compiled in (False, True):
        eng = Engine(model, params, batch=2, max_len=256, page_size=64)
        if not compiled:
            eng._step = lambda p, c, t: model.paged_greedy_step(p, t, c)
        torch.cuda.synchronize()
        reset_launches()
        rids = [eng.submit(p, g) for p, g in traffic]
        res = eng.drain()
        torch.cuda.synchronize()
        runs.append(([res[r] for r in rids], launch_counts(),
                     route_counts()))
    if not isinstance(eng._step, GraphStep) or eng._step.captures != 1:
        fail("compiled engine step: not a GraphStep captured once")
    if runs[1] != runs[0]:
        fail(f"compiled engine step: tokens/counts {runs[1]} != eager "
             f"{runs[0]}")
    log(f"[compiled] engine step (2 layers bf16, 2 slots, {len(traffic)} "
        f"requests admitted and retired between replays): tokens and "
        f"launch counts equal eager ({sum(map(len, runs[1][0]))} tokens, "
        f"paged_decode {runs[1][1]['paged_decode']})")

    wmodel, wparams = model_of(window=64)
    prompts = np.random.RandomState(15).randint(0, vocab, (2, 40))
    step, _ = build_serve_step(wmodel, batch=2)
    eager = greedy_steps(wmodel, wparams, prompts, 60, 101)
    graph = greedy_steps(wmodel, wparams, prompts, 60, 101, step)
    same = _same_steps("compiled window step", eager, graph)
    log(f"[compiled] window 64 step across the wrap (40 + 60 positions): "
        f"tokens and launch counts equal eager, logits {same}")

    step, _ = build_serve_step(model, batch=2)
    rng = np.random.RandomState(16)
    prompts = rng.randint(0, vocab, (2, 10))
    eager = greedy_steps(model, params, prompts, 6, 24)
    graph = greedy_steps(model, params, prompts, 6, 24, step)
    same = _same_steps("compiled step", eager, graph)
    with torch.no_grad():
        _, other = model.prefill(
            params, torch.as_tensor(rng.randint(0, vocab, (2, 10)),
                                    device=dev), max_len=24)
    tok = torch.zeros((2, 1), dtype=torch.long, device=dev)
    try:
        step(params, other, tok)
        fail("compiled step: replayed onto a second cache")
    except ValueError as e:
        if "first call" not in str(e):
            raise
    if step.captures != 1:
        fail(f"compiled step: {step.captures} captures, want one")
    log(f"[compiled] static step: tokens and launch counts equal eager, "
        f"logits {same}; the cache of a second prefill refused")

    def eager_builder(model, *, batch, greedy=True, split=None):
        method = model.greedy_step if greedy else model.decode_step
        return (lambda p, c, t: method(p, t, c, split=split)), {
            "greedy": greedy, "cuda_graph": False}

    prompts = rng.randint(0, vocab, (2, 24))
    runs = []
    for compiled in (False, True):
        serve.build_serve_step = build_serve_step if compiled else (
            eager_builder)
        try:
            torch.cuda.synchronize()
            reset_launches()
            out, stats = serve.generate(
                model, params, prompts, gen_tokens=12, engine="static",
                greedy=False, temperature=0.8,
                rng=torch.Generator(device=dev).manual_seed(17))
            torch.cuda.synchronize()
        finally:
            serve.build_serve_step = build_serve_step
        runs.append((out.tolist(), launch_counts(), route_counts()))
    if stats["engine"] or runs[1] != runs[0]:
        fail(f"compiled sampled static path: tokens/counts {runs[1]} != "
             f"eager {runs[0]}")
    sruns = []
    for compiled in (False, True):
        eng = Engine(model, params, batch=2, max_len=256, page_size=64,
                     greedy=False, temperature=0.8,
                     rng=torch.Generator(device=dev).manual_seed(18))
        if not compiled:
            eng._step = lambda p, c, t: model.paged_decode_step(p, t, c)
        torch.cuda.synchronize()
        reset_launches()
        rids = [eng.submit(p, g) for p, g in traffic]
        res = eng.drain()
        torch.cuda.synchronize()
        sruns.append(([res[r] for r in rids], launch_counts(),
                      route_counts()))
    if not isinstance(eng._step, GraphStep) or eng._step.captures != 1:
        fail("compiled sampling engine step: not a GraphStep captured once")
    if sruns[1] != sruns[0]:
        fail(f"compiled sampling engine: tokens/counts {sruns[1]} != eager "
             f"{sruns[0]}")
    log(f"[compiled] sampled paths (temperature 0.8, seeded): the static "
        f"loop's {12 * len(prompts)} tokens and the engine's "
        f"{sum(map(len, sruns[1][0]))} equal eager code's, launch counts "
        f"equal")
    del model, params, wmodel, wparams, step, eng, other
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# paligemma: phases 2a, 3, 17 and 8 for flash_fwd at d = 256 under the
# prefix-LM mask and paged decode at d = 256 with 8 query heads a kv head
# ---------------------------------------------------------------------------

def _rows_ratio(got, ref):
    """max |got - ref| over the largest |ref| of its row (the last dim)."""
    got, ref = got.float(), ref.float()
    return float(((got - ref).abs()
                  / ref.abs().amax(-1, keepdim=True)).max())


def small_paligemma_kernel_checks(dev):
    """flash_fwd at d = 256 on both kernels at ragged Sq != Skv, groups 1,
    2 and 8: bf16 q, k and v laid out as the projections' strided views on
    the tensor cores (check_flash_tc's limits), f32 copies of the same
    values on the CUDA cores (1e-4); the prefix-LM mask with prefix_len 0,
    off the tile (37), a whole 64-row tile and past Sq, with and without a
    window of 24, at d 64, 128 and 256, on both kernels; a planted
    comparison: a prefix launch held against the causal-only plain version
    must read above the limit (a kernel that treated the prefix as causal
    would pass only there); paged decode at d = 256 with 8 query heads a
    kv head (g d = 2048) in f32 (1e-4) and bf16 (2e-2) with the split rule's
    length and every length it may take (32, 64, ..., 512) forced, on
    block tables laid out as the engine lays them (logical slot l holds
    position l or -1). Returns (max |err| of flash_fwd, of paged_decode)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import (flash_attention_fwd,
                                                     flash_fwd_ref,
                                                     paged_decode_attention,
                                                     paged_decode_ref)
    from repro_torch.kernels.flash_attention import ops as attn_ops

    g = torch.Generator(device=dev).manual_seed(81)
    tol = dict(atol=1e-4, rtol=1e-4)
    err = {"flash_fwd": 0.0, "paged_decode": 0.0}

    def both(tag, q, k, v, **kw):
        """bf16 views on the tensor cores, f32 copies on the CUDA cores."""
        e = check_flash_tc(f"{tag} bf16", q, k, v, quiet=True, **kw)
        qf, kf, vf = (t.float() for t in (q, k, v))
        before = flash_attention_fwd.routes["simt"]
        o, lse = flash_attention_fwd(qf, kf, vf, **kw)
        if flash_attention_fwd.routes["simt"] != before + 1:
            fail(f"{tag} f32: did not take the CUDA-core route")
        ro, rlse = flash_fwd_ref(qf, kf, vf, **kw)
        e = max(e, check_close(f"{tag} f32 o", o, ro, quiet=True, **tol))
        check_close(f"{tag} f32 lse", lse, rlse, quiet=True, **tol)
        err["flash_fwd"] = max(err["flash_fwd"], e)

    shapes = ((5, 5, 8, 1), (70, 70, 8, 1), (130, 200, 8, 1), (1, 77, 4, 4),
              (200, 333, 8, 2), (64, 64, 4, 4))
    for sq, skv, h, hk in shapes:
        q = _proj(g, 2, skv, h, 256)[:, :, skv - sq:]
        k, v = _proj(g, 2, skv, hk, 256), _proj(g, 2, skv, hk, 256)
        both(f"flash_fwd d=256 sq={sq} skv={skv} h={h}/{hk}", q, k, v,
             causal=True)
    log(f"[check] flash_fwd d=256: {len(shapes)} shapes on both kernels "
        f"(bf16 views at check_flash_tc's limits, f32 within 1e-4), "
        f"max|err| {err['flash_fwd']:.3e}")

    n = 0
    for d in (64, 128, 256):
        for sq, skv in ((150, 150), (100, 230)):
            q = _proj(g, 2, skv, 8, d)[:, :, skv - sq:]
            k, v = _proj(g, 2, skv, 1, d), _proj(g, 2, skv, 1, d)
            for prefix in (0, 37, 64, sq + 40):
                for window in (None, 24):
                    both(f"flash_fwd d={d} sq={sq} skv={skv} prefix="
                         f"{prefix} window={window}", q, k, v, causal=True,
                         window=window, prefix_len=prefix)
                    n += 1
    log(f"[check] flash_fwd prefix-LM mask: {n} cases on both kernels "
        f"(prefix 0, 37, a whole tile, past Sq; window none and 24; d 64, "
        f"128 and 256; group 8), max|err| {err['flash_fwd']:.3e}")

    q = _proj(g, 2, 300, 8, 256)
    k, v = _proj(g, 2, 300, 1, 256), _proj(g, 2, 300, 1, 256)
    o, _ = flash_attention_fwd(q, k, v, causal=True, prefix_len=256)
    planted = _rows_ratio(o, flash_fwd_ref(q, k, v, causal=True)[0])
    if planted <= 2 ** -6:
        fail(f"flash_fwd prefix 256 against the causal-only plain version: "
             f"{planted:.3e} of a row's largest |o|, within the 2^-6 limit: "
             "the check cannot tell a prefix treated as causal")
    log(f"[check] planted: flash_fwd with prefix 256 against the "
        f"causal-only plain version reads {planted:.3e} of a row's largest "
        f"|o|, above the 2^-6 = {2 ** -6:.3e} limit: a kernel that treated "
        "the prefix as causal fails the check")

    cfg = get_config("paligemma_3b")
    lens = [1000, 241, 0, 700, 33, 512, 999, 64]
    splits = (None, *range(32, 513, 32))    # the rule's, then every length
    rule = attn_ops.paged_split
    for dtype, ptol in ((torch.float32, tol),
                        (torch.bfloat16, dict(atol=2e-2, rtol=2e-2))):
        pools, table, kv_len, pos = paged_state(dev, cfg, lens, 512, 33, 1,
                                                dtype, g)
        qd = torch.randn((len(lens), 8, 1, 256), generator=g,
                         device=dev).to(dtype)
        kw = dict(block_table=table, kv_len=kv_len, pos_pages=pos)
        ro = paged_decode_ref(qd, *pools[0], **kw)
        for split in splits:
            if split is not None:
                attn_ops.paged_split = (lambda b, hk, nsp, page, sp=split:
                                        (sp, -(-nsp * page // sp)))
            try:
                o = paged_decode_attention(qd, *pools[0], **kw)
            finally:
                attn_ops.paged_split = rule
            err["paged_decode"] = max(err["paged_decode"], check_close(
                f"paged_decode {dtype} d=256 g=8 split={split}", o, ro,
                quiet=True, **ptol))
            if not (o[2] == 0).all():
                fail("paged_decode d=256: the idle slot must give exactly 0")
        del pools
    log(f"[check] paged_decode d=256 g=8 (g d 2048) in f32 and bf16, split "
        f"the rule's and each of 32, 64, ..., 512, lens {lens}: max|err| "
        f"{err['paged_decode']:.3e}")

    torch.cuda.synchronize()
    return err["flash_fwd"], err["paged_decode"]


def two_layer_paligemma_f32_checks():
    """paligemma_3b at full width with 2 layers in f32, one set of weights
    drawn on the card and copied to the CPU, run on the card (kernels) and
    on the CPU (plain versions): prefill logits over 256 seeded prefix
    embeddings and 64 tokens (2 rows) within 1e-3 of the largest logit
    (f32 sums in other orders); the first 8 greedy tokens equal, card vs
    CPU, through ``generate`` on the engine (the default: paligemma is
    pageable; pages of 16) and on the static path; the engine's tokens
    equal the static path's; and the training loss and every gradient over
    the same prefix and tokens (_train_card_vs_cpu: d = 256 under the
    prefix-LM mask on the backward too)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate
    from repro_torch.models import LM, tree_to

    cfg = dataclasses.replace(get_config("paligemma_3b"), n_layers=2,
                              dtype="float32")
    cpu, gpu = LM(cfg, device="cpu"), LM(cfg)
    t0 = time.perf_counter()
    gen = torch.Generator(device=gpu.device).manual_seed(17)
    p_gpu = gpu.init(gen)
    p_cpu = tree_to(p_gpu, "cpu")
    tag = "2-layer f32 paligemma_3b"
    log(f"[paligemma f32] {tag}: {gpu.param_count(p_gpu)} parameters, "
        f"drawn on the card and copied in {time.perf_counter() - t0:.1f}s")
    prompts = np.random.RandomState(18).randint(1, cfg.vocab_size, (2, 64))
    toks = torch.from_numpy(prompts)
    pre = torch.randn((2, cfg.num_prefix_embeddings, cfg.d_model),
                      generator=gen, device=gpu.device)
    with torch.no_grad():
        lg, cg = gpu.prefill(p_gpu, toks.to(gpu.device),
                             prefix_embeddings=pre)
        lc, _ = cpu.prefill(p_cpu, toks, prefix_embeddings=pre.cpu())
    if cg["pos"] != cfg.num_prefix_embeddings + 64:
        fail(f"{tag}: prefill cache pos {cg['pos']}")
    v = cfg.vocab_size                  # past it, the padded vocab's -1e30
    check_rel(f"{tag} prefill logits (256 prefix embeddings + 64 tokens), "
              "card vs CPU", lg.cpu()[:, :v], lc[:, :v], 1e-3)
    outs = {}
    for path in ("auto", "static"):
        out_g, st = generate(gpu, p_gpu, prompts, gen_tokens=8, engine=path,
                             page_size=16)
        out_c, _ = generate(cpu, p_cpu, prompts, gen_tokens=8, engine=path,
                            page_size=16)
        if st["engine"] != (path == "auto") or not np.array_equal(out_c,
                                                                  out_g):
            fail(f"{tag} {path}: engine {st['engine']}, greedy tokens CPU "
                 f"{out_c.tolist()} != card {out_g.tolist()}")
        outs[path] = out_g
    if not np.array_equal(outs["auto"], outs["static"]):
        fail(f"{tag}: engine tokens {outs['auto'].tolist()} != static "
             f"tokens {outs['static'].tolist()}")
    log(f"[paligemma f32] {tag}: 8 greedy tokens agree, card == CPU, on the "
        f"engine and the static path, engine == static (first row "
        f"{outs['auto'][0].tolist()})")
    _train_card_vs_cpu(tag, cpu, gpu, p_cpu, p_gpu,
                       {"tokens": toks, "prefix_embeddings": pre.cpu()})
    del cpu, gpu, p_gpu, p_cpu
    torch.cuda.empty_cache()


def paligemma_main_path():
    """The whole paligemma_3b in bf16 (18 layers, 8 query heads of 256 over
    one kv head, d_ff 16384, vocab 257216 with an untied head), launch
    counts zeroed just before each run and read just after, each exact:

    (a) the engine (paligemma is pageable) on the serving traffic: 8 slots,
        page 512, 16 requests of 33-1000 prompt and 32-64 new tokens
        (``serve_main_path``): flash_fwd 18 a prefill, paged_decode 18 a
        decode step, rmsnorm 37 and the head once a pass; then where a
        decode step's time goes (``profile_decode``);
    (b) ``generate(engine="static")`` on PG_BATCH prompts of PG_PROMPT
        tokens, PG_GEN new: flash_fwd 18, flash_decode 18 x PG_GEN (row
        5d's first model path), rmsnorm 37 and the head once a pass; its
        decode step's profile;
    (c) ``prefill`` of PG_BATCH x (256 vision-stub prefix embeddings +
        PG_PROMPT tokens), one ``decode_step`` and PG_STEPS greedy steps:
        flash_fwd 18, flash_decode 18 a step. The prefill's last logits
        against ``forward`` over the same sequence (equal shapes, the same
        kernels: 1e-3), and prefill + decode_step against ``forward`` over
        the sequence one token longer (5% of the largest logit, as phase
        11 holds musicgen: other kernels and product shapes round bf16
        elsewhere over 18 layers).

    flash_fwd and the decode head take their tensor-core routes every
    time; every logit is finite. Returns {run: counts}."""
    import numpy as np
    import torch

    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.lm_head import lm_head_logits

    torch.cuda.reset_peak_memory_stats()
    model, params = _full_model("paligemma_3b", 91)
    cfg = model.cfg
    prog = [(s.kind, s.n) for s in model.program]
    if prog != [("dense", 18)] or not model.pageable:
        fail(f"paligemma_3b: program {prog}, pageable {model.pageable}")
    nl, per_pass = cfg.n_layers, 2 * cfg.n_layers + 1
    runs = {}

    def exact(what, counts, want):
        for name, n in want.items():
            if counts[name] != n:
                fail(f"paligemma_3b {what}: {name} launched {counts[name]} "
                     f"times, want {n}")
        log(f"paligemma_3b {what} kernels: " + ", ".join(
            f"{k}={counts[k]}" for k in want))

    # (a) the engine
    reqs = traffic(0, 16, cfg.vocab_size)
    counts, st = serve_main_path(cfg, model, params, reqs)
    npf, nst = st["prefill_calls"], st["decode_steps"]
    exact("engine", counts, {
        "flash_fwd": nl * npf, "paged_decode": nl * nst,
        "rmsnorm": per_pass * (npf + nst), "lm_head": npf + nst,
        "flash_decode": 0})
    runs["engine"] = counts
    log(f"[paligemma_3b] engine: {st['tokens']} tokens for {len(reqs)} "
        f"requests in {st['wall_s']:.3f}s = {st['tok_s']:.1f} tok/s "
        f"(prefills {npf}, decode steps {nst}, preempted {st['preempted']})")
    eng = profile_decode(model, params, reqs)

    # (b) the static path
    b, plen, ngen = PG_BATCH, PG_PROMPT, PG_GEN
    prompts = np.random.RandomState(92).randint(0, cfg.vocab_size,
                                                (b, plen))
    out, sst, counts = _static_run(model, params, prompts, ngen)
    check_tc_routes("paligemma_3b static path: lm_head",
                    lm_head_logits.routes, counts["lm_head"])
    exact("static path", counts, {
        "flash_fwd": nl, "flash_decode": nl * ngen, "paged_decode": 0,
        "rmsnorm": per_pass * (ngen + 1), "lm_head": ngen + 1})
    runs["static"] = counts
    log(f"[paligemma_3b] generate(engine='static') B={b} prompt={plen} "
        f"new={ngen}: prefill {sst['prefill_s'] * 1e3:.3f} ms, decode "
        f"{sst['decode_s']:.3f}s = {sst['decode_s'] * 1e3 / ngen:.3f} "
        f"ms/step, {sst['tokens_per_s']:.1f} tok/s; first row "
        f"{out[0, :12].tolist()}")
    step_ms, busy_ms = profile_static_step(model, params, prompts)

    # (c) the vision-stub prefix: prefill, one decode step, greedy steps
    dev, pn = model.device, cfg.num_prefix_embeddings
    gen = torch.Generator(device=dev).manual_seed(93)
    pre = torch.randn((b, pn, cfg.d_model), generator=gen,
                      device=dev).to(model.dtype)
    toks = torch.from_numpy(prompts).to(dev)
    with torch.no_grad():
        model.prefill(params, toks[:, :16], prefix_embeddings=pre)  # warm
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        lp, cache = model.prefill(params, toks, prefix_embeddings=pre,
                                  max_len=pn + plen + 1 + PG_STEPS)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        nxt = model.greedy_token(lp)[:, None]
        ld, cache = model.decode_step(params, nxt, cache)
        tok = model.greedy_token(ld)[:, None]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(PG_STEPS):
            nt, lg, cache = model.greedy_step(params, tok, cache)
            tok = nt[:, None]
        torch.cuda.synchronize()
        steps_ms = (time.perf_counter() - t0) * 1e3 / PG_STEPS
        counts = launch_counts()
        fwd_routes = dict(flash_attention_fwd.routes)
        if cache["pos"] != pn + plen + 1 + PG_STEPS:
            fail(f"paligemma_3b prefix: cache pos {cache['pos']}")
        if not all(torch.isfinite(t).all() for t in (lp, ld, lg)):
            fail("paligemma_3b prefix: non-finite logits")
        if not ((tok >= 0) & (tok < cfg.vocab_size)).all():
            fail("paligemma_3b prefix: tokens out of vocab")
        full, _ = model.forward(params, toks, prefix_embeddings=pre)
        # equal shapes and kernels: equal up to the LM head's row count
        check_close(f"paligemma_3b bf16 prefill ({pn} prefix embeddings + "
                    f"{plen} tokens) last logits vs forward over the same "
                    "sequence", lp, full[:, -1], atol=1e-3, rtol=1e-3)
        del full
        full, _ = model.forward(params, torch.cat([toks, nxt], dim=1),
                                prefix_embeddings=pre)
        if not torch.isfinite(full).all():
            fail("paligemma_3b forward: non-finite logits")
        check_rel("paligemma_3b bf16 prefill + decode_step logits vs "
                  "forward over the sequence one token longer",
                  ld[:, :cfg.vocab_size], full[:, -1, :cfg.vocab_size], 0.05)
        del full
    check_tc_routes("paligemma_3b prefix prefill: flash_fwd", fwd_routes,
                    counts["flash_fwd"])
    exact("prefix prefill + decode", counts, {
        "flash_fwd": nl, "flash_decode": nl * (1 + PG_STEPS),
        "rmsnorm": per_pass * (2 + PG_STEPS), "lm_head": 2 + PG_STEPS,
        "paged_decode": 0})
    runs["prefix"] = counts
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"[paligemma_3b] {model.param_count(params)} parameters; prefill of "
        f"{b} x ({pn} prefix embeddings + {plen} tokens) {prefill_ms:.3f} "
        f"ms, then {steps_ms:.3f} ms an eager greedy step (B={b}); engine "
        f"{st['tok_s']:.1f} tok/s, compiled step {eng['graph_ms']:.3f} ms "
        f"host at {eng['graph_dev_ms']:.3f} device (eager "
        f"{eng['eager_ms']:.3f} at {eng['eager_busy_ms']:.3f} busy); static "
        f"{sst['tokens_per_s']:.1f} tok/s, eager step {step_ms:.3f} ms host "
        f"at {busy_ms:.3f} busy; peak device memory {peak:.2f} GB")
    log(f"[paligemma_3b] row 5d: flash_decode launched "
        f"{runs['static']['flash_decode']} times on the static path "
        f"({nl} x {ngen})")
    del model, params, cache
    torch.cuda.empty_cache()
    return runs


def time_paligemma_kernels(dev, lens):
    """flash_fwd at paligemma's prefix-LM prefill (q PG_BATCH x 8 x (256 +
    PG_PROMPT) x 256, one kv head, the projections' views, causal with a
    256-token prefix; held at check_flash_tc's limits first; library: SDPA
    with the boolean mask), its bound 4 d H FLOPs a visible pair, and paged
    decode at d = 256, g = 8 over the serving step's ``lens`` (library: the
    pages gathered + SDPA; bound by bytes). Returns (times, max |err| of
    flash_fwd, of paged_decode)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import (flash_attention_fwd,
                                                     flash_fwd_ref)

    cfg = get_config("paligemma_3b")
    gen = torch.Generator(device=dev).manual_seed(94)
    p = cfg.num_prefix_embeddings
    b, s, h, hk, d = (PG_BATCH, p + PG_PROMPT, cfg.n_heads, cfg.n_kv_heads,
                      cfg.resolved_head_dim)
    q, k, v = (_proj(gen, b, s, n, d) for n in (h, hk, hk))
    kw = dict(causal=True, prefix_len=p)
    ferr = check_flash_tc(f"flash_fwd bf16 at paligemma's prefix-LM prefill "
                          f"q {tuple(q.shape)}, prefix {p}", q, k, v, **kw)
    qc, kc, vc = (t.contiguous() for t in (q, k, v))
    pos = torch.arange(s, device=dev)
    mask = (pos[:, None] >= pos[None, :]) | (pos[None, :] < p)
    pairs = sum(max(i + 1, p) for i in range(s))     # visible, a (b, h) row

    def run(kk, vv):
        return lambda: flash_attention_fwd(q, kk, vv, **kw)

    out = {"flash_fwd@paligemma": dict(
        ms=cuda_ms(run(k, v), iters=30),
        device_ms=device_ms(run(k, v), "fwd_tc_kernel", launches=1),
        device_ms_contig=device_ms(run(kc, vc), "fwd_tc_kernel", launches=1),
        plain_ms=cuda_ms(lambda: flash_fwd_ref(q, k, v, **kw), 5, 1),
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            qc, kc, vc, attn_mask=mask, enable_gqa=True), iters=30),
        library="F.scaled_dot_product_attention(attn_mask bool causal | "
                "prefix, enable_gqa) on contiguous q, k, v",
        flops=4 * b * h * d * pairs, pairs=pairs,
        shape=f"q ({b},{h},{s},{d}), k/v ({b},{hk},{s},{d}) bf16 views, "
              f"causal, prefix {p}")}
    out["flash_fwd@paligemma"].update(zip(("bound_ms", "bound_by"), bound(
        2 * b * (2 * h + 2 * hk) * s * d + 4 * b * h * s,
        4 * b * h * d * pairs, "bfloat16")))
    del q, k, v, qc, kc, vc
    out["paged_decode@paligemma"] = paged_times(dev, cfg, lens, 512, 33, gen)
    torch.cuda.empty_cache()
    return out, ferr, out["paged_decode@paligemma"]["err"]


# ---------------------------------------------------------------------------
# training the wide architectures: flash_bwd at d 112, 128 (CUDA cores),
# 256 with the prefix, and (192, 128); phases 2a, 3, 18 and 8
# ---------------------------------------------------------------------------

# (d_qk, d_v) of the new flash_bwd domains: zamba2's shared attention, the
# CUDA-core route's d = 128, paligemma's MQA and deepseek's MLA
WIDE_DIMS = ((112, 112), (128, 128), (256, 256), (192, 128))


def _wide_inputs(g, sq, skv, h, hk, d, dv):
    """q, k, v, do as the projections give them (bf16 views; q and do the
    last sq rows of projections of max(sq, skv) rows)."""
    n = max(sq, skv)
    return (_proj(g, 2, n, h, d)[:, :, n - sq:], _proj(g, 2, skv, hk, d),
            _proj(g, 2, skv, hk, dv), _proj(g, 2, n, h, dv)[:, :, n - sq:])


class _ForcedRoutes:
    """Routes the CPU's MoE layers as the card's: while recording (the card
    run), ``moe._router`` keeps each call's expert choices; while replaying
    (the CPU run, the same calls in the same order), each call takes the
    recorded choices instead of its own top-k, with its own probabilities
    at those experts as the gates (renormalised) and its own aux losses.
    A choice that flips between the devices at a near-tie of router
    probabilities is then a routing fact kept out of the comparison (the
    count of choices the CPU's own top-k would have made otherwise is
    kept), not a kernel fault. ``moe._router`` is restored on exit."""

    def __init__(self):
        self.idx, self.flips, self.gap = [], 0, float("inf")

    def _wrap(self, replay):
        import torch

        from repro_torch.layers import moe

        orig = moe._router
        calls = iter(list(self.idx)) if replay else None

        def router(params, x, cfg):
            gate, idx, aux = orig(params, x, cfg)
            if not replay:
                with torch.no_grad():
                    p = torch.softmax(x.float() @ params["router"], dim=-1)
                    top = torch.topk(p, cfg.n_experts_per_tok + 1,
                                     dim=-1).values
                    self.gap = min(self.gap, float((top[..., -2]
                                                    - top[..., -1]).min()))
                self.idx.append(idx.detach().cpu())
                return gate, idx, aux
            forced = next(calls).to(idx.device)
            self.flips += int((torch.sort(forced, -1).values
                               != torch.sort(idx, -1).values).any(-1).sum())
            logits = x.float() @ params["router"]
            probs = torch.softmax(logits, dim=-1)
            g = probs.gather(-1, forced)
            g = g / torch.clamp(g.sum(-1, keepdim=True), min=1e-9)
            e = cfg.n_experts
            me = probs.mean(dim=(0, 1))
            top1 = (forced[..., 0, None] == torch.arange(
                e, device=x.device)).float().mean(dim=(0, 1))
            return g, forced, {
                "moe_lb_loss": e * torch.sum(me * top1),
                "moe_z_loss": torch.mean(torch.logsumexp(logits, -1) ** 2)}

        return moe, orig, router

    def run(self, replay, fn):
        moe, orig, router = self._wrap(replay)
        moe._router = router
        try:
            return fn()
        finally:
            moe._router = orig


def _train_card_vs_cpu(tag, cpu, gpu, p_cpu, p_gpu, batch, routes=None):
    """The loss and every parameter's gradient of one batch on the card
    (kernels) and on the CPU (plain versions), one set of weights: the loss
    within 1e-4, each gradient within 1e-3 of its largest magnitude (f32
    with sums in other orders). ``routes`` (a _ForcedRoutes) records the
    card's expert choices and replays them on the CPU. Returns the worst
    gradient's max |err| over its largest magnitude."""
    import torch

    from repro_torch.tree import leaves, leaves_with_path, unflatten

    out = []
    for model, params, replay in ((gpu, p_gpu, False), (cpu, p_cpu, True)):
        ps = [p.detach().requires_grad_() for p in leaves(params)]
        tree = unflatten(params, ps)
        b = {k: v.to(model.device) for k, v in batch.items()}

        def step():
            loss, _ = model.loss(tree, b)
            return loss.detach(), torch.autograd.grad(loss, ps)

        t0 = time.perf_counter()
        out.append(routes.run(replay, step) if routes else step())
        if model.device.type == "cuda":
            torch.cuda.synchronize()
        log(f"[{tag} train] loss + grads on {model.device}: "
            f"{time.perf_counter() - t0:.1f}s")
    (lg, gg), (lc, gc) = out
    check_close(f"{tag} loss, card vs CPU", lg.cpu(), lc, atol=1e-4, rtol=0)
    worst, which = 0.0, ""
    for (key, _), a, b_ in zip(leaves_with_path(p_cpu), gg, gc):
        e = check_rel(f"{tag} grad {key}", a.cpu(), b_, 1e-3, quiet=True)
        r = e / max(float(b_.abs().max()), 1e-30)
        if r >= worst:
            worst, which = r, key
    log(f"[{tag} train] loss {float(lg):.6f} (card) vs {float(lc):.6f} "
        f"(CPU); {len(gg)} gradients each within 1e-3 of its largest "
        f"magnitude, the worst {worst:.3e} ({which})")
    return worst


def small_wide_bwd_checks(dev):
    """flash_bwd against flash_bwd_ref at d 112, 128, 256 and (192, 128),
    groups 8 and 1, ragged Sq != Skv, prefix_len 0, off the tile (37), a
    whole 64-row tile and past Sq, each with and without a window of 24,
    and rows that see no key: bf16 q, k, v, do as the projections' strided
    views on the tensor cores (dq within 2^-7 of its largest magnitude, dk
    and dv within 1e-3: the full-width limits), the same values in f32 on
    the CUDA cores (1e-4 of the largest: f32 with sums in another order)
    and, one case a shape, bf16 with do 2 bytes off alignment on the CUDA
    cores (the tensor-core limits); every launch's route counted. delta is
    rowsum(do o) plus noise, as for the d <= 128 cases. Then the gradient
    through flash_attention at each shape, with and without a prefix, on
    both routes against the plain backward on the kernel forward's o and
    lse; a planted check (a prefix gradient held against the causal-only
    plain backward must read above the limit); and the ring's refusal of
    d = 112 and 256 gradients before any launch. Returns max |err| of
    flash_bwd's dk and dv (f32) over the tensor-core cases."""
    import torch

    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_fwd,
                                                     flash_bwd, flash_bwd_ref,
                                                     flash_delta,
                                                     flash_delta_ref,
                                                     flash_fwd_ref,
                                                     ring_flash_attention)

    g = torch.Generator(device=dev).manual_seed(91)
    err, n, routes = 0.0, 0, {"wgmma": 0, "simt": 0}
    reset_launches()
    for d, dv in WIDE_DIMS:
        shapes = [(sq, skv, h, hk, prefix, window)
                  for sq, skv, h, hk in ((150, 150, 8, 1), (100, 230, 4, 4))
                  for prefix in (0, 37, 64, sq + 40)
                  for window in (None, 24)]
        shapes.append((90, 40, 8, 1, 0, None))       # rows 0-49 see no key
        for i, (sq, skv, h, hk, prefix, window) in enumerate(shapes):
            q, k, v, do = _wide_inputs(g, sq, skv, h, hk, d, dv)
            kw = dict(causal=True, window=window, prefix_len=prefix)
            tag = (f"flash_bwd d={d}/{dv} sq={sq} skv={skv} h={h}/{hk} "
                   f"prefix={prefix} window={window}")
            o, lse = flash_fwd_ref(q, k, v, **kw)
            delta = flash_delta(do, o) + torch.randn(
                (2, h, sq), generator=g, device=dev)
            dead = torch.isneginf(lse)
            runs = [("bf16 tc", (q, k, v, do), "wgmma")]
            runs.append(("f32 cuda-core", tuple(t.float() for t in
                                                (q, k, v, do)), "simt"))
            if i == 0:
                runs.append(("bf16 do unaligned, cuda-core",
                             (q, k, v, _unaligned(do)), "simt"))
            for what, args, path in runs:
                got = flash_bwd(*args, lse, delta, **kw)
                want = flash_bwd_ref(*args, lse, delta, **kw)
                rels = ((1e-4,) * 3 if what.startswith("f32")
                        else (2 ** -7, 1e-3, 1e-3))
                for name, a, b_, rel in zip(("dq", "dk", "dv"), got, want,
                                            rels):
                    e = check_rel(f"{tag} {what} {name}", a, b_, rel,
                                  quiet=True)
                    if path == "wgmma" and name != "dq":
                        err = max(err, e)
                if dead.any() and not (got[0][dead] == 0).all():
                    fail(f"{tag} {what}: rows that see no key must give "
                         "dq = 0")
                routes[path] += 1
                n += 1
    if dict(flash_bwd.routes) != routes:
        fail(f"small wide flash_bwd cases: routes {dict(flash_bwd.routes)}, "
             f"expected {routes}")
    log(f"[check] flash_bwd at d 112/128/256 and 192/128 (prefix 0, 37, a "
        f"tile, past Sq; window none and 24; groups 8 and 1; dead rows): "
        f"{n} cases within their limits, routes {routes}; dk/dv max|err| "
        f"{err:.3e} on the tensor cores")

    # gradients through flash_attention on both routes
    for d, dv in WIDE_DIMS:
        for prefix, window in ((0, None), (40, None), (24, 16)):
            q, k, v, go = _wide_inputs(g, 120, 120, 8, 1, d, dv)
            for dt, path in ((torch.bfloat16, "wgmma"),
                             (torch.float32, "simt")):
                qq, kk, vv = (t.detach().to(dt).requires_grad_()
                              for t in (q, k, v))
                gg = go.to(dt)
                kw = dict(causal=True, window=window, prefix_len=prefix)
                reset_launches()
                o = flash_attention(qq, kk, vv, **kw)
                got = torch.autograd.grad(o, (qq, kk, vv), gg)
                if (flash_bwd.routes[path] != 1 or flash_bwd.launches != 1
                        or flash_attention_fwd.routes[path] != 1):
                    fail(f"flash_attention grad d={d}/{dv} {dt}: routes "
                         f"fwd {dict(flash_attention_fwd.routes)} bwd "
                         f"{dict(flash_bwd.routes)}, expected {path}")
                with torch.no_grad():
                    o2, lse = flash_attention_fwd(qq, kk, vv, **kw)
                    want = flash_bwd_ref(qq, kk, vv, gg, lse,
                                         flash_delta_ref(gg, o2), **kw)
                rel = 2 ** -7 if dt == torch.bfloat16 else 1e-4
                for name, a, b_ in zip(("dq", "dk", "dv"), got, want):
                    check_rel(f"flash_attention grad d={d}/{dv} {dt} prefix="
                              f"{prefix} window={window} {name}", a,
                              b_.to(a.dtype), rel, quiet=True)
    log("[check] flash_attention gradients at d 112/128/256 and 192/128, "
        "prefix 0/40/24 (window 16), bf16 on the tensor cores (2^-7 of the "
        "largest) and f32 on the CUDA cores (1e-4): all within their limits")

    # planted: the prefix gradient against the causal-only plain backward
    q, k, v, do = _wide_inputs(g, 300, 300, 8, 1, 256, 256)
    o, lse = flash_fwd_ref(q, k, v, prefix_len=256)
    delta = flash_delta(do, o)
    got = flash_bwd(q, k, v, do, lse, delta, prefix_len=256)
    check_rel("flash_bwd d=256 prefix 256 dq", got[0], flash_bwd_ref(
        q, k, v, do, lse, delta, prefix_len=256)[0], 2 ** -7)
    causal = flash_bwd_ref(q, k, v, do, lse, delta)[0].float()
    planted = float((got[0].float() - causal).abs().max()
                    / causal.abs().max())
    if planted <= 2 ** -7:
        fail(f"flash_bwd prefix 256 against the causal-only plain backward: "
             f"{planted:.3e} of the largest |dq|, within the 2^-7 limit: the "
             "check cannot tell a prefix treated as causal")
    log(f"[check] planted: flash_bwd's dq with prefix 256 against the "
        f"causal-only plain backward reads {planted:.3e} of the largest "
        f"|dq|, above the 2^-7 = {2 ** -7:.3e} limit: a kernel that treated "
        "the prefix as causal fails the check")

    # the ring's CUDA-core step kernels take head dims up to 128 (64
    # backward): f32 refused up front (bf16 runs: phase 22's ring checks)
    for d in (112, 256):
        for dt in (torch.float32,):
            q = torch.randn((1, 4, 64, d), generator=g, device=dev).to(dt)
            k = torch.randn((1, 2, 64, d), generator=g, device=dev).to(dt)
            reset_launches()
            try:
                ring_flash_attention(q.requires_grad_(), k, k, ring_steps=2)
            except NotImplementedError as e:
                if f"head dim {d}" not in str(e):
                    fail(f"ring d={d} {dt}: refused with {e}")
            else:
                fail(f"ring d={d} {dt}: a gradient was not refused")
            if any(launch_counts().values()):
                fail(f"ring d={d} {dt}: a kernel launched before the refusal")
    log("[check] ring_flash_attention: f32 d = 112 and d = 256 gradients "
        "refused before any launch")
    torch.cuda.synchronize()
    return err


def _profile_wide_step(tag, model, params, opt_state, batch):
    """One eager train step of the phase 18 model under
    ``torch.profiler`` (the device work its compiled step replays): the
    device busy time and the top device rows, flash_bwd's two kernels
    among them. Returns busy ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.train import train_step
    from repro_torch.optim import AdamW

    opt = AdamW()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train_step(model, opt, params, opt_state, batch)
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3
    rows = device_rows(prof, 1)
    busy_ms = sum(r[0] for r in rows)
    log(f"[profile {tag}] eager train step under the profiler: host "
        f"{prof_ms:.3f} ms, device busy {busy_ms:.3f} ms")
    for ms, n, key in rows[:10]:
        log(f"[profile {tag}]   {ms:9.3f} ms  {n:5d} calls  {key[:90]}")
    for part in ("dq_tc_kernel", "dkv_tc_kernel"):
        ms = sum(r[0] for r in rows if part in r[2] and "ValueOffsets" in r[2])
        n = sum(r[1] for r in rows if part in r[2] and "ValueOffsets" in r[2])
        log(f"[profile {tag}] flash_bwd {part}: {ms:.4f} ms in {n} launches "
            f"({100 * ms / busy_ms:.1f}% of the busy time)")
    return busy_ms


def wide_train_main_path():
    """Phase 18: the three architectures the port serves but could not
    train, trained on the card in bf16 through ``TrainLoop`` (no
    checkpoints): the whole paligemma_3b (B = 4, 256 vision-stub prefix
    embeddings + 512 tokens, the prefix-LM mask), deepseek_v2_lite at 4 of
    its 27 layers (1 dense + 3 MoE, every width as published; B = 4 x 512)
    and zamba2_7b at 7 of its 81 layers (one group of 6 mamba2 layers with
    the shared block, a tail of 1; B = 2 x 512), WT_STEPS steps each,
    through the compiled step beside two eager runs
    (``train_three_ways``). Launch counts zeroed just before the compiled
    run and read just after, each exact: flash_fwd, flash_delta and
    flash_bwd once an attention layer a step, flash_fwd and flash_bwd on
    their tensor-core routes every time, flash_delta on its vector route;
    the CE head's forward and backward once a step; ssm_scan once a mamba2
    layer a step. Every loss and gradient norm finite. Prints the
    ``[train compiled]`` line, tokens/s, step ms, peak memory and one
    profiled eager step's split."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMData
    from repro_torch.launch import train as train_mod
    from repro_torch.models import LM

    out_counts = {}
    for arch, changes, batch, attn, mamba in WIDE_TRAIN:
        cfg = dataclasses.replace(get_config(arch), **changes)
        model = LM(cfg)

        def make_loop():
            return train_mod.TrainLoop(model=model, global_batch=batch,
                                       seq_len=WT_SEQ, steps=WT_STEPS,
                                       log_every=1)

        tag = f"{arch} {[(s_.kind, s_.n, s_.group) for s_ in model.program]}"
        out, counts, routes, stats = train_three_ways(tag, make_loop,
                                                      eager_first=1)
        hist, gnorms = out["history"], stats["compiled"]["gnorm"]
        if len(hist) != WT_STEPS:
            fail(f"{tag}: training ran {len(hist)} steps")
        want = {"flash_fwd": attn * WT_STEPS, "flash_delta": attn * WT_STEPS,
                "flash_bwd": attn * WT_STEPS, "lm_head_ce": WT_STEPS,
                "lm_head_bwd": WT_STEPS, "ssm_scan": mamba * WT_STEPS}
        got = {k: counts[k] for k in want}
        if got != want:
            fail(f"{tag}: launch counts {got}, expected {want}")
        check_tc_routes(f"{tag} training: flash_fwd", routes["flash_fwd"],
                        want["flash_fwd"])
        check_tc_routes(f"{tag} training: flash_bwd", routes["flash_bwd"],
                        want["flash_bwd"])
        check_tc_routes(f"{tag} training: CE forward", routes["lm_head_ce"],
                        WT_STEPS)
        check_tc_routes(f"{tag} training: CE backward",
                        routes["lm_head_bwd"], WT_STEPS)
        if routes["flash_delta"] != {"vec": want["flash_delta"],
                                     "scalar": 0}:
            fail(f"{tag} training: flash_delta routes "
                 f"{routes['flash_delta']}, all on the vector route wanted")
        ntok = batch * WT_SEQ
        step_ms = stats["compiled"]["ms"]
        steady = step_ms[2:]
        peak = max(p[0] for p in stats["compiled"]["peak"])
        log(f"[train {arch}] {model.param_count(out['params'])} parameters; "
            f"kernels " + ", ".join(f"{k}={v}" for k, v in counts.items()
                                   if v) + " (each as expected)")
        log(f"[train {arch}] losses {hist}; gradient norms {gnorms}")
        log(f"[train {arch}] {WT_STEPS} steps of {batch}x{WT_SEQ} tokens"
            + (f" + {cfg.num_prefix_embeddings} prefix embeddings"
               if cfg.frontend else "")
            + f" in {stats['wall_s']:.3f}s wall (init included), compiled; "
            f"step ms {[round(t_, 3) for t_ in step_ms]}; replays: "
            f"{ntok * len(steady) / (sum(steady) / 1e3):.1f} tokens/s; "
            f"peak device memory {peak:.2f} GB")
        bt = {"tokens": torch.from_numpy(SyntheticLMData(
            vocab_size=cfg.vocab_size, seq_len=WT_SEQ, global_batch=batch,
            seed=9).batch(0)).to(model.device)}
        if cfg.frontend:
            bt["prefix_embeddings"] = train_mod.prefix_embeddings(
                9, 0, batch, cfg).to(model.device)
        busy = _profile_wide_step(arch, model, out["params"], out["opt"], bt)
        log_train_compiled(arch, stats, ntok, busy)
        out_counts[arch] = counts
        del model, out, bt
        torch.cuda.empty_cache()
    return out_counts


def sdpa_bwd_ms(name, fn, readings=5):
    """SDPA's backward at a ``time_wide_bwd`` shape, by its device time:
    CUDA events around 10 calls queued behind a sleep (``event_ms``), so
    no host gap is timed. Its host path (autograd over a few kernels) is
    long beside its kernels: ``readings`` host-clock timings of 10
    back-to-back calls (``cuda_ms``, after 3 warm calls) are printed
    beside it: single host-clock readings of 5 calls have disagreed by
    2.3-3.9x at these shapes."""
    got = sorted(cuda_ms(fn, 10, 3) for _ in range(readings))
    dev = event_ms(fn, 10)
    log(f"[sdpa bwd] {name}: device {dev:.4f} ms (event_ms, kept); "
        f"back-to-back host-clock readings {[round(x, 4) for x in got]} ms")
    return dev


def time_wide_bwd(dev):
    """flash_bwd at the three phase 18 models' training shapes, bf16 q, k,
    v, do as the projections give them: the kernel (tensor-core route)
    against the plain version on the same inputs, dq within 2^-7 of its
    largest magnitude and dk, dv within 1e-3 of each row's largest; its time beside the
    bound (the larger of its bytes and 2.5 times the forward's operations
    over the visible pairs), the plain version's and autograd of SDPA's
    (the boolean causal-or-prefix mask for paligemma; E_v != E for MLA).
    Returns ({row: times}, max |err| of dk and dv)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (flash_attention_fwd,
                                                     flash_bwd, flash_bwd_ref,
                                                     flash_delta)

    g = torch.Generator(device=dev).manual_seed(93)
    times, err = {}, 0.0
    for name, b, s, h, hk, d, dv, prefix in WIDE_BWD_SHAPES:
        q, k, v, do = _wide_inputs(g, s, s, h, hk, d, dv)
        with torch.no_grad():
            o, lse = flash_attention_fwd(q, k, v, prefix_len=prefix)
        delta = flash_delta(do, o)
        got = flash_bwd(q, k, v, do, lse, delta, prefix_len=prefix)
        want = flash_bwd_ref(q, k, v, do, lse, delta, prefix_len=prefix)
        tag = f"{name} ({b},{h},{s},{d}/{dv}) prefix {prefix}"
        # dq by its largest magnitude: a row whose p sits on one key (a
        # causal row 0) cancels to ~0 in both, and a row's own scale would
        # measure only that cancellation; dk and dv by each row's
        check_rel(tag + " dq", got[0], want[0], 2 ** -7)
        for i, n_ in ((1, "dk"), (2, "dv")):
            err = max(err, check_rows(f"{tag} {n_}", got[i], want[i],
                                      1e-3)[0])
        del got, want
        qi = torch.arange(s, device=dev)
        mask = (qi[:, None] >= qi[None, :]) | (qi[None, :] < prefix)
        pairs = int(mask.sum())
        fwd_flops = 2 * b * h * pairs * (d + dv)
        qs, ks, vs = (t_.detach().contiguous().requires_grad_()
                      for t_ in (q, k, v))
        sdpa = F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask if prefix else None,
            is_causal=not prefix, enable_gqa=True)
        kernel = (lambda: flash_bwd(q, k, v, do, lse, delta,
                                    prefix_len=prefix))
        times[name] = dict(
            ms=_timed_routes(kernel, flash_bwd, "wgmma", 10),
            device_ms=event_ms(kernel, 10),
            flops=2.5 * fwd_flops,
            plain_ms=cuda_ms(lambda: flash_bwd_ref(q, k, v, do, lse, delta,
                                                   prefix_len=prefix), 3, 1),
            library_ms=sdpa_bwd_ms(name, lambda: torch.autograd.grad(
                sdpa, (qs, ks, vs), do, retain_graph=True)),
            library=("autograd of F.scaled_dot_product_attention("
                     + ("the boolean causal-or-prefix mask"
                        if prefix else "is_causal") + ", enable_gqa)"),
            shape=f"q ({b},{h},{s},{d}), k ({b},{hk},{s},{d}), v "
                  f"({b},{hk},{s},{dv}) bf16 views"
                  + (f", prefix {prefix}" if prefix else "") + ", causal")
        times[name].update(zip(("bound_ms", "bound_by"), bound(
            # q, do, k, v read in bf16, lse and delta in f32; dq written
            # in bf16, dk and dv in f32
            2 * (b * h + b * hk) * s * (d + dv) + 2 * b * h * s * 4
            + 2 * b * h * s * d + 4 * b * hk * s * (d + dv),
            2.5 * fwd_flops, "bfloat16")))
        del sdpa, qs, ks, vs
    torch.cuda.synchronize()
    return times, err


def _granite_held(plain, other):
    """``other``'s decode rows held against the untuned run's, row by row
    while a request's tokens agree: (each row's max |diff| over the row's
    largest |logit|, near ties where tokens part as (rid, pos, top-2 gap
    over the row's largest), rows over GRANITE_REL or tokens parting at
    more than a near tie)."""
    import torch

    rels, flips, bad, diverged = [], [], [], set()
    for key in sorted(plain):
        rid, pos = key
        if rid in diverged or key not in other:
            continue
        (a, ta), (b, tb) = plain[key], other[key]
        top = float(a.abs().max())
        rel = float((a - b).abs().max()) / top
        rels.append(rel)
        if rel > GRANITE_REL:
            bad.append((rid, pos, f"logits {rel:.3e} of the row's largest"))
        if int(ta) != int(tb):
            top2 = torch.topk(a, 2).values
            gap = float(top2[0] - top2[1]) / top
            if gap > GRANITE_REL:
                bad.append((rid, pos, f"token {int(tb)} != {int(ta)} with "
                                      f"the top-2 gap {gap:.3e} of the row's "
                                      "largest"))
            flips.append((rid, pos, round(gap, 5)))
            diverged.add(rid)
    return rels, flips, bad


def granite_main_path():
    """Phase 19: the whole granite_3_8b in bf16 (40 layers, d 4096, 32
    query heads of 128 over 8 kv heads, d_ff 12800, vocab 49155 padded to
    49408; seeded weights) on the engine (8 slots, max_len 2048, page 512)
    with phase 4's 16-request traffic. First untuned (``use_tuned=False``:
    the kernel's rule), recording each decode step's live lengths; then
    ``tune_cli --arch granite_3_8b`` at the engine's shape, its paged
    probe at the step whose live lengths sum to the median of the run's
    (twice: the second all cache hits); then on the adopted
    ``flash_decode_paged`` split, which the engine passes to its step and
    the paged kernel's launch arguments must show. Each decode row of a
    request whose tokens still agree is held against the untuned run's
    (GRANITE_REL of the row's largest |logit| over the first 49155
    columns: the padded ones hold -1e30); a token may differ only at a
    near tie. A control run, the merge of the winner's first range of
    slots dropped (those slots masked out of the positions the kernel
    reads), must fail that check. The untuned run is repeated after the
    tuned one (its tokens equal the first's), so speed is compared both
    ways round: tokens/s (admission prefills included) and the median
    host ms of a replayed decode step to its tokens. Then ``generate`` on
    8 prompts of 64 tokens through the same engine shape reports the
    adopted split in its stats."""
    import numpy as np
    import torch

    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.kernels.flash_attention.ops import paged_split
    from repro_torch.launch.serve import generate
    from repro_torch.layers import attention
    from repro_torch.serving import Engine

    model, params = _full_model("granite_3_8b", 61)
    cfg = model.cfg
    vocab = cfg.vocab_size
    reqs = traffic(0, 16, vocab)
    nsp = GRANITE_MAX_LEN // 512
    rule = paged_split(GRANITE_SLOTS, cfg.n_kv_heads, nsp, 512)[0]

    def run(tag, *, use_tuned, lens=None):
        eng = Engine(model, params, batch=GRANITE_SLOTS,
                     max_len=GRANITE_MAX_LEN, use_tuned=use_tuned)
        step, rows, step_ms = eng._step, {}, []

        def recording(p, c, t):
            live = {s: eng.sched.slots[s] for s in eng.sched.running}
            if lens is not None:        # the kv_len each slot's query sees
                lens.append([len(live[s].prompt) + len(live[s].tokens)
                             if s in live else 0
                             for s in range(GRANITE_SLOTS)])
            t0 = time.perf_counter()
            nxt, logits, c = step(p, c, t)
            torch.cuda.synchronize()      # the engine reads the tokens next
            step_ms.append((time.perf_counter() - t0) * 1e3)
            for s_, req in live.items():
                rows[(req.rid, len(req.tokens))] = (
                    logits[s_, :vocab].clone(), nxt[s_].clone())
            return nxt, logits, c

        eng._step = recording
        torch.cuda.synchronize()
        reset_launches()
        with _LaunchArgs("paged_decode") as rec:
            t0 = time.perf_counter()
            rids = [eng.submit(p, m) for p, m in reqs]
            res = eng.drain()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        counts = launch_counts()
        if step.captures != 1:
            fail(f"granite {tag}: the engine step captured {step.captures} "
                 "times")
        check_graph_kernels(f"granite {tag}: engine step", step.counts)
        splits = {a[13] for a in rec.args("paged_decode")}
        toks = [res[r] for r in rids]
        if [len(t) for t in toks] != [m for _, m in reqs] or not all(
                0 <= x < vocab for t in toks for x in t):
            fail(f"granite {tag}: tokens short or out of vocab")
        bad = sum(int((~torch.isfinite(r)).sum()) for r, _ in rows.values())
        if bad:
            fail(f"granite {tag}: {bad} non-finite logits")
        ntok = sum(len(t) for t in toks)
        replays = sorted(step_ms[2:])         # after the eager and capture
        med = replays[len(replays) // 2]
        log(f"[granite] {tag}: {eng.tuned.report()}; paged_decode "
            f"launched with split {sorted(splits)} (rule {rule}); {ntok} "
            f"tokens for {len(reqs)} requests in {wall:.3f}s = "
            f"{ntok / wall:.1f} tok/s (admission prefills included); "
            f"{len(step_ms)} decode steps, host ms a replayed step to its "
            f"tokens: median {med:.3f}, min {replays[0]:.3f}, max "
            f"{replays[-1]:.3f}; paged_decode {counts['paged_decode']}, "
            f"flash_fwd {counts['flash_fwd']}, lm_head {counts['lm_head']} "
            "launches")
        return dict(tuned=eng.tuned, rows=rows, toks=dict(zip(rids, toks)),
                    splits=splits, tok_s=ntok / wall, step_ms=med)

    lens = []
    plain = run("untuned", use_tuned=False, lens=lens)
    if plain["tuned"] or plain["splits"] != {rule}:
        fail(f"granite untuned: adopted {dict(plain['tuned'])}, "
             f"splits {plain['splits']}")
    live = sorted(x for step_lens in lens for x in step_lens if x)
    probe = sorted(lens, key=sum)[len(lens) // 2]
    log(f"[granite] the traffic's live lengths over {len(lens)} decode "
        f"steps ({len(live)} slot-steps): min {live[0]}, median "
        f"{live[len(live) // 2]}, max {live[-1]} of {GRANITE_MAX_LEN} slots; "
        f"live slots a step: min {min(sum(map(bool, x)) for x in lens)}, "
        f"max {max(sum(map(bool, x)) for x in lens)}; the probe step (its "
        f"sum the median of the steps'): {probe}")
    res = tune_twice(GRANITE_TUNE_ARGV + [
        "--paged-lens", ",".join(map(str, probe))], "--arch granite_3_8b")
    won = dict(res)["flash_decode_paged"]["split"]
    tuned = run("tuned", use_tuned=True)
    if (tuned["tuned"].get("flash_decode_paged") != {"split": won}
            or tuned["splits"] != {won}):
        fail(f"granite tuned: adopted {dict(tuned['tuned'])}, launched "
             f"{tuned['splits']}, winner {won}")
    # the untuned run again, after the tuned one (the first run of a
    # process pays cuBLAS's first calls at granite's shapes)
    again = run("untuned, again", use_tuned=False)
    if again["tuned"] or again["toks"] != plain["toks"]:
        fail("granite: the second untuned run differs from the first")
    del again["rows"]

    # the control: the merge of the winner's first range dropped
    real = attention.paged_decode_attention

    def dropped(q, kp, vp, *, pos_pages, **kw):
        return real(q, kp, vp, pos_pages=torch.where(pos_pages < won, -1,
                                                     pos_pages), **kw)

    attention.paged_decode_attention = dropped
    try:
        faulty = run(f"control, range 0 of {won} slots dropped",
                     use_tuned=True)
    finally:
        attention.paged_decode_attention = real
    c_rels, c_flips, c_bad = _granite_held(plain["rows"], faulty["rows"])
    c_sorted = sorted(c_rels)
    n_tok = sum(why.startswith("token") for _, _, why in c_bad)
    log(f"[granite] control (range 0 of {won} slots dropped) vs untuned: "
        f"{len(c_rels)} decode rows held, max |diff| / row max: min "
        f"{c_sorted[0]:.3e}, median {c_sorted[len(c_sorted) // 2]:.3e}, max "
        f"{c_sorted[-1]:.3e}; {len(c_bad) - n_tok} rows over the limit "
        f"{GRANITE_REL}, {n_tok} tokens parting at more than a near tie; "
        f"where tokens part (top-2 gap / row max): {c_flips}")
    if not c_bad:
        fail("granite: the check passed the control, a dropped range")
    del faulty

    # tuned against untuned
    rels, flips, bad = _granite_held(plain["rows"], tuned["rows"])
    if bad:
        fail(f"granite: tuned against untuned: {bad[:4]}")
    same = sum(plain["toks"][r] == tuned["toks"][r] for r in plain["toks"])
    log(f"[granite] tuned (split {won}) vs untuned (split {rule}): "
        f"{len(rels)} decode rows held, max |diff| / row max {max(rels):.3e}"
        f" (limit {GRANITE_REL}; the control's least {c_sorted[0]:.3e}); "
        f"{same} of {len(reqs)} requests' tokens equal; near ties where "
        f"they part (top-2 gap / row max): {flips}")
    log(f"[granite] untuned, tuned, untuned again: tokens/s "
        f"{plain['tok_s']:.1f}, {tuned['tok_s']:.1f}, {again['tok_s']:.1f};"
        f" median host ms a decode step {plain['step_ms']:.3f}, "
        f"{tuned['step_ms']:.3f}, {again['step_ms']:.3f}")
    del plain, tuned, again
    # generate adopts the tuned winners from the cache again

    prompts = np.random.RandomState(62).randint(1, vocab, (GRANITE_SLOTS, 64))
    out, stats = generate(model, params, prompts, gen_tokens=16,
                          max_len=GRANITE_MAX_LEN)
    if (stats["tuned"].get("flash_decode_paged") != {"split": won}
            or out.shape != (GRANITE_SLOTS, 16)):
        fail(f"granite generate: tuned {dict(stats['tuned'])}, tokens "
             f"{out.shape}")
    log(f"[granite] generate: {stats['tuned'].report()}; "
        f"{stats['tokens_per_s']:.1f} tok/s on 8 x 64-token prompts, 16 new")
    del model, params
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 22: the mesh: tensor and data parallelism on two ranks of the card
# ---------------------------------------------------------------------------

MESH_SLOTS, MESH_NEW = 8, 16                  # the engine on (1, 2)
MESH_TRAIN_LAYERS, MESH_TRAIN_STEPS = 2, 3    # the train step, f32
MESH_TRAIN_BATCH, MESH_TRAIN_SEQ = 2, 1024
MESH_LAYOUTS = (("(1,2)", (1, 2), {}),
                ("(2,1) zero1", (2, 1), dict(zero1=True)),
                ("(2,1) fsdp", (2, 1), dict(fsdp=True)))
# the sharded f32 train step against the one-rank step: the same function
# with sums in another order (the data ranks' gradients added, the model
# ranks' partial products added, an lse combined from two shards): the
# losses and gradient norms within 1e-5 relative, each parameter leaf's
# weighted sums (_mesh_digest) within 1e-5 of their magnitude. A step with
# a gradient off by a factor of 2 moves the sums by ~10% of it.
MESH_TRAIN_REL = 1e-5
MESH_TIMEOUT = 300
MESH_COUNTED = ("rmsnorm", "flash_fwd", "paged_decode", "lm_head")
MESH_TRAIN_COUNTED = ("rmsnorm", "flash_fwd", "flash_bwd", "flash_delta",
                      "lm_head_ce", "lm_head_bwd")


def _mesh_optimizer():
    """The phase's AdamW: eps 1e-6, where lr g / (|g| + eps) is continuous
    enough in g for rounding-sized gradients to move a parameter by at most
    ~lr 1e-3 (tests/test_torch_train_step.py)."""
    from repro_torch.optim import AdamW, WarmupCosine

    return AdamW(schedule=WarmupCosine(peak_lr=3e-3, warmup_steps=2,
                                       total_steps=MESH_TRAIN_STEPS),
                 eps=1e-6)


def _mesh_train_cfg():
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("llama3_2_1b"),
                               n_layers=MESH_TRAIN_LAYERS, dtype="float32")


def _mesh_batches(cfg):
    from repro_torch.data import SyntheticLMData

    data = SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=MESH_TRAIN_SEQ,
                           global_batch=MESH_TRAIN_BATCH, seed=22)
    return [data.batch(i) for i in range(MESH_TRAIN_STEPS)]


def _mesh_digest(params, placements=None):
    """Per leaf, three sums in f64 of its values x: sum x w, sum x^2 and
    sum |x| w, with w a product of one weight per dim, each a function of
    the element's GLOBAL index on that dim (so the sums see positions).
    Given ``placements`` the leaves are this rank's shards: each rank sums
    its shard and the sums are added over the axes the leaf is sharded on
    (every rank calls it)."""
    import torch

    from repro_torch.parallel import comm
    from repro_torch.parallel.rules import mesh_shape
    from repro_torch.tree import leaves

    ps = (leaves(placements) if placements is not None
          else [None] * len(leaves(params)))
    out = []
    for p, pl in zip(leaves(params), ps):
        x = p.detach().double()
        axes, offs = [], [0] * x.dim()
        if pl is not None:
            sizes = mesh_shape(pl.mesh)
            for dim, ax in pl._dims():
                k, i = pl._slot(ax)
                offs[dim] = i * x.shape[dim]
                axes += [a for a in ax if sizes[a] > 1]
        ws = [1.0 + 0.5 * torch.cos(0.7 * (torch.arange(
            n, device=x.device, dtype=torch.float64) + o) + d)
            for d, (n, o) in enumerate(zip(x.shape, offs))]
        sums = []
        for t in (x, x.abs()):
            for w in reversed(ws):
                t = t @ w
            sums.append(t)
        sums = torch.stack([sums[0], (x * x).sum(), sums[1]])
        for a in axes:
            sums = comm.all_reduce(sums, "sum", pl.mesh.get_group(a))
        out.append([float(v) for v in sums])
    return out


def _mesh_serve_rank(mesh, cfg):
    """This rank's engine run on the (1, 2) mesh: tokens, the first decode
    step's inputs and (gathered) logits, launch counts, the step's stats."""
    import torch

    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.models import LM
    from repro_torch.parallel import comm
    from repro_torch.serving import Engine

    t0 = time.perf_counter()
    model = LM(cfg)
    params = model.init(torch.Generator(device=model.device).manual_seed(0))
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    eng = Engine(model, params, batch=MESH_SLOTS, max_len=2048,
                 page_size=512, num_pages=MESH_SLOTS * 4 + 1, mesh=mesh)
    del params
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    step, first = eng._step, {}

    def recorded(p, c, t):
        nxt, logits, c = step(p, c, t)
        if not first:
            first["tokens"] = t.cpu().numpy().copy()
            first["next"] = nxt.cpu().numpy().copy()
            group = eng._rules.group("model")
            first["logits"] = comm.all_gather(logits, -1, group).cpu()
        return nxt, logits, c

    eng._step = recorded
    reqs = [(p, MESH_NEW) for p, _ in traffic(0, MESH_SLOTS,
                                              cfg.vocab_size)]
    torch.cuda.synchronize()
    reset_launches()
    comm.reset_elapsed()
    t0 = time.perf_counter()
    rids = [eng.submit(p, m) for p, m in reqs]
    res = eng.drain()
    torch.cuda.synchronize()
    drain_s = time.perf_counter() - t0
    counts = launch_counts()
    return dict(tokens=[res[r] for r in rids], first=first, counts=counts,
                step_stats=dict(step.stats), init_s=init_s, draw_s=draw_s,
                drain_s=drain_s,
                collective_s=comm.elapsed["seconds"],
                pool_heads=int(eng.cache["stacks"][0]["kp"].shape[2]))


def _mesh_train_rank(mesh, cfg, options, batches):
    """One layout's sharded train steps from the seeded init: losses,
    gradient norms, the final parameters' digest, launch counts, the
    step's stats."""
    import torch

    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.models import LM
    from repro_torch.parallel import (build_train_step, shard_batch,
                                      shard_tree)
    from repro_torch.tree import leaves, unflatten

    model = LM(cfg)
    dev = model.device
    opt = _mesh_optimizer()
    step, info = build_train_step(model, opt, mesh, **options)
    params = model.init(torch.Generator(device=dev).manual_seed(5))
    state = opt.init(params)
    params, state = shard_tree((params, state), (info["params"], info["opt"]))
    params = unflatten(params, [p.requires_grad_() for p in leaves(params)])
    torch.cuda.empty_cache()
    losses, norms = [], []
    torch.cuda.synchronize()
    reset_launches()
    for bt in batches:
        batch = shard_batch({"tokens": torch.from_numpy(bt).to(dev)},
                            info["rules"])
        params, state, loss, met = step(params, state, batch)
        losses.append(float(loss))
        norms.append(float(met["grad_norm"]))
    torch.cuda.synchronize()
    counts = launch_counts()
    digest = _mesh_digest(params, info["params"])
    return dict(losses=losses, norms=norms, digest=digest, counts=counts,
                step_stats=dict(step.stats))


def _mesh_rank(rank, world, rdv, out_dir, t_wall):
    """A rank of phase 22 (a spawned process on the card): joins the gloo
    group, serves on (1, 2), trains the three layouts, and pickles its
    results to ``<out_dir>/rank<r>.pkl`` (a traceback to ``.err``).
    ``t_wall``: the parent's ``time.time()`` at the spawn, against which
    the rank stamps its timeline."""
    import datetime
    import pickle
    import traceback

    marks = [("entered", time.time() - t_wall)]
    sys.path.insert(0, SRC)
    try:
        import torch
        import torch.distributed as dist

        from repro_torch.configs import get_config
        from repro_torch.launch.mesh import make_local_mesh

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.set_device(0)
        marks.append(("imported", time.time() - t_wall))
        dist.init_process_group("gloo", init_method=f"file://{rdv}",
                                rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=120))
        marks.append(("joined", time.time() - t_wall))
        t0 = time.perf_counter()
        out = {"serve": _mesh_serve_rank(
            make_local_mesh(data=1, model=2, device="cpu"),
            get_config("llama3_2_1b"))}
        out["serve_s"] = time.perf_counter() - t0
        marks.append(("served", time.time() - t_wall))
        torch.cuda.empty_cache()
        cfg = _mesh_train_cfg()
        batches = _mesh_batches(cfg)
        for tag, (data, model), options in MESH_LAYOUTS:
            t0 = time.perf_counter()
            out[tag] = _mesh_train_rank(
                make_local_mesh(data=data, model=model, device="cpu"), cfg,
                options, batches)
            out[tag]["seconds"] = time.perf_counter() - t0
            marks.append((tag, time.time() - t_wall))
            torch.cuda.empty_cache()
        out["marks"] = marks
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


class _MeshRanks:
    """A phase's running ranks: ``join()`` waits for them (killing them
    at the deadline) and returns their results."""

    def __init__(self, procs, tmp, deadline, tag="phase 22",
                 timeout=MESH_TIMEOUT):
        self.procs, self.tmp, self.deadline = procs, tmp, deadline
        self.tag, self.timeout = tag, timeout

    def _failed(self):
        errs = [open(os.path.join(self.tmp, f)).read()
                for f in sorted(os.listdir(self.tmp)) if f.endswith(".err")]
        if errs:
            self._kill()
            fail(f"{self.tag}: a rank failed:\n" + "\n".join(errs))

    def _kill(self):
        for p in self.procs:
            if p.is_alive():
                p.kill()
            p.join()
        shutil.rmtree(self.tmp, ignore_errors=True)

    def join(self):
        import pickle

        for p in self.procs:
            p.join(max(0.0, self.deadline - time.monotonic()))
        hung = [p for p in self.procs if p.is_alive()]
        try:
            self._failed()
            if hung:
                fail(f"{self.tag}: {len(hung)} of {len(self.procs)} ranks "
                     f"still running after {self.timeout} s")
            codes = [p.exitcode for p in self.procs]
            if any(codes):
                fail(f"{self.tag}: rank exit codes {codes}")
            out = []
            for r in range(len(self.procs)):
                with open(os.path.join(self.tmp, f"rank{r}.pkl"), "rb") as f:
                    out.append(pickle.load(f))
            return out
        finally:
            self._kill()


def _spawn_mesh_ranks(world=2, target=None, tag="phase 22",
                      timeout=MESH_TIMEOUT):
    """Start a phase's ranks (spawned, each on cuda:0, running ``target``,
    phase 22's :func:`_mesh_rank` by default): a :class:`_MeshRanks`."""
    import multiprocessing as mp

    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    ctx = mp.get_context("spawn")
    t_wall = time.time()
    procs = [ctx.Process(target=target or _mesh_rank,
                         args=(r, world, os.path.join(tmp, "rdv"), tmp,
                               t_wall))
             for r in range(world)]
    for p in procs:
        p.start()
    return _MeshRanks(procs, tmp, time.monotonic() + timeout, tag, timeout)


def _mesh_train_reference(cfg, batches):
    """The one-rank eager train step on the same init and global batches:
    losses, norms, digest, launch counts."""
    import torch

    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.models import LM
    from repro_torch.parallel.steps import train_step
    from repro_torch.tree import leaves, unflatten

    model = LM(cfg)
    dev = model.device
    opt = _mesh_optimizer()
    params = model.init(torch.Generator(device=dev).manual_seed(5))
    params = unflatten(params, [p.requires_grad_() for p in leaves(params)])
    state = opt.init(params)
    losses, norms = [], []
    torch.cuda.synchronize()
    reset_launches()
    for bt in batches:
        _, _, loss, met = train_step(model, opt, params, state, {
            "tokens": torch.from_numpy(bt).to(dev)})
        losses.append(float(loss))
        norms.append(float(met["grad_norm"]))
    torch.cuda.synchronize()
    counts = launch_counts()
    out = dict(losses=losses, norms=norms, digest=_mesh_digest(params),
               counts=counts)
    del params, state
    torch.cuda.empty_cache()
    return out


def _mesh_serve_reference(cfg, first_tokens):
    """The one-rank engine (eager steps) over the same requests, its first
    decode step fed the ranks' tokens (teacher forced): that step's logits
    and the run's launch counts."""
    import torch

    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.models import LM
    from repro_torch.serving import Engine

    model = LM(cfg)
    dev = model.device
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    eng = Engine(model, params, batch=MESH_SLOTS, max_len=2048,
                 page_size=512, num_pages=MESH_SLOTS * 4 + 1)
    first = {}

    def eager(p, c, t):
        if not first:
            t = torch.from_numpy(first_tokens).to(dev)
        nxt, logits, c = model.paged_greedy_step(p, t, c)
        if not first:
            first["logits"] = logits.float().cpu()
        return nxt, logits, c

    eng._step = eager
    reqs = [(p, MESH_NEW) for p, _ in traffic(0, MESH_SLOTS,
                                              cfg.vocab_size)]
    torch.cuda.synchronize()
    reset_launches()
    for p, m in reqs:
        eng.submit(p, m)
    eng.drain()
    torch.cuda.synchronize()
    counts = launch_counts()
    del eng, params
    torch.cuda.empty_cache()
    return first["logits"], counts


def _counts_equal(tag, got, want, names):
    bad = {k: (got[k], want[k]) for k in names if got[k] != want[k]}
    if bad:
        fail(f"phase 22 {tag}: launch counts (rank, one card) differ: {bad}")
    if any(got[k] <= 0 for k in names):
        fail(f"phase 22 {tag}: a kernel never launched: "
             f"{ {k: got[k] for k in names} }")


def _mesh_shard_kernels(dev, cfg):
    """Each kernel of the sharded path held against its plain version at
    the local shard shapes of a (1, 2) mesh, and timed: paged decode at 4
    kv heads (rows 6tp), the decode head on a 64128-column vocab shard with
    the two shards' argmaxes combined (9tp), the CE forward (10tp) and
    backward (11tp) on a shard whose labels lie partly outside it, in bf16
    (the tensor-core route; timed) and in f32 (the CUDA-core route the
    phase's f32 train step runs; held only). Returns {row: timing dict}."""
    import torch

    from repro_torch.kernels.lm_head import (lm_head_bwd, lm_head_bwd_ref,
                                             lm_head_ce, lm_head_ce_stats_ref,
                                             lm_head_logits,
                                             lm_head_logits_ref)

    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(22)
    out = {}
    local = dataclasses.replace(cfg, n_heads=cfg.n_heads // 2,
                                n_kv_heads=cfg.n_kv_heads // 2)
    lens = [len(p) + MESH_NEW for p, _ in traffic(0, MESH_SLOTS,
                                                  cfg.vocab_size)]
    out["paged_decode@tp"] = paged_times(dev, local, lens, 512,
                                         MESH_SLOTS * 4 + 1, gen)

    d, vs = cfg.d_model, 128256 // 2
    embed = (0.02 * torch.randn((2 * vs, d), generator=gen,
                                device=dev)).to(bf)
    x = torch.randn((MESH_SLOTS, d), generator=gen, device=dev).to(bf)
    shards = [embed[r * vs:(r + 1) * vs].T for r in range(2)]
    raw = [lm_head_logits.raw(x, w, vocab=vs) for w in shards]
    for r, (lg, m, arg) in enumerate(raw):
        rlg, rm, rarg = lm_head_logits_ref(x, shards[r], vocab=vs)
        check_close(f"lm_head bf16 shard {r} ({MESH_SLOTS},{d})x({d},{vs})",
                    lg, rlg, atol=4e-3, rtol=0)
        check_close(f"lm_head bf16 shard {r} row max", m, rm, atol=4e-3,
                    rtol=0)
    top = torch.maximum(raw[0][1], raw[1][1])
    big = torch.iinfo(torch.int64).max
    col = torch.minimum(
        torch.where(raw[0][1] == top, raw[0][2].long(), big),
        torch.where(raw[1][1] == top, raw[1][2].long() + vs, big))
    full, _, _ = lm_head_logits_ref(x, embed.T, vocab=2 * vs)
    check_argmax("lm_head bf16 two shards, argmaxes combined at offset "
                 f"{vs}", col, full, 2 * vs, gap_tol=8e-3)
    w = shards[1]
    hbytes = d * vs * 2 + MESH_SLOTS * d * 2 + MESH_SLOTS * vs * 4 + \
        MESH_SLOTS * 8

    def library_head():
        return torch.matmul(x, w).max(dim=-1)

    out["lm_head@tp"] = dict(
        ms=cuda_ms(lambda: lm_head_logits.raw(x, w, vocab=vs)),
        plain_ms=cuda_ms(lambda: lm_head_logits_ref(x, w, vocab=vs),
                         iters=10),
        library_ms=cuda_ms(library_head), bytes=hbytes,
        library="torch.matmul (bf16 out) + max/argmax",
        shape=f"x ({MESH_SLOTS},{d}) @ embed shard.T ({d},{vs}) bf16")
    out["lm_head@tp"].update(zip(("bound_ms", "bound_by"), bound(
        hbytes, 2 * MESH_SLOTS * d * vs, "bfloat16")))

    rows = MESH_TRAIN_BATCH * (MESH_TRAIN_SEQ - 1)
    labels = torch.randint(0, 2 * vs, (rows, 1), generator=gen,
                           device=dev).to(torch.int32)
    local_labels = (labels - vs).contiguous()      # shard 1: half outside
    outside = int(((local_labels < 0) | (local_labels >= vs)).sum())
    for dt in (bf, torch.float32):
        xc = torch.randn((rows, d), generator=gen, device=dev).to(dt)
        wc = shards[1].to(dt) if dt != bf else shards[1]
        lse, gold = lm_head_ce.raw(xc, wc, local_labels, vocab=vs)
        rlse, rgold = lm_head_ce_stats_ref(xc, wc, local_labels, vocab=vs)
        tag = f"lm_head_ce {str(dt)[6:]} shard ({rows},{d})x({d},{vs}), " \
              f"{outside} labels outside"
        check_close(f"{tag}: lse", lse, rlse, atol=1e-3, rtol=0)
        check_close(f"{tag}: gold", gold, rgold, atol=1e-3, rtol=0)
        if bool((gold[(local_labels < 0) | (local_labels >= vs)] != 0).any()):
            fail(f"{tag}: a label outside the shard gave a gold logit")
        g = torch.rand((rows, 1), generator=gen, device=dev) / rows
        glse = rlse + 0.5          # a global lse: the other shard's mass
        dx, dw = lm_head_bwd(xc, wc, local_labels, glse, g, vocab=vs)
        rdx, rdw = lm_head_bwd_ref(xc, wc, local_labels, glse, g, vocab=vs)
        check_rel(f"lm_head_bwd {str(dt)[6:]} shard: dx", dx, rdx, 1e-3)
        check_rel(f"lm_head_bwd {str(dt)[6:]} shard: dw", dw, rdw, 1e-3)
        if dt != bf:
            continue
        cbytes = rows * d * 2 + d * vs * 2 + rows * 4 + rows * 8

        out["lm_head_ce@tp"] = dict(
            ms=cuda_ms(lambda: lm_head_ce.raw(xc, wc, local_labels,
                                              vocab=vs), iters=10),
            plain_ms=cuda_ms(lambda: lm_head_ce_stats_ref(
                xc, wc, local_labels, vocab=vs), iters=3),
            library_ms=None, bytes=cbytes,
            library="none: F.cross_entropy has no label outside its columns "
                    "(a shard's gold is 0 there)",
            shape=f"x ({rows},{d}) @ shard ({d},{vs}) bf16, labels (int32) "
                  f"{outside} outside")
        out["lm_head_ce@tp"].update(zip(("bound_ms", "bound_by"), bound(
            cbytes, 2 * rows * d * vs, "bfloat16")))
        bbytes = rows * d * 2 + d * vs * 2 + rows * 12 + rows * d * 4 + \
            d * vs * 4

        out["lm_head_bwd@tp"] = dict(
            ms=cuda_ms(lambda: lm_head_bwd(xc, wc, local_labels, glse, g,
                                           vocab=vs), iters=5),
            plain_ms=cuda_ms(lambda: lm_head_bwd_ref(
                xc, wc, local_labels, glse, g, vocab=vs), iters=3),
            library_ms=None, bytes=bbytes, library="none (no one call)",
            shape=f"x ({rows},{d}), shard ({d},{vs}) bf16, global lse")
        out["lm_head_bwd@tp"].update(zip(("bound_ms", "bound_by"), bound(
            bbytes, 3 * 2 * rows * d * vs, "bfloat16")))
    torch.cuda.synchronize()
    return out


def _mesh_ring_wide_checks(dev):
    """The ring step kernels at the wide head dims (ring_flash_wide.cu, bf16
    on the tensor cores) against their plain versions: d = 112 (zamba2's
    shared block) and d = 256 with a prefix (paligemma), at ring offsets,
    at check_flash_tc's limits (o within 2^-6 of its row) and the backward
    test's (dq 2^-7, dk/dv 1e-3 of their largest)."""
    import torch

    from repro_torch.kernels.flash_attention import (flash_delta,
                                                     ring_bwd_ref,
                                                     ring_flash_bwd,
                                                     ring_flash_fwd,
                                                     ring_fwd_ref)

    gen = torch.Generator(device=dev).manual_seed(23)
    bf = torch.bfloat16
    for d, h, hk, kw in ((112, 32, 32, {}), (256, 8, 1,
                                             dict(prefix_len=256))):
        q = torch.randn((1, h, 512, d), generator=gen, device=dev).to(bf)
        k, v = (torch.randn((1, hk, 512, d), generator=gen,
                            device=dev).to(bf) for _ in range(2))
        do = torch.randn((1, h, 512, d), generator=gen, device=dev).to(bf)
        off = (torch.full((1, 1), 512, dtype=torch.int32, device=dev),
               torch.full((1, 1), 256, dtype=torch.int32, device=dev))
        before = dict(ring_flash_fwd.routes), dict(ring_flash_bwd.routes)
        o, lse = ring_flash_fwd(q, k, v, *off, **kw)
        ro, rlse = ring_fwd_ref(q, k, v, *off, **kw)
        check_rows(f"ring_flash_fwd d={d} bf16 at offsets (512, 256)", o, ro,
                   2 ** -6)
        delta = flash_delta(do, o)
        got = ring_flash_bwd(q, k, v, do, lse, delta, *off, **kw)
        want = ring_bwd_ref(q, k, v, do, lse, delta, *off, **kw)
        for name, a, b_, rel in zip(("dq", "dk", "dv"), got, want,
                                    (2 ** -7, 1e-3, 1e-3)):
            check_rel(f"ring_flash_bwd d={d} bf16 {name}", a, b_, rel)
        if (ring_flash_fwd.routes["wgmma"] != before[0]["wgmma"] + 1
                or ring_flash_bwd.routes["wgmma"] != before[1]["wgmma"] + 1):
            fail(f"ring d={d}: the step kernels did not take the tensor-core "
                 "route")
    torch.cuda.synchronize()


def mesh_phase(dev):
    """Phase 22: two ranks on the card over gloo (see the module
    docstring). Returns the shard-shape rows for log_times."""
    import torch

    from repro_torch.configs import get_config

    t_start = time.perf_counter()
    mode = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,compute_mode",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"[mesh] {mode}")
    cfg = get_config("llama3_2_1b")
    tcfg = _mesh_train_cfg()
    batches = _mesh_batches(tcfg)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    # the ranks (the kernels were built in phase 1: they load the
    # libraries); while they import (seconds before their first launch)
    # the one-rank train reference and the ring checks here; after them
    # the one-rank serve reference (it takes rank 0's first tokens) and
    # the kernels at shard shapes, timed with the card to themselves
    running = _spawn_mesh_ranks()
    marks = [("spawned", time.perf_counter() - t_start)]
    ref_train = _mesh_train_reference(tcfg, batches)
    marks.append(("train reference", time.perf_counter() - t_start))
    _mesh_ring_wide_checks(dev)
    marks.append(("ring checks", time.perf_counter() - t_start))
    ranks = running.join()
    t_ranks = time.perf_counter() - t_start
    first_tokens = ranks[0]["serve"]["first"]["tokens"]
    ref_logits, ref_counts = _mesh_serve_reference(cfg, first_tokens)
    marks.append(("serve reference", time.perf_counter() - t_start))
    times = _mesh_shard_kernels(dev, cfg)
    marks.append(("shard kernels", time.perf_counter() - t_start))

    # serving: identical tokens on both ranks; the first decode step's
    # logits against the one-rank engine's, teacher forced
    s0, s1 = ranks[0]["serve"], ranks[1]["serve"]
    if s0["tokens"] != s1["tokens"]:
        fail("phase 22: the two ranks emitted different tokens")
    if any(len(t) != MESH_NEW for t in s0["tokens"]):
        fail(f"phase 22: a request did not get its {MESH_NEW} tokens")
    if s0["pool_heads"] != cfg.n_kv_heads // 2:
        fail(f"phase 22: the pools hold {s0['pool_heads']} kv heads a rank")
    got = s0["first"]["logits"]
    if not torch.equal(got, s1["first"]["logits"]):
        fail("phase 22: the ranks' gathered logits differ")
    err = check_rel("phase 22: the first decode step's logits on (1, 2) "
                    "against one rank, teacher forced", got, ref_logits,
                    2 ** -4)
    check_argmax("phase 22: the sharded step's argmax (two shards' maxima "
                 "combined)", torch.from_numpy(s0["first"]["next"]),
                 ref_logits, cfg.vocab_size, gap_tol=2 * err)
    for r, rk in enumerate(ranks):
        _counts_equal(f"serving rank {r}", rk["serve"]["counts"],
                      ref_counts, MESH_COUNTED)
        if not rk["serve"]["step_stats"]["eager"]:
            fail("phase 22: the sharded serve step did not record its eager "
                 "run")
    log(f"[mesh] serving llama3_2_1b bf16 on (1, 2): {len(s0['tokens'])} "
        f"requests x {MESH_NEW} tokens, identical on both ranks; counts "
        + ", ".join(f"{k}={s0['counts'][k]}" for k in MESH_COUNTED)
        + " on each rank, as on one card")

    # training: each layout against the one-rank step
    for tag, _, _ in MESH_LAYOUTS:
        for r, rk in enumerate(ranks):
            t = rk[tag]
            for what in ("losses", "norms"):
                a, b_ = t[what], ref_train[what]
                worst = max(abs(x - y) / abs(y) for x, y in zip(a, b_))
                if worst > MESH_TRAIN_REL:
                    fail(f"phase 22 train {tag} rank {r}: {what} {a} vs one "
                         f"rank {b_} ({worst:.3e} relative)")
            worst = 0.0
            for (sw, sq, sa), (rw, rq, ra) in zip(t["digest"],
                                                  ref_train["digest"]):
                worst = max(worst, abs(sw - rw) / ra, abs(sq - rq) / rq)
            if worst > MESH_TRAIN_REL:
                fail(f"phase 22 train {tag} rank {r}: the parameters' "
                     f"weighted sums differ by {worst:.3e} of their size")
            _counts_equal(f"train {tag} rank {r}", t["counts"],
                          ref_train["counts"], MESH_TRAIN_COUNTED)
            if not t["step_stats"]["eager"]:
                fail("phase 22: the sharded train step did not record its "
                     "eager run")
        log(f"[mesh] train {tag}: losses {ranks[0][tag]['losses']} (one rank "
            f"{ref_train['losses']}), parameters within {worst:.3e}; counts "
            + ", ".join(f"{k}={ranks[0][tag]['counts'][k]}"
                        for k in MESH_TRAIN_COUNTED) + " on each rank")

    secs = time.perf_counter() - t_start

    def per_step(stats):
        n = max(len(stats["host_ms"]), 1)
        return (sum(stats["host_ms"]) / n, sum(stats["collective_ms"]) / n)

    parts = []
    for r, rk in enumerate(ranks):
        h, c = per_step(rk["serve"]["step_stats"])
        parts.append(f"rank {r} serve step {h:.3f} ms host, {c:.3f} ms in "
                     "collectives")
        for tag, _, _ in MESH_LAYOUTS:
            h, c = per_step(rk[tag]["step_stats"])
            parts.append(f"train {tag} {h:.3f} / {c:.3f} ms")
    sv = ranks[0]["serve"]
    log("[mesh time] timeline s: this process " + ", ".join(
        f"{k} {v:.1f}" for k, v in marks) + "; rank 0 from its spawn "
        + ", ".join(f"{k} {v:.1f}" for k, v in ranks[0]["marks"]))
    log(f"[mesh time] phase 22 {secs:.1f} s (the ranks' end at "
        f"{t_ranks:.1f} s: serve "
        f"{ranks[0]['serve_s']:.1f} s = init {sv['init_s']:.1f} (the "
        f"weights' draw {sv['draw_s']:.1f}) + engine "
        f"{sv['drain_s']:.1f}, of it {sv['collective_s']:.1f} in "
        f"collectives, {len(sv['step_stats']['host_ms'])} decode steps; "
        "train "
        + ", ".join(f"{tag} {ranks[0][tag]['seconds']:.1f} s"
                    for tag, _, _ in MESH_LAYOUTS)
        + "); " + "; ".join(parts)
        + " (gloo collectives of two processes on one host, CUDA tensors "
          "through host memory: a figure of gloo, not of NCCL)")
    return times


# ---------------------------------------------------------------------------
# phase 23: every kind on the mesh: tensor parallelism for MoE, MLA, MQA
# below the axis, frontends, mamba1, mamba2 and the hybrid, and the
# pipeline, on two ranks of the card
# ---------------------------------------------------------------------------

# 4 prompts cut to TP_PLEN tokens, TP_NEW new each (cut from 8 to keep the
# phase within its 45 s)
TP_PROMPTS, TP_PLEN, TP_NEW = 4, 32, 6
# (arch, config changes, seed): served on (1, 2) in bf16 at full width
TP_SERVE = (("deepseek_v2_lite", {}, 61),
            ("paligemma_3b", {}, 62),
            ("falcon_mamba_7b", dict(n_layers=8), 63),
            ("zamba2_7b", dict(n_layers=13), 64))
# (arch, config changes, batch, seq, seed): trained on (1, 2) in f32
TP_TRAIN = (("deepseek_v2_lite", dict(n_layers=2), 2, 512, 65),
            ("zamba2_7b", dict(n_layers=6), 2, 256, 66))
TP_TRAIN_STEPS = 3
# llama3_2_1b's dense blocks in f32: layers, stages, microbatches, seq
TP_PIPE = (4, 2, 4, 256)
TP_SERVE_COUNTED = ("rmsnorm", "flash_fwd", "flash_decode", "paged_decode",
                    "ssm_scan", "lm_head")
TP_TRAIN_COUNTED = ("rmsnorm", "flash_fwd", "flash_bwd", "flash_delta",
                    "lm_head_ce", "lm_head_bwd", "ssm_scan")
TP_TIMEOUT = 480
TP_DEVICE = "cuda"                           # the ranks' device
# the pipeline against the sequential run (the same kernels a microbatch;
# the gradients summed over the microbatches in another order)
TP_PIPE_REL = 1e-5


def _tp_cfg(arch, changes, dtype=None):
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(arch), **changes)
    return dataclasses.replace(cfg, dtype=dtype) if dtype else cfg


def _tp_prompts(vocab):
    import numpy as np

    return np.array([p[:TP_PLEN] for p, _ in traffic(23, TP_PROMPTS, vocab)],
                    np.int32)


def _tp_prefix(cfg, dev):
    import torch

    gen = torch.Generator(device=dev).manual_seed(67)
    return torch.randn((TP_PROMPTS, cfg.num_prefix_embeddings, cfg.d_model),
                       generator=gen, device=dev).to(torch.bfloat16)


def _tp_gathered(logits, rules):
    """The whole (B, Vpad) logits of a step whose greedy head returned this
    rank's vocab shard (one rank: as they are)."""
    from repro_torch.parallel import comm

    if rules is None:
        return logits.float().cpu()
    return comm.all_gather(logits, -1, rules.group("model")).float().cpu()


def _tp_whole(tree, specs, mesh):
    """A cache on the host in the one-rank layout: each leaf of ``tree``
    (laid out by the spec tree ``specs``; a leaf without a spec key, none)
    gathered whole over the mesh."""
    from repro_torch.parallel import Placement

    if isinstance(tree, dict):
        return {k: _tp_whole(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tp_whole(v, s, mesh) for v, s in zip(tree, specs)]
    return Placement(mesh, specs).gather(tree).cpu().clone()


class _TPRoutes:
    """Within: the MoE layers' routing decisions recorded (``record``, a
    list the top-k expert indices of each router call are appended to) or
    replayed (``replay``, such a list: each call takes the next one's
    experts, their gates recomputed from this rank's router as
    ``moe._router`` computes them). bf16 sums in another order move a
    router's probabilities by rounding, and where two experts nearly tie
    (at random init, from the 7th layer on here) a row takes another
    expert: the one-rank step replays the ranks' choices, so that the
    check holds the arithmetic and not the tie."""

    def __init__(self, record=None, replay=None):
        self.record, self.replay = record, replay

    def __enter__(self):
        import torch

        from repro_torch.layers import moe

        self.real = real = moe._router

        def routed(params, x, cfg):
            gate, idx, aux = real(params, x, cfg)
            if self.record is not None:
                self.record.append(idx.detach().cpu())
            if self.replay is not None:
                want = self.replay.pop(0).to(idx.device)
                self.forced += int((torch.sort(want, -1)[0] != torch.sort(
                    idx, -1)[0]).any(-1).sum())
                probs = torch.softmax(x.float() @ params["router"], dim=-1)
                gate = torch.gather(probs, -1, want)
                gate = gate / torch.clamp(gate.sum(-1, keepdim=True),
                                          min=1e-9)
                idx = want
            return gate, idx, aux

        self.forced = 0
        moe._router = routed
        return self

    def __exit__(self, *exc):
        from repro_torch.layers import moe

        moe._router = self.real


class _TPLayers:
    """Within: each decode block's input hidden state (``blocks``'
    ``tblock_decode``, ``tblock_paged_decode``, ``mamba_block_decode``)
    recorded (``record``: a list the inputs are appended to, on the host)
    or replayed (``replay``: such a list; each block takes the next one
    instead of its own input, and its output is appended to ``outs``):
    teacher forcing by layer, so that the one-rank step's blocks each see
    the ranks' input and their outputs differ by one block's arithmetic
    (bf16 rounding in another order compounds over a deep stack: deepseek's
    27 layers at random init move the last logits by ~0.4 otherwise)."""

    NAMES = ("tblock_decode", "tblock_paged_decode", "mamba_block_decode")

    def __init__(self, record=None, replay=None):
        self.record, self.replay, self.outs = record, replay, []

    def __enter__(self):
        from repro_torch.layers import blocks

        self.real = {n: getattr(blocks, n) for n in self.NAMES}

        def wrap(real):
            def block(params, x, cache, cfg, **kw):
                if self.record is not None:
                    self.record.append(x.detach().cpu().clone())
                if self.replay is not None:
                    x = self.replay.pop(0).to(x.device)
                y, cache = real(params, x, cache, cfg, **kw)
                if self.replay is not None:
                    self.outs.append(y.detach().float().cpu())
                return y, cache
            return block

        for n, real in self.real.items():
            setattr(blocks, n, wrap(real))
        return self

    def __exit__(self, *exc):
        from repro_torch.layers import blocks

        for n, real in self.real.items():
            setattr(blocks, n, real)


def _tp_recorder(step, rules, rec, snap=None):
    """``step`` (a serve step: (params, cache, tokens) -> (next, logits,
    cache)) recording its first call: the tokens it was fed, the cache it
    read (``snap(cache)``: on the host, in the one-rank layout), its MoE
    routing (:class:`_TPRoutes`), each block's input (:class:`_TPLayers`),
    its next tokens and its whole logits."""
    def recorded(p, c, t):
        if not rec:
            if snap is not None:
                rec["cache"] = snap(c)
            rec["tokens"] = t.cpu().clone()
            rec["routes"], rec["inputs"] = [], []
            with _TPRoutes(record=rec["routes"]), \
                    _TPLayers(record=rec["inputs"]):
                nxt, logits, c = step(p, c, t)
            rec.update(next=nxt.cpu().numpy().copy(),
                       logits=_tp_gathered(logits, rules))
            return nxt, logits, c
        return step(p, c, t)

    return recorded


def _tp_static(model, params, toks, *, mesh=None):
    """``generate(engine="static")`` on ``toks`` for TP_NEW tokens (with a
    mesh: ``mesh=``, ``params`` this rank's shards), its first decode step
    recorded (with a mesh, the cache it read too); launch counts over the
    run. Returns (tokens, first step, counts, the step's stats)."""
    import torch

    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.launch import serve as serve_mod
    from repro_torch.parallel import cache_pspecs

    rec, made = {}, {}
    real = serve_mod.build_serve_step
    b = toks.shape[0]
    max_len = toks.shape[1] + TP_NEW

    def build(m, *a, **kw):
        step, info = real(m, *a, **kw)
        made["step"] = step
        snap = None
        if mesh is not None:
            specs = cache_pspecs(m, mesh, b, max_len)
            snap = functools.partial(_tp_whole, specs=specs, mesh=mesh)
        return _tp_recorder(step, info.get("rules"), rec, snap), info

    serve_mod.build_serve_step = build
    try:
        torch.cuda.synchronize()
        reset_launches()
        if mesh is None:
            out, _ = serve_mod.generate(model, params, toks,
                                        gen_tokens=TP_NEW, engine="static")
        else:
            out, _ = serve_mod.generate(model, params, toks,
                                        gen_tokens=TP_NEW, engine="static",
                                        mesh=mesh, sharded=True)
        torch.cuda.synchronize()
        counts = launch_counts()
    finally:
        serve_mod.build_serve_step = real
    stats = getattr(made["step"], "stats", None)
    return out, rec, counts, (dict(stats) if stats else None)


def _tp_prefix_static(model, params, toks, prefix, *, mesh=None):
    """The static path after the vision prefix, by its steps: the prefill
    of prefix + prompt (``build_prefill_step`` on a mesh), its cache moved
    once into the decode layout (``reshard_cache``: paligemma's one kv head
    under 2 ranks splits the sequence), and TP_NEW greedy steps
    (``build_serve_step``), the first recorded. Returns (tokens, first
    step, counts, stats, cache, rules)."""
    import numpy as np
    import torch

    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.parallel import (build_prefill_step, build_serve_step,
                                      reshard_cache)

    b = toks.shape[0]
    max_len = prefix.shape[1] + toks.shape[1] + TP_NEW
    batch = {"tokens": torch.from_numpy(toks).to(model.device).long(),
             "prefix_embeddings": prefix}
    rec, out, snap = {}, [], None
    torch.cuda.synchronize()
    reset_launches()
    with torch.no_grad():
        if mesh is None:
            logits, cache = model.prefill(params, batch["tokens"],
                                          prefix_embeddings=prefix,
                                          max_len=max_len)
            rules = None

            def step(p, c, t):
                return model.greedy_step(p, t, c)
        else:
            prefill = build_prefill_step(model, mesh, batch=b,
                                         max_len=max_len)
            step, info = build_serve_step(model, mesh, batch=b,
                                          max_len=max_len)
            rules = info["rules"]
            logits, cache = prefill(params, batch)
            cache = reshard_cache(cache, prefill.shardings["cache"],
                                  info["cache_pspecs"], mesh)
            snap = functools.partial(_tp_whole, specs=info["cache_pspecs"],
                                     mesh=mesh)
        run = _tp_recorder(step, rules, rec, snap)
        tok = model.greedy_token(logits)
        for _ in range(TP_NEW):
            out.append(tok.cpu().numpy())
            tok, _, cache = run(params, cache, tok[:, None])
    torch.cuda.synchronize()
    counts = launch_counts()
    stats = getattr(step, "stats", None)
    return (np.stack(out, 1), rec, counts, dict(stats) if stats else None,
            cache, rules)


def _tp_engine(model, params, toks, *, mesh=None):
    """The engine on TP_PROMPTS requests of ``toks`` (TP_NEW tokens each,
    as many slots), its steps eager, the first recorded (with a mesh, the
    pools and tables it read too); counts over the drain. Returns (tokens,
    first step, counts, the step's stats, the pools' kv heads)."""
    import torch

    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.parallel import paged_cache_pspecs
    from repro_torch.serving import Engine

    eng = Engine(model, params, batch=TP_PROMPTS, max_len=TP_PLEN + TP_NEW,
                 mesh=mesh, sharded=mesh is not None)
    rec, snap = {}, None
    if mesh is None:
        def step(p, c, t):
            return model.paged_greedy_step(p, t, c)
        stats = None
    else:
        step = eng._step
        stats = step.stats
        snap = functools.partial(
            _tp_whole, specs=paged_cache_pspecs(model, mesh, TP_PROMPTS),
            mesh=mesh)
    eng._step = _tp_recorder(step, eng._rules, rec, snap)
    torch.cuda.synchronize()
    reset_launches()
    rids = [eng.submit(p.tolist(), TP_NEW) for p in toks]
    res = eng.drain()
    torch.cuda.synchronize()
    counts = launch_counts()
    heads = int(eng.cache["stacks"][0]["kp"].shape[2])
    return ([res[r] for r in rids], rec, counts,
            dict(stats) if stats else None, heads)


def _tp_train(model, batches, seed, *, mesh=None):
    """TP_TRAIN_STEPS f32 train steps from the seeded init: losses, norms,
    the parameters' digest, launch counts (and on a mesh the step's
    stats)."""
    import torch

    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.parallel import build_train_step, shard_batch
    from repro_torch.parallel.steps import train_step
    from repro_torch.tree import leaves, unflatten

    dev = model.device
    opt = _mesh_optimizer()
    gen = torch.Generator(device=dev).manual_seed(seed)
    if mesh is None:
        params, info, step = model.init(gen), None, None
    else:
        step, info = build_train_step(model, opt, mesh)
        params = model.init(gen, placements=info["params"])
    params = unflatten(params, [p.requires_grad_() for p in leaves(params)])
    state = opt.init(params)
    losses, norms = [], []
    torch.cuda.synchronize()
    reset_launches()
    for bt in batches:
        batch = {"tokens": torch.from_numpy(bt).to(dev)}
        if mesh is None:
            _, _, loss, met = train_step(model, opt, params, state, batch)
        else:
            params, state, loss, met = step(params, state,
                                            shard_batch(batch, info["rules"]))
        losses.append(float(loss))
        norms.append(float(met["grad_norm"]))
    torch.cuda.synchronize()
    out = dict(losses=losses, norms=norms, counts=launch_counts(),
               digest=_mesh_digest(params, info and info["params"]))
    if step is not None:
        out["step_stats"] = dict(step.stats)
    return out


def _tp_batches(cfg, b, s, seed):
    from repro_torch.data import SyntheticLMData

    data = SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=s,
                           global_batch=b, seed=seed)
    return [data.batch(i) for i in range(TP_TRAIN_STEPS)]


def _tp_pipeline(rank, dev):
    """llama3_2_1b's first TP_PIPE[0] dense blocks in f32 as TP_PIPE[1]
    stages over a ("pipe",) mesh of the two ranks (``pipeline_apply``), 4
    microbatches of 1 x 256 hidden states, the loss mean(y^2) and its
    gradients, against the sequential run of all the blocks on this rank
    (the same draws): the outputs and this rank's stage's gradients."""
    import torch

    from repro_torch.launch.mesh import make_pipe_mesh
    from repro_torch.layers import blocks
    from repro_torch.parallel.pipeline import pipeline_apply, split_stages

    nl, ns, nm, seq = TP_PIPE
    cfg = _tp_cfg("llama3_2_1b", dict(n_layers=nl), "float32")
    gen = torch.Generator(device=dev).manual_seed(68)
    stacked = blocks.tblock_init(gen, cfg, torch.float32, dev, n=nl)
    x = torch.randn((nm, 1, seq, cfg.d_model), generator=gen, device=dev)

    def stage_fn(p, h):
        for i in range(next(iter(_leaves(p))).shape[0]):
            h = blocks.tblock_forward(_index(p, i), h, cfg)[0]
        return h

    pipe = make_pipe_mesh(device="cpu")
    mine = _map(lambda t: t[rank:rank + 1].detach().clone().requires_grad_(),
                split_stages(stacked, ns))
    reset = _kernels_reset()
    y = pipeline_apply(stage_fn, mine, x, mesh=pipe)
    (y ** 2).mean().backward()
    torch.cuda.synchronize()
    counts = reset()
    full = _map(lambda t: t.detach().clone().requires_grad_(), stacked)
    ys = torch.stack([stage_fn(full, x[i]) for i in range(nm)])
    (ys ** 2).mean().backward()
    per = nl // ns
    want = _map(lambda t: t.grad[rank * per:(rank + 1) * per], full)
    got = _map(lambda t: t.grad[0], mine)
    return dict(y=y.detach().cpu(), y_seq=ys.detach().cpu(),
                grads=[(g.cpu(), w.cpu()) for g, w in
                       zip(_leaves(got), _leaves(want))],
                counts=counts)


def _leaves(tree):
    from repro_torch.tree import leaves

    return leaves(tree)


def _map(fn, tree):
    from repro_torch.tree import tree_map

    return tree_map(fn, tree)


def _index(tree, i):
    return _map(lambda t: t[i], tree)


def _kernels_reset():
    """Zero the launch counts; returns a function reading them."""
    from repro_torch.kernels import launch_counts, reset_launches

    reset_launches()
    return launch_counts


def _tp_merge_check(cache, rules, dev):
    """paligemma's merged decode attention on this rank's sequence shard of
    the static run's first layer cache, against one ``flash_decode`` over
    the whole cache (the shards gathered): with the query at the cache's
    end and at position 99, where the second shard holds no visible slot
    (lse -inf, weighed 0 by the merge). Returns the worst row ratio."""
    import torch

    from repro_torch.kernels.flash_attention import flash_decode
    from repro_torch.parallel import comm
    from repro_torch.parallel.context import merge_over_model, use_rules

    k, v = cache["stacks"][0]["k"][0], cache["stacks"][0]["v"][0]
    group = rules.group("model")
    whole_k, whole_v = (comm.all_gather(t, 2, group).contiguous()
                        for t in (k, v))
    m = k.shape[2]
    lo = rules.coordinate("model") * m
    gen = torch.Generator(device=dev).manual_seed(69)
    q = torch.randn((k.shape[0], 8, 1, k.shape[3]), generator=gen,
                    device=dev).to(k.dtype)
    slot_pos = torch.arange(lo, lo + m, dtype=torch.int32, device=dev)
    worst = 0.0
    for q_pos in (2 * m - 1, 99):
        kv_len = torch.full((1,), q_pos + 1, dtype=torch.int32, device=dev)
        o, lse = flash_decode(q, k, v, kv_len=kv_len, slot_pos=slot_pos,
                              return_lse=True)
        if lo > q_pos and not bool((lse == float("-inf")).all()):
            fail("phase 23: a shard past the query gave a finite lse")
        with use_rules(rules):
            merged = merge_over_model(o, lse)
        whole = flash_decode(q, whole_k, whole_v, kv_len=kv_len)
        _, r = check_rows(f"phase 23 rank {rules.coordinate('model')}: "
                          f"merged shards' flash_decode at q_pos {q_pos}",
                          merged, whole, 2 ** -6, quiet=True)
        worst = max(worst, r)
    return worst


def _tp_rank(rank, world, rdv, out_dir, t_wall):
    """A rank of phase 23 (a spawned process on the card): joins the gloo
    group, waits for the parent's "go" (its train references done), serves
    the four models on (1, 2) (each first decode step's input state kept
    on the host for the parent's one-rank step), trains the two, runs the
    pipeline, and pickles its results to ``<out_dir>/rank<r>.pkl`` (a
    traceback to ``.err``)."""
    import datetime
    import pickle
    import traceback

    marks = [("entered", time.time() - t_wall)]
    sys.path.insert(0, SRC)
    try:
        import torch
        import torch.distributed as dist

        from repro_torch.launch.mesh import make_local_mesh
        from repro_torch.models import LM
        from repro_torch.parallel import comm, make_shardings

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dev = torch.device(TP_DEVICE)
        if dev.type == "cuda":
            torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method=f"file://{rdv}",
                                rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=300))
        marks.append(("joined", time.time() - t_wall))
        # the parent's one-rank train references hold the card's memory
        # until it writes "go"
        go, deadline = os.path.join(out_dir, "go"), time.monotonic() + 300
        while not os.path.exists(go):
            if time.monotonic() > deadline:
                raise TimeoutError("phase 23: the parent never wrote go")
            time.sleep(0.05)
        marks.append(("go", time.time() - t_wall))
        mesh = make_local_mesh(data=1, model=2, device="cpu")
        out = {}
        for arch, changes, seed in TP_SERVE:
            t0 = time.perf_counter()
            torch.cuda.reset_peak_memory_stats()
            model = LM(_tp_cfg(arch, changes))
            placements = make_shardings(model, mesh)[0]
            params = model.init(torch.Generator(device=dev).manual_seed(seed),
                                placements=placements)
            torch.cuda.synchronize()
            r = {"draw_s": time.perf_counter() - t0}
            toks = _tp_prompts(model.cfg.vocab_size)
            comm.reset_elapsed()
            if arch == "paligemma_3b":
                (r["tokens"], r["first"], r["counts"], r["stats"],
                 r["heads"]) = _tp_engine(model, params, toks, mesh=mesh)
                e = {}
                (e["tokens"], e["first"], e["counts"], e["stats"], cache,
                 rules) = _tp_prefix_static(
                     model, params, toks, _tp_prefix(model.cfg, dev),
                     mesh=mesh)
                e["cache_k"] = tuple(cache["stacks"][0]["k"].shape)
                e["merge_ratio"] = _tp_merge_check(cache, rules, dev)
                out[arch + " prefix"] = e
                del cache
            else:
                r["tokens"], r["first"], r["counts"], r["stats"] = \
                    _tp_static(model, params, toks, mesh=mesh)
            r["peak_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
            r["seconds"] = time.perf_counter() - t0
            out[arch] = r
            del model, params, placements
            torch.cuda.empty_cache()
            marks.append((arch, time.time() - t_wall))
        for arch, changes, b, s, seed in TP_TRAIN:
            t0 = time.perf_counter()
            torch.cuda.reset_peak_memory_stats()
            model = LM(_tp_cfg(arch, changes, "float32"))
            out["train " + arch] = _tp_train(
                model, _tp_batches(model.cfg, b, s, seed), seed, mesh=mesh)
            out["train " + arch]["peak_gb"] = \
                torch.cuda.max_memory_allocated() / 2 ** 30
            out["train " + arch]["seconds"] = time.perf_counter() - t0
            del model
            torch.cuda.empty_cache()
            marks.append(("train " + arch, time.time() - t_wall))
        t0 = time.perf_counter()
        out["pipeline"] = _tp_pipeline(rank, dev)
        out["pipeline"]["seconds"] = time.perf_counter() - t0
        marks.append(("pipeline", time.time() - t_wall))
        out["marks"] = marks
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def _tp_train_references():
    """The one-rank f32 train steps (run while the ranks start; each model
    freed before the next). Returns {run: result}."""
    import torch

    from repro_torch.models import LM

    refs = {}
    for arch, changes, b, s, seed in TP_TRAIN:
        model = LM(_tp_cfg(arch, changes, "float32"))
        refs["train " + arch] = _tp_train(
            model, _tp_batches(model.cfg, b, s, seed), seed)
        del model
        torch.cuda.empty_cache()
    return refs


def _tp_forced_step(model, params, first, paged):
    """One rank's greedy step from the ranks' first decode step's input
    state: their tokens, the cache they read, whole, each block's input
    and their MoE routing (teacher forcing the state, each layer and the
    discrete choices: each block's output and the logits then differ by
    one block's arithmetic). Returns (the step's whole logits on the host,
    the routing decisions it took from the ranks where its own router
    chose otherwise, each block's output)."""
    import torch

    from repro_torch.tree import tree_map

    dev = model.device
    cache = tree_map(lambda t: t.to(dev), first["cache"])
    tokens = first["tokens"].to(dev)
    with torch.no_grad(), _TPRoutes(replay=list(first["routes"])) as routes, \
            _TPLayers(replay=list(first["inputs"])) as layers:
        step = model.paged_greedy_step if paged else model.greedy_step
        _, logits, _ = step(params, tokens, cache)
    return logits.float().cpu(), routes.forced, layers.outs


def _tp_serve_references(dev, ranks):
    """After the ranks: each served model once on one rank (its seeded
    weights), each model freed before the next, so deepseek's whole
    one-rank copy never sits beside the ranks: the same runs (their launch
    counts) and, from rank 0's recorded state, each run's first decode
    step (:func:`_tp_forced_step`). Returns {run: (counts, logits)}."""
    import torch

    from repro_torch.models import LM

    refs = {}
    for arch, changes, seed in TP_SERVE:
        model = LM(_tp_cfg(arch, changes))
        params = model.init(torch.Generator(device=dev).manual_seed(seed))
        toks = _tp_prompts(model.cfg.vocab_size)
        if arch == "paligemma_3b":
            counts = _tp_engine(model, params, toks)[2]
            refs[arch] = (counts, _tp_forced_step(
                model, params, ranks[0][arch]["first"], True))
            name = arch + " prefix"
            counts = _tp_prefix_static(model, params, toks,
                                       _tp_prefix(model.cfg, dev))[2]
            refs[name] = (counts, _tp_forced_step(
                model, params, ranks[0][name]["first"], False))
        else:
            counts = _tp_static(model, params, toks)[2]
            refs[arch] = (counts, _tp_forced_step(
                model, params, ranks[0][arch]["first"], False))
        del model, params
        torch.cuda.empty_cache()
    return refs


def _tp_serve_checks(name, ranks, ref, vocab):
    """Both ranks' tokens identical, every request complete, the first
    decode step's whole logits against one rank's step from the same state
    (2^-4 of the largest |logit|, and the argmax's gap rule), the counts
    equal to the one-rank run's."""
    import torch

    a, b = ranks[0][name], ranks[1][name]
    same = (a["tokens"] == b["tokens"] if isinstance(a["tokens"], list)
            else bool((a["tokens"] == b["tokens"]).all()))
    if not same:
        fail(f"phase 23 {name}: the two ranks emitted different tokens")
    for t in a["tokens"]:
        if len(t) != TP_NEW:
            fail(f"phase 23 {name}: a request got {len(t)} of {TP_NEW} "
                 "tokens")
    got, (want, forced, outs) = a["first"]["logits"], ref[1]
    # each block's output from the ranks' input against the ranks' next
    # block's input (the same limit as the logits)
    worst = 0.0
    for i, (o, nxt_in) in enumerate(zip(outs, a["first"]["inputs"][1:])):
        e = check_rel(f"phase 23 {name}: block {i}'s output from the ranks' "
                      "input", nxt_in, o, 2 ** -4, quiet=True)
        worst = max(worst, e / max(float(o.abs().max()), 1e-30))
    if not torch.equal(got, b["first"]["logits"]):
        fail(f"phase 23 {name}: the ranks' gathered logits differ")
    err = check_rel(f"phase 23 {name}: the first decode step's logits on "
                    "(1, 2) against one rank's step from the same state",
                    got[:, :vocab], want[:, :vocab], 2 ** -4)
    check_argmax(f"phase 23 {name}: the sharded step's argmax",
                 torch.from_numpy(a["first"]["next"]), want, vocab,
                 gap_tol=2 * err)
    log(f"[check] phase 23 {name}: {len(outs)} blocks, each from the "
        "ranks' input, within " f"{worst:.3e} of its largest |output| of "
        "the ranks' next input (limit 2^-4)")
    if a["first"]["routes"]:
        n = sum(r.numel() // r.shape[-1] for r in a["first"]["routes"])
        log(f"[check] phase 23 {name}: one rank's step replayed the ranks' "
            f"routing, choosing otherwise itself in {forced} of {n} "
            "(layer, token) decisions")
    for r, rk in enumerate(ranks):
        _tp_counts(f"{name} rank {r}", rk[name]["counts"], ref[0],
                   TP_SERVE_COUNTED)
    return {k: a["counts"][k] for k in TP_SERVE_COUNTED if a["counts"][k]}


def _tp_counts(tag, got, want, names, launched=()):
    """Each rank's launch counts of ``names`` equal the one-rank run's,
    and the kernels ``launched`` launched."""
    bad = {k: (got[k], want[k]) for k in names if got[k] != want[k]}
    if bad:
        fail(f"phase 23 {tag}: launch counts differ from one rank's: {bad}")
    if any(not got[k] for k in launched):
        fail(f"phase 23 {tag}: a kernel never launched: "
             f"{ {k: got[k] for k in launched} }")


def _tp_shard_kernels(dev):
    """The kernels at this phase's shard shapes, each against its plain
    version and timed beside its bound and library call: flash_decode with
    lse on paligemma's sequence shard (5sp; the shard past the query
    too), paged_decode at 4 query heads over one kv head, d 256 (6ptp),
    flash_fwd at deepseek's (192, 128) with 8 heads a rank (2mtp), and
    ssm_scan at falcon's d_inner shard (13tp) and zamba2's 56 heads
    (13ztp). Returns {row: timing dict}."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import decode_ref, flash_decode
    from repro_torch.kernels.ssm_scan import selective_scan_ref, ssm_scan_fwd

    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(70)
    out = {}

    # 5sp: the static path's decode over a rank's half of the slots
    pg = get_config("paligemma_3b")
    b, h, d = TP_PROMPTS, pg.n_heads, pg.resolved_head_dim
    m = (pg.num_prefix_embeddings + TP_PLEN + TP_NEW) // 2
    q = torch.randn((b, h, 1, d), generator=gen, device=dev).to(bf)
    k, v = (torch.randn((b, 1, m, d), generator=gen, device=dev).to(bf)
            for _ in range(2))
    for lo, q_pos in ((m, 2 * m - 1), (m, m - 3), (0, 2 * m - 1)):
        sp = torch.arange(lo, lo + m, dtype=torch.int32, device=dev)
        kv_len = torch.full((1,), q_pos + 1, dtype=torch.int32, device=dev)
        o, lse = flash_decode(q, k, v, kv_len=kv_len, slot_pos=sp,
                              return_lse=True)
        ro, rlse = decode_ref(q, k, v, kv_len=kv_len, slot_pos=sp,
                              return_lse=True)
        tag = f"flash_decode bf16 lse, shard [{lo}, {lo + m}), q_pos {q_pos}"
        check_close(tag + ": o", o, ro, atol=2e-2, rtol=2e-2)
        if lo > q_pos:
            if not (bool((o == 0).all()) and bool(
                    (lse == float("-inf")).all())):
                fail(f"{tag}: an empty shard gave o != 0 or a finite lse")
            log(f"[check] {tag}: every row o = 0, lse = -inf")
        else:
            check_close(tag + ": lse", lse, rlse, atol=1e-3, rtol=1e-4)
    sp = torch.arange(m, 2 * m, dtype=torch.int32, device=dev)
    kv_len = torch.full((1,), 2 * m, dtype=torch.int32, device=dev)
    dbytes = 2 * b * m * d * 2 + 2 * b * h * d * 2 + b * h * 4
    out["flash_decode@sp"] = dict(
        ms=cuda_ms(lambda: flash_decode(q, k, v, kv_len=kv_len, slot_pos=sp,
                                        return_lse=True)),
        plain_ms=cuda_ms(lambda: decode_ref(q, k, v, kv_len=kv_len,
                                            slot_pos=sp, return_lse=True),
                         iters=10),
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, enable_gqa=True)), bytes=dbytes,
        library="F.scaled_dot_product_attention on the shard (every slot "
                "visible; no lse)",
        shape=f"q ({b},{h},1,{d}), shard k/v ({b},1,{m},{d}) bf16, "
              "slot_pos the shard's positions, lse out")
    out["flash_decode@sp"].update(zip(("bound_ms", "bound_by"), bound(
        dbytes, 4 * b * h * m * d, "bfloat16")))

    # 6ptp: the engine's decode at 4 query heads over the replicated head
    local = dataclasses.replace(pg, n_heads=h // 2)
    page = fit_page(TP_PLEN + TP_NEW)
    lens = [TP_PLEN + TP_NEW] * TP_PROMPTS
    out["paged_decode@ptp"] = paged_times(
        dev, local, lens, page, TP_PROMPTS * -(-(TP_PLEN + TP_NEW) // page)
        + 1, gen, profile=False)

    # 2mtp: deepseek's prefill at 8 heads a rank
    s = TP_PLEN
    q, k, v = _mla_inputs(gen, b, s, 8, bf)
    check_flash_tc(f"flash_fwd bf16 at deepseek's prefill shard q "
                   f"{tuple(q.shape)}, v {tuple(v.shape)}", q, k, v,
                   causal=True)
    pairs = b * s * (s + 1) // 2
    out["flash_fwd@mtp"] = dict(
        **flash_times(q, k, v, iters=30, plain_iters=5, profile=False),
        flops=2 * 8 * (192 + 128) * pairs,
        shape=f"q/k ({b},8,{s},192), v ({b},8,{s},128) view bf16, causal")
    out["flash_fwd@mtp"].update(zip(("bound_ms", "bound_by"), bound(
        2 * b * 8 * s * (192 * 2 + 128 * 2) + 4 * b * 8 * s,
        2 * 8 * (192 + 128) * pairs, "bfloat16")))
    del q, k, v

    # 13tp / 13ztp: the prefill scans at the ranks' channel shards
    for row, dm, n, heads in (("ssm_scan@tp", 4096, 16, None),
                              ("ssm_scan@ztp", 3584, 64, 56)):
        x = torch.randn((b, s, dm), generator=gen, device=dev).to(bf)
        if heads:
            dt = F.softplus(torch.randn((b, s, heads), generator=gen,
                                        device=dev) - 4)
            delta = dt.repeat_interleave(dm // heads, dim=-1)
            a = -(1 + 15 * torch.rand((heads,), generator=gen, device=dev))
            A = a.repeat_interleave(dm // heads)[:, None].expand(
                dm, n).contiguous()
        else:
            delta = F.softplus(torch.randn((b, s, dm), generator=gen,
                                           device=dev) - 4)
            A = -torch.arange(1, n + 1, dtype=torch.float32,
                              device=dev).expand(dm, n).contiguous()
        B, C = (torch.randn((b, s, n), generator=gen, device=dev).to(bf)
                for _ in range(2))
        D = torch.ones(dm, device=dev)
        args = (x, delta, A, B, C, D)
        y, hT = ssm_scan_fwd(*args)
        ry, rhT = selective_scan_ref(*args)
        # the earlier phases' limits: y one bf16 rounding each side, hT
        # (f32) 1e-3 of its largest magnitude
        check_close(f"ssm_scan bf16 y at {row}'s shard x {tuple(x.shape)}, "
                    f"n {n}", y, ry, atol=1e-2, rtol=2 ** -7)
        check_rel(f"ssm_scan bf16 hT (f32) at {row}'s shard", hT, rhT, 1e-3)
        out[row] = dict(
            ms=cuda_ms(lambda: ssm_scan_fwd(*args), iters=10, warmup=2),
            plain_ms=cuda_ms(lambda: selective_scan_ref(*args), iters=2,
                             warmup=1),
            library_ms=None, library="none: no single PyTorch call "
                                     "computes it",
            shape=f"x ({b},{s},{dm}) bf16, delta f32, B/C ({b},{s},{n}) "
                  "bf16")
        out[row].update(zip(("bound_ms", "bound_by"),
                            scan_bound(b, s, dm, n, 2)))
    torch.cuda.synchronize()
    return out


def fit_page(max_len):
    from repro_torch.device import fit_block

    return fit_block(512, max_len)


def tp_phase(dev):
    """Phase 23: the one-rank train references while the two ranks start;
    then the ranks serve, train and pipeline (see the module docstring);
    then each served model once on one rank (its counts, and its first
    decode step from the ranks' state); the parent holds the results and
    times the kernels at the shard shapes. Returns the rows for
    log_times."""
    import torch

    t_start = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    running = _spawn_mesh_ranks(target=_tp_rank, tag="phase 23",
                                timeout=TP_TIMEOUT)
    marks = [("spawned", time.perf_counter() - t_start)]
    try:
        refs = _tp_train_references()
    except BaseException:
        running._kill()
        raise
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    open(os.path.join(running.tmp, "go"), "w").close()
    marks.append(("train references", time.perf_counter() - t_start))
    ranks = running.join()
    t_ranks = time.perf_counter() - t_start
    marks.append(("ranks", t_ranks))
    refs.update(_tp_serve_references(dev, ranks))
    marks.append(("serve references", time.perf_counter() - t_start))

    from repro_torch.configs import get_config

    lines = []
    for arch, changes, _ in TP_SERVE:
        vocab = get_config(arch).vocab_size
        names = ([arch, arch + " prefix"] if arch == "paligemma_3b"
                 else [arch])
        for name in names:
            counts = _tp_serve_checks(name, ranks, refs[name], vocab)
            lines.append(f"{name if name != 'paligemma_3b' else name + ' engine'}"
                         ": " + ", ".join(f"{k}={v}"
                                         for k, v in counts.items()))
    for r, rk in enumerate(ranks):
        if rk["paligemma_3b"]["heads"] != 1:
            fail("phase 23: paligemma's pools hold "
                 f"{rk['paligemma_3b']['heads']} kv heads on rank {r}")
        pre = rk["paligemma_3b prefix"]
        if pre["cache_k"][3] * 2 != (get_config("paligemma_3b")
                                     .num_prefix_embeddings
                                     + TP_PLEN + TP_NEW):
            fail(f"phase 23: paligemma's decode cache {pre['cache_k']} is "
                 "not a sequence shard")
    log("[tp] served on (1, 2), identical tokens on both ranks, each first "
        "decode step within 2^-4 of one rank's step from the same state, "
        "counts each rank's as one rank's: " + "; ".join(lines))
    log("[tp] paligemma's merged flash_decode over the two sequence shards "
        "against one call on the whole cache: worst err / row max "
        + ", ".join(f"{rk['paligemma_3b prefix']['merge_ratio']:.3e}"
                    for rk in ranks))

    for arch, _, _, _, _ in TP_TRAIN:
        name = "train " + arch
        want = refs[name]
        for r, rk in enumerate(ranks):
            t = rk[name]
            for what in ("losses", "norms"):
                worst = max(abs(x - y) / abs(y)
                            for x, y in zip(t[what], want[what]))
                if worst > MESH_TRAIN_REL:
                    fail(f"phase 23 {name} rank {r}: {what} {t[what]} vs "
                         f"one rank {want[what]} ({worst:.3e} relative)")
            worst = 0.0
            for (sw, sq, sa), (rw, rq, ra) in zip(t["digest"],
                                                  want["digest"]):
                worst = max(worst, abs(sw - rw) / ra, abs(sq - rq) / rq)
            if worst > MESH_TRAIN_REL:
                fail(f"phase 23 {name} rank {r}: the parameters' weighted "
                     f"sums differ by {worst:.3e} of their size")
            _tp_counts(f"{name} rank {r}", t["counts"], want["counts"],
                       TP_TRAIN_COUNTED, ("flash_bwd", "lm_head_bwd"))
        log(f"[tp] {name} f32 on (1, 2): losses {ranks[0][name]['losses']} "
            f"(one rank {want['losses']}), parameters within {worst:.3e}; "
            "counts " + ", ".join(f"{k}={ranks[0][name]['counts'][k]}"
                                  for k in TP_TRAIN_COUNTED
                                  if ranks[0][name]['counts'][k]))

    for r, rk in enumerate(ranks):
        p = rk["pipeline"]
        check_rel(f"phase 23 pipeline rank {r}: the outputs against the "
                  "sequential run", p["y"], p["y_seq"], TP_PIPE_REL)
        for i, (g, w) in enumerate(p["grads"]):
            check_rel(f"phase 23 pipeline rank {r}: stage gradient leaf {i}",
                      g, w, TP_PIPE_REL, quiet=True)
        _tp_counts(f"pipeline rank {r}", p["counts"], p["counts"], (),
                   ("flash_fwd", "flash_bwd"))
    log(f"[tp] pipeline: llama3_2_1b's {TP_PIPE[0]} blocks f32 in "
        f"{TP_PIPE[1]} stages, {TP_PIPE[2]} microbatches of 1 x "
        f"{TP_PIPE[3]}: outputs and each stage's "
        f"{len(ranks[0]['pipeline']['grads'])} gradient leaves within "
        f"{TP_PIPE_REL} of the sequential run; rank 0 counts flash_fwd="
        f"{ranks[0]['pipeline']['counts']['flash_fwd']}, flash_bwd="
        f"{ranks[0]['pipeline']['counts']['flash_bwd']}")

    times = _tp_shard_kernels(dev)
    marks.append(("shard kernels", time.perf_counter() - t_start))
    secs = time.perf_counter() - t_start
    parts = []
    for r, rk in enumerate(ranks):
        for name in [a for a, _, _ in TP_SERVE] + ["paligemma_3b prefix"]:
            st = rk[name]["stats"]
            n = max(len(st["host_ms"]), 1)
            parts.append(
                f"rank {r} {name}: step {sum(st['host_ms']) / n:.3f} ms "
                f"host, {sum(st['collective_ms']) / n:.3f} ms in "
                f"collectives, {sum(st['gathered_bytes']) / n:.0f} B "
                "gathered a step"
                + (f", peak {rk[name]['peak_gb']:.2f} GiB, draw "
                   f"{rk[name]['draw_s']:.1f} s" if "peak_gb" in rk[name]
                   else ""))
        for arch, _, _, _, _ in TP_TRAIN:
            t = rk["train " + arch]
            n = max(len(t["step_stats"]["host_ms"]), 1)
            parts.append(f"rank {r} train {arch}: step "
                         f"{sum(t['step_stats']['host_ms']) / n:.3f} ms "
                         f"host, {sum(t['step_stats']['collective_ms']) / n:.3f}"
                         f" ms in collectives, peak {t['peak_gb']:.2f} GiB")
    log("[tp time] timeline s: this process " + ", ".join(
        f"{k} {v:.1f}" for k, v in marks) + "; rank 0 from its spawn "
        + ", ".join(f"{k} {v:.1f}" for k, v in ranks[0]["marks"]))
    log(f"[tp time] phase 23 {secs:.1f} s; " + "; ".join(parts)
        + " (gloo collectives of two processes on one host, CUDA tensors "
          "through host memory: figures of gloo, not of NCCL)")
    return times


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
    for name in ("rmsnorm", "rmsnorm@train", "paged_decode",
                 "paged_decode@paligemma", "flash_decode",
                 "flash_decode@d256", "flash_decode@mixtral"):
        t = times[name]
        log(f"[gbps] {name}: {t['bytes'] / (t['ms'] * 1e-3) / 1e9:.1f} "
            f"GB/s of the function's {t['bytes'] / 1e9:.6f} GB in "
            f"{t['ms']:.4f} ms on the call's clock, "
            f"{t['bytes'] / (t['device_ms'] * 1e-3) / 1e9:.1f} GB/s in the "
            f"device time alone ({t['device_ms']:.4f} ms), "
            f"{100 * t['bound_ms'] / t['device_ms']:.1f}% of its bound")
    for name in ("paged_decode", "paged_decode@paligemma"):
        t = times[name]
        log(f"[paged] {name} split-KV: {t['split'][0]} slots a block, "
            f"{t['split'][1]} ranges a (sequence, kv head)")
    for name in ("flash_decode", "flash_decode@d256"):
        t = times[name]
        log(f"[decode] {name} split-KV: {t['split'][0]} slots a block, "
            f"{t['split'][1]} ranges a (sequence, kv head); kv_len as an "
            f"int32 device tensor {t['ms_dev_len']:.4f} ms on the call's "
            f"clock (as an int {t['ms']:.4f})")
    for name in ("ssm_scan", "ssm_scan@prefill", "ssm_scan@zamba",
                 "ssm_scan@zamba_prefill"):
        t = times[name]
        log(f"[scan] {name}: {t['exps'] / (t['device_ms'] * 1e-3) / 1e12:.3f}"
            f"e12 exponentials/s in the device time alone "
            f"({t['device_ms']:.4f} ms), {100 * t['bound_ms'] / t['device_ms']:.1f}%"
            f" of its bound ({t['bound_by']}; {EX2_PER_S / 1e12:.2f}e12 "
            f"MUFU.EX2/s at 16 a clock per SM, 1.98 GHz, 132 SMs)")
        if "head_bound_ms" in t:
            log(f"[scan] {name}: per-head bound (A constant along n: one "
                f"exponential a (t, c), two f32 FMAs a state and step at "
                f"{PEAK_FLOPS['float32'] / 1e12:.0f} TFLOP/s) "
                f"{t['head_bound_ms']:.4f} ms ({t['head_bound_by']}), "
                f"{100 * t['head_bound_ms'] / t['device_ms']:.1f}% of it in "
                f"the device time alone")
    for name in ("fd2d", "sem_apply", "dg_volume", "flash_delta"):
        t = times[name]
        log(f"[gbps] {name}: {t['bytes'] / (t['ms'] * 1e-3) / 1e9:.1f} "
            f"GB/s of the function's {t['bytes'] / 1e9:.6f} GB in "
            f"{t['ms']:.4f} ms on the call's clock, "
            f"{t['bytes'] / (t['device_ms'] * 1e-3) / 1e9:.1f} GB/s in the "
            f"device time alone ({t['device_ms']:.4f} ms), "
            f"{100 * t['bound_ms'] / t['device_ms']:.1f}% of its bound")
    u = times["dg_volume"]["host_us"]
    log(f"[host] dg_volume {times['dg_volume']['shape']}: one call "
        f"{u['whole']:.2f} us on the host = checks and route "
        f"{u['checks']:.2f} + torch.empty {u['empty']:.2f} + stream handle "
        f"{u['stream']:.2f} + the ctypes call {u['ctypes']:.2f} + the launch "
        f"{u['ctypes_launch'] - u['ctypes']:.2f} + the rest "
        f"{u['whole'] - u['checks'] - u['empty'] - u['stream'] - u['ctypes_launch']:.2f}"
        f"; the kernel's device time {1e3 * times['dg_volume']['device_ms']:.2f} us")
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
                 "flash_fwd@train", "flash_fwd@mla", "flash_fwd@mixtral",
                 "flash_fwd@zamba", "flash_fwd@paligemma", "flash_bwd",
                 "flash_bwd@paligemma", "flash_bwd@mla", "flash_bwd@zamba",
                 "ring_flash_fwd",
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
    # the modules this process compiles are cached under a directory of
    # its own, where phase 22's spawned ranks find them (where the
    # environment asks for no bytecode, every process compiles torch from
    # its sources: ~10 s a rank)
    pyc = tempfile.mkdtemp(prefix="chip_smoke_pyc_")
    sys.pycache_prefix = pyc
    sys.dont_write_bytecode = False
    os.environ["PYTHONPYCACHEPREFIX"] = pyc
    try:
        return _main()
    finally:
        shutil.rmtree(pyc, ignore_errors=True)


def _main():
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
    keep_graphs()
    # autotune winners of this run only: every phase before 9a runs on the
    # ops' rules and defaults
    cache_dir = tempfile.mkdtemp(prefix="chip_smoke_tune_")
    os.environ["REPRO_CACHE_DIR"] = cache_dir
    try:
        return run_phases()
    finally:
        shutil.rmtree(cache_dir, ignore_errors=True)


def run_phases():
    """Phases 1-21 and the last three lines (see the module docstring)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMData
    from repro_torch.kernels import _build
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
    log(f"[build] {len(logs)} CUDA sources compiled in "
        f"{time.perf_counter() - t0:.1f}s")
    log("[build] each source's nvcc, seconds from the start: " + ", ".join(
        f"{n} {t:.1f}" for n, t in sorted(_build.BUILD_SECONDS.items(),
                                          key=lambda x: -x[1])))

    def elapsed(what):
        log(f"[elapsed] {what}: {time.perf_counter() - t_start:.1f}s")
    tc_sass_check()

    # 2a. kernels vs plain, f32 small shapes
    small_f32_checks(dev)
    small_f32_train_checks(dev)
    small_f32_app_checks(dev)
    small_f32_static_checks(dev)
    small_decode_scan_checks(dev)
    small_f32_ring_checks(dev)
    small_tc_checks(dev)
    mla_err = small_mla_moe_attn_checks(dev)
    mla_decode_bf16_check(dev)
    zscan_err, zflash_err = small_zamba_kernel_checks(dev)
    pflash_err, ppaged_err = small_paligemma_kernel_checks(dev)
    small_compiled_step_checks(dev)
    wbwd_err = small_wide_bwd_checks(dev)
    elapsed("phase 2a")

    cfg = get_config("llama3_2_1b")
    page, num_pages, slots = 512, 8 * 4 + 1, 8
    reqs = traffic(0, 16, cfg.vocab_size)
    sq = max(len(p) for p, _ in reqs)               # longest admission
    lens = [len(p) + 16 for p, _ in reqs[:slots]]   # a decode step's kv

    # 3. 2-layer f32: card vs CPU, serving and training
    two_layer_f32_check(cfg)
    two_layer_f32_train_check(cfg)
    two_layer_static_f32_checks()
    two_layer_moe_f32_checks()
    two_layer_zamba_f32_checks()
    two_layer_paligemma_f32_checks()
    elapsed("phase 3")

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
    elapsed("phase 4-5")

    # 2b. kernels vs plain at the main path's full-width shapes, bf16
    errs = full_width_bf16_checks(dev, cfg, params, sq, lens, page,
                                  num_pages)

    times = time_kernels(dev, cfg, params, sq, lens, page, num_pages)
    del model, params
    elapsed("phase 2b, 8 serving")

    # 6. the training path: full llama3_2_1b in bf16 through TrainLoop
    model, tcounts, tstats, out = train_main_path(cfg)
    log("training kernels: " + ", ".join(
        f"{k}={tcounts[k]}" for k in TRAIN_KERNELS + ("rmsnorm", "flash_fwd")))
    log(f"[train] loss history {tstats['history']}")
    log(f"[train] {TRAIN_STEPS} steps of {TRAIN_BATCH}x{TRAIN_SEQ} tokens in "
        f"{tstats['wall_s']:.3f}s wall (init included, no checkpoints), "
        f"compiled; step ms {[round(t, 3) for t in tstats['step_ms']]}; "
        f"replays: {tstats['tok_s']:.1f} tokens/s; peak device memory "
        f"{tstats['peak_gb']:.2f} GB")
    counts.update({k: tcounts[k] for k in TRAIN_KERNELS})

    # 7. where a train step's time goes: the eager step's profile, the
    # compiled step against it, remat's peaks
    _, busy_ms = profile_train_step(model, out["params"], out["opt"])
    log_train_compiled(cfg.name, tstats, TRAIN_BATCH * TRAIN_SEQ, busy_ms)
    remat_steps(cfg, out["params"], out["opt"], {"tokens": torch.from_numpy(
        SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                        global_batch=TRAIN_BATCH, seed=9).batch(0)).to(dev)})
    embed = out["params"]["embed"].detach()
    del out

    # 2b (training kernels) and 8. times
    errs.update(full_width_train_checks(dev, cfg, embed))
    errs["flash_fwd"] = max(errs["flash_fwd"], errs.pop("flash_fwd@train"))
    times.update(time_train_kernels(dev, cfg, embed))
    del model, embed
    torch.cuda.empty_cache()
    log(f"[train] checkpoints of a 2-layer model (3 steps, saved at 2 and "
        f"3): the latest restored bit-equal in "
        f"{checkpoint_round_trip(cfg):.1f}s")
    two_layer_train_options(cfg)
    elapsed("phase 6-8 training")

    # 9a. tune_cli --apps at the apps path's shapes, twice (the second all
    # cache hits); 9. the apps path: FD, SEM and DG at full size through
    # their entry points, on the winners, then again on the defaults
    app_tuned = {}
    for name, r in tune_twice(APPS_TUNE_ARGV, "--apps"):
        where = (r["h"], r["w"]) if name == "fd2d" else r["E"]
        app_tuned[(name, where)] = {k: r[k] for k in (
            ("bh", "bw") if name == "fd2d" else ("eb",))}
    acounts, astate = apps_main_path(dev, app_tuned)
    log("app kernels: " + ", ".join(f"{k}={acounts[k]}" for k in APP_KERNELS))
    counts.update({k: acounts[k] for k in APP_KERNELS})

    # 10. where an LSERK step's time goes; 2b and 8 for the app kernels
    swe = astate["swe"]
    profile_swe_step(swe["solver"], swe["Q"], swe["dt"])
    sem_global_breakdown(astate["op"], astate["u_glob"])
    errs.update(full_size_app_checks(astate))
    times.update(time_app_kernels(astate))
    del astate, swe
    elapsed("phase 9-10 apps")

    # 20. the kernel language and the host API: the six bound specs on
    # the cuda backend against their torch expansion and plain versions
    language_phase(dev)
    elapsed("phase 20 language")

    # 21. the ops over their builders: bit-equal to the wrappers, the
    # eleven new specs against their torch expansion, lint_kernels
    spec_costs = lang_ops_phase(dev)
    elapsed("phase 21 ops over builders")

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
    elapsed("phase 11-12 static")

    # 13. the ring (local and replayed rank by rank) and matmul; 2b and 8
    # for their kernels
    rcounts, errs["matmul"] = ring_main_path(dev)
    counts.update({k: rcounts[k] for k in RING_KERNELS})
    ring_errs, pairs = ring_kernel_checks(dev)
    errs.update(ring_errs)
    torch.cuda.empty_cache()
    times.update(time_ring_kernels(dev, pairs))
    del pairs
    elapsed("phase 13 ring")

    # 14. deepseek_v2_lite whole and 15. mixtral_8x22b at 4 layers through
    # generate (the static path); 2b and 8 for their attention shapes
    for arch, changes in (("deepseek_v2_lite", {}),
                          ("mixtral_8x22b", dict(n_layers=MIXTRAL_LAYERS))):
        moe_main_path(arch, 51, **changes)
    moe_times, moe_errs = time_moe_mla_kernels(dev)
    times.update(moe_times)
    errs["flash_fwd"] = max(errs["flash_fwd"], mla_err,
                            moe_errs["flash_fwd@mla"],
                            moe_errs["flash_fwd@mixtral"])
    errs["flash_decode"] = max(errs["flash_decode"],
                               moe_errs["flash_decode@mixtral"])
    elapsed("phase 14-15 moe")

    # 16. zamba2_7b at 45 layers through generate (the static path); 2b and 8 for
    # its scan and attention shapes
    zcounts, _ = zamba_main_path()
    log("zamba2_7b kernels: " + ", ".join(
        f"{k}={zcounts[k]}" for k in ("ssm_scan", "flash_fwd",
                                      "flash_decode", "rmsnorm", "lm_head")))
    z_times, z_err = time_zamba_kernels(dev)
    times.update(z_times)
    errs["flash_fwd"] = max(errs["flash_fwd"], zflash_err, z_err)
    errs["ssm_scan"] = max(errs["ssm_scan"], zscan_err)
    elapsed("phase 16 zamba2")

    # 17. paligemma_3b whole on the engine, the static path and a
    # vision-stub prefix prefill; 2b and 8 for its attention shapes
    paligemma_main_path()
    p_times, p_flash, p_paged = time_paligemma_kernels(dev, lens)
    times.update(p_times)
    errs["flash_fwd"] = max(errs["flash_fwd"], pflash_err, p_flash)
    errs["paged_decode"] = max(errs["paged_decode"], ppaged_err, p_paged)
    elapsed("phase 17 paligemma")

    # 18. paligemma_3b whole, deepseek_v2_lite and zamba2_7b at reduced
    # depth trained through TrainLoop; 2b and 8 for flash_bwd at their
    # shapes
    wcounts = wide_train_main_path()
    w_times, w_err = time_wide_bwd(dev)
    times.update(w_times)
    errs["flash_bwd"] = max(errs["flash_bwd"], wbwd_err, w_err)
    log("[train] phase 18 flash_bwd launches (printed, not summed in): "
        + ", ".join(f"{a} {c['flash_bwd']}" for a, c in wcounts.items()))
    elapsed("phase 18 wide training")

    # 19. granite_3_8b whole on the engine, untuned and on its tuned split
    granite_main_path()
    elapsed("phase 19 granite")

    # 22. the mesh: llama3_2_1b served on (1, 2) and trained on three
    # layouts by two ranks on the card over gloo; the kernels at shard
    # shapes; the ring's wide head dims
    times.update(mesh_phase(dev))
    elapsed("phase 22 mesh")

    # 23. every kind on the mesh: deepseek_v2_lite and paligemma_3b whole,
    # falcon_mamba_7b and zamba2_7b cut, served by two ranks on (1, 2);
    # deepseek and zamba2 trained; the pipeline; the kernels at the shard
    # shapes
    times.update(tp_phase(dev))
    elapsed("phase 23 every kind on the mesh")
    log_times(times)
    log_spec_costs(spec_costs, times)
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
