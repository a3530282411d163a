"""Fault-tolerant training on one device or a mesh (the counterpart of
``repro.launch.train``).

Integrates: the train step of ``parallel.build_train_step`` (``LM.loss``
-> ``torch.autograd.grad`` -> ``AdamW.update``; one CUDA graph a step on
the card after the first, :func:`train_step` eagerly on the CPU),
deterministic synthetic data with prefetch (and, for a model with a
frontend stub, its prefix embeddings, drawn for each data step as the JAX
loop draws them), async atomic checkpointing + resume, the straggler
watchdog, and failure injection with automatic restore-retry. The model's
``remat`` option (``--remat``) rematerialises its layers; gradient
accumulation is ``build_train_step``'s ``accum_steps`` (the loop, as
JAX's, steps whole batches). The loop looks up the persisted tune
winners of its shapes before its step is built (:func:`apply_tuned_winners`;
``launch.tuning.adopt``, kind "train") and returns them as ``"tuned"``; no
op of the train step takes a launch-time knob on Hopper yet (their tiles
are template constants), so none reaches the step.

On a mesh (``TrainLoop(mesh=, zero1=, fsdp=)``) every rank runs the loop:
the state is its shards (``build_train_step(mesh)``'s placements), it
feeds its rows of each global batch, and checkpoints hold the full arrays
(gathered on save, sliced to the restoring mesh on restore). ``main``
starts the process group itself when ``torchrun`` gives it several ranks:
NCCL when every rank has a card of its own, gloo otherwise (the choice is
its first line of output; it never switches on an error).

  PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu \\
      --steps 3 [--remat dots]
  torchrun --nproc-per-node 2 -m repro_torch.launch.train --reduced \\
      --device cpu --model-axis 2 --steps 3
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, reduced as reduce_cfg
from repro_torch.data import Prefetcher, SyntheticLMData
from repro_torch.device import resolve_device
from repro_torch.launch import tuning
from repro_torch.models import LM
from repro_torch.optim import AdamW, WarmupCosine
from repro_torch.parallel import comm
from repro_torch.parallel.steps import (build_train_step, params_shape,
                                        shard_batch, shard_tree, train_step)
from repro_torch.runtime import ChaosError, FailureInjector, StepWatchdog
from repro_torch.tree import leaves, tree_map

__all__ = ["TrainLoop", "apply_tuned_winners", "main", "prefix_embeddings",
           "train_step", "validate_host_batch"]


def apply_tuned_winners(cfg, global_batch: int, seq_len: int, *, device):
    """The persisted tune winners of a train step on ``device``
    (``launch.tuning.adopt``, kind "train"): a lookup."""
    return tuning.adopt(cfg, dict(global_batch=global_batch,
                                  seq_len=seq_len),
                        kind="train", device=device)


def validate_host_batch(tokens, vocab_size: int):
    """Reject out-of-range token ids while the batch is still host data: a
    label >= vocab_size (or negative) would otherwise train against
    padded-vocab logits."""
    t = np.asarray(tokens)
    if t.size == 0:
        return
    lo, hi = int(t.min()), int(t.max())
    if lo < 0 or hi >= vocab_size:
        raise ValueError(
            f"batch tokens out of range [{lo}, {hi}] for vocab_size="
            f"{vocab_size}: the CE would silently train on padded-"
            "vocab logits; fix the data pipeline")


def prefix_embeddings(seed: int, step: int, global_batch: int, cfg):
    """The frontend stub's input for data step ``step``: (global_batch,
    num_prefix_embeddings, d_model) standard normals from numpy's Philox
    keyed on (seed * 2654435761 + 7, step), drawn in f32 and cast to
    ``cfg.dtype``, as ``repro.launch.train`` draws them, so both packages
    train one function on one batch."""
    rs = np.random.Generator(np.random.Philox(
        key=[seed * 2654435761 + 7, step]))
    x = rs.standard_normal((global_batch, cfg.num_prefix_embeddings,
                            cfg.d_model), np.float32)
    return torch.from_numpy(x).to(getattr(torch, cfg.dtype))


def _trainable(params):
    return tree_map(lambda p: p.detach().requires_grad_(), params)


def _assign(dst, src):
    """Copy every leaf of ``src`` into the matching leaf of ``dst`` in
    place."""
    with torch.no_grad():
        for a, b in zip(leaves(dst), leaves(src), strict=True):
            a.copy_(b)


@dataclasses.dataclass
class TrainLoop:
    """Restartable training loop with recovery; returns loss history.

    It trains through ``build_train_step``, as JAX's loop does: on the card
    one CUDA graph a step, which holds the addresses of the (params,
    optimizer state) of its first call. So a restore after a failure (from
    the latest checkpoint, or the fresh initial state without one) copies
    the restored values into those leaves in place, and the same step
    replays on; the checkpoint snapshot is copied to the host before it is
    written, so an in-place step cannot tear a save. A restore first waits
    for a save still being written, so it resumes from the latest step
    saved, whatever the writer's speed.

    ``mesh`` (a ``DeviceMesh`` of several ranks; None or one rank: as
    above): every rank runs the loop with the same arguments, holds its
    shards of the state, feeds its rows of each global batch and steps
    through the eager sharded step (``zero1``/``fsdp`` as
    ``build_train_step``'s). The first rank writes the checkpoints (the
    full arrays, gathered); every rank restores its shards of them."""

    model: LM
    global_batch: int
    seq_len: int
    steps: int
    ckpt_dir: str | None = None
    ckpt_every: int = 50
    peak_lr: float = 3e-3
    seed: int = 0
    injector: FailureInjector | None = None
    max_retries: int = 3
    log_every: int = 10
    verbose: bool = True
    device: str | None = None     # None: the model's device
    mesh: object = None
    zero1: bool = False
    fsdp: bool = False

    def run(self):
        model, cfg = self.model, self.model.cfg
        dev = model.device
        if self.device is not None and resolve_device(self.device) != dev:
            raise ValueError(f"TrainLoop device {self.device!r} differs from "
                             f"the model's {dev}")
        optimizer = AdamW(schedule=WarmupCosine(
            peak_lr=self.peak_lr, warmup_steps=max(self.steps // 20, 5),
            total_steps=self.steps))
        # persisted tune winners before the step is built (a graph keeps
        # the knobs it was captured with)
        tuned = apply_tuned_winners(cfg, self.global_batch, self.seq_len,
                                    device=dev)
        if self.verbose and (tuned or tuned.refused):
            print(f"[train] tune winners: {tuned.report()}")
        if self.mesh is None:
            step_fn, info = build_train_step(model, optimizer)
        else:
            step_fn, info = build_train_step(model, optimizer, self.mesh,
                                             zero1=self.zero1, fsdp=self.fsdp)
        rules = info.get("rules")
        sharded = rules is not None
        shardings = (info["params"], info["opt"]) if sharded else None
        writer = not sharded or torch.distributed.get_rank() == 0
        data = SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=self.seq_len,
                               global_batch=self.global_batch, seed=self.seed)
        mgr = CheckpointManager(self.ckpt_dir) if self.ckpt_dir else None
        watchdog = StepWatchdog(absolute_deadline_s=None)

        def fresh_state():
            gen = torch.Generator(device=dev).manual_seed(self.seed)
            params = model.init(gen)
            opt = optimizer.init(params)
            if sharded:
                params, opt = shard_tree((params, opt), shardings)
            return _trainable(params), opt, 0

        def restore_state():
            template = params_shape(model)
            opt_t = optimizer.init(template)
            step, (params, opt), _ = mgr.restore((template, opt_t),
                                                 device=dev,
                                                 shardings=shardings)
            return _trainable(params), opt, step

        def save(step, tree, **kw):
            mgr.save(step, tree, shardings=shardings, write=writer, **kw)

        if mgr and sharded:
            comm.barrier()      # every rank sees the same latest step
        if mgr and mgr.latest_step() is not None:
            params, opt_state, start = restore_state()
            if self.verbose:
                print(f"[train] resumed from step {start}")
        else:
            params, opt_state, start = fresh_state()

        history = []
        step = start
        retries = 0
        prefetch = Prefetcher(data, start_step=step)
        try:
            while step < self.steps:
                try:
                    if self.injector:
                        self.injector.maybe_fail(step)
                    dstep, host_batch = prefetch.next()
                    validate_host_batch(host_batch, cfg.vocab_size)
                    batch = {"tokens": torch.from_numpy(host_batch).to(dev)}
                    if cfg.frontend:
                        batch["prefix_embeddings"] = prefix_embeddings(
                            self.seed, dstep, self.global_batch, cfg).to(dev)
                    if sharded:
                        batch = shard_batch(batch, rules)
                    watchdog.start()
                    params, opt_state, loss, metrics = step_fn(
                        params, opt_state, batch)
                    loss = float(loss)
                    watchdog.stop()
                    history.append(loss)
                    if self.verbose and step % self.log_every == 0:
                        print(f"[train] step {step:5d} loss {loss:8.4f} "
                              f"lr {float(metrics['lr']):.2e} "
                              f"gnorm {float(metrics['grad_norm']):.2f}")
                    step += 1
                    if mgr and step % self.ckpt_every == 0:
                        save(step, (params, opt_state), meta={"loss": loss})
                except ChaosError as e:
                    retries += 1
                    if self.verbose:
                        print(f"[train] {e} -> recovering "
                              f"(retry {retries}/{self.max_retries})")
                    if retries > self.max_retries:
                        raise
                    prefetch.close()
                    if mgr:
                        mgr.wait()      # a save still in flight is the latest
                        if sharded:     # ... on the rank that writes it
                            comm.barrier()
                    if mgr and mgr.latest_step() is not None:
                        new_params, new_opt, step = restore_state()
                    else:
                        new_params, new_opt, step = fresh_state()
                    _assign((params, opt_state), (new_params, new_opt))
                    del new_params, new_opt
                    prefetch = Prefetcher(data, start_step=step)
            if mgr:
                save(self.steps, (params, opt_state), async_=False,
                     meta={"loss": history[-1] if history else None})
                mgr.wait()
                if sharded:
                    comm.barrier()
        finally:
            prefetch.close()
        return {"history": history, "params": params, "opt": opt_state,
                "straggler_flags": watchdog.flagged, "final_step": step,
                "tuned": tuned}


def start_mesh(device=None, *, data=None, model=1):
    """The ("data", "model") mesh of a ``torchrun`` launch: starts the
    default process group from its environment (NCCL when every rank has a
    card of its own, else gloo; the choice printed first) and returns
    ``make_local_mesh(data=, model=)``; None for a single process that
    asks for no mesh."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_local_mesh

    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1 and (data or 1) * model == 1:
        return None
    dev = resolve_device(device)
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if dev.type == "cuda" and torch.cuda.device_count() >= local:
        backend = "nccl"
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    else:
        backend = "gloo"
    print(f"[mesh] process group: {backend}, {world} ranks, "
          f"{local} on this host, {torch.cuda.device_count()} card(s)",
          flush=True)
    if not dist.is_initialized():
        dist.init_process_group(backend)
    return make_local_mesh(data=data, model=model, device=device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3_2_1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--peak-lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--remat", default="none", choices=["none", "full", "dots"])
    ap.add_argument("--fail-at", type=int, nargs="*", default=[])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain PyTorch versions)")
    ap.add_argument("--data-axis", type=int, default=None)
    ap.add_argument("--model-axis", type=int, default=1)
    args = ap.parse_args(argv)

    mesh = start_mesh(args.device, data=args.data_axis, model=args.model_axis)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    model = LM(cfg, device=args.device, remat=args.remat)
    injector = FailureInjector(args.fail_at) if args.fail_at else None
    loop = TrainLoop(model=model, global_batch=args.global_batch,
                     seq_len=args.seq_len, steps=args.steps,
                     ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                     peak_lr=args.peak_lr, injector=injector, mesh=mesh)
    t0 = time.time()
    out = loop.run()
    h = out["history"]
    print(f"[train] done on {model.device}: {len(h)} steps in "
          f"{time.time() - t0:.1f}s; loss {h[0]:.3f} -> {h[-1]:.3f}")
    return out


if __name__ == "__main__":
    main()
