"""Batched serving: continuous batching over paged KV caches, or a static
batch over contiguous caches (the counterpart of ``repro.launch.serve``).

``generate`` serves through :class:`repro_torch.serving.Engine` whenever
the model is pageable; models the paged path cannot serve (rolling windows,
sinusoidal positions, SSM stacks, the zamba2 hybrid, MLA's latent cache) go
down ``_generate_static``: one prefill, then one decode step per token over
a contiguous cache, every sequence in lockstep (decode attention on the
``flash_decode`` kernel). The step comes from
``parallel.build_serve_step``, built after the prefill: on the card a CUDA
graph captured at the second step and replayed after it, dropped when the
call returns. The prefill and sampling stay eager. Both paths adopt the
persisted tune winner of their decode attention for their shapes (the
engine its paged decode split, the static loop ``flash_decode``'s;
``launch.tuning.adopt``), pass it to their step builder and return it as
``stats["tuned"]``. With ``mesh=`` both paths run on every rank of the
mesh: the engine as ``Engine(mesh=)``, the static loop over this rank's
parameter shards and its rows of the prompts (the batch split over the
data axes, the cache by ``parallel.cache_pspecs``: kv heads over "model"),
each step eager (``build_serve_step(mesh)``), the rows gathered at the end.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3_2_1b \
      --reduced --batch 4 --prompt-len 16 --gen 32 [--device cpu] \
      [--engine auto|paged|static] [--temperature T]
  torchrun --nproc-per-node 2 -m repro_torch.launch.serve --reduced \
      --device cpu --model-axis 2            # also --data-axis
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduced as reduce_cfg
from repro_torch.launch import tuning
from repro_torch.models import LM
from repro_torch.parallel import comm
from repro_torch.parallel.context import use_rules
from repro_torch.parallel.steps import (build_serve_step, cache_pspecs,
                                        make_shardings, reshard_cache,
                                        shard_tree)
from repro_torch.serving import Engine, sample

__all__ = ["apply_tuned_winners", "generate", "main"]


def apply_tuned_winners(cfg, batch: int, prompt_len: int, max_len: int, *,
                        device, page_size: int | None = None, ops=None):
    """The persisted tune winners of a serving config on ``device``
    (``launch.tuning.adopt``, kind "serve"; ``ops`` the op names to look
    up, default every probe's): a lookup; the caller passes them on."""
    return tuning.adopt(cfg, dict(batch=batch, prompt_len=prompt_len,
                                  max_len=max_len, page_size=page_size),
                        kind="serve", device=device, ops=ops)


def _pad_token(eos_id, pad_id):
    """The token written after a sequence finishes: explicit ``pad_id``,
    else the EOS token when one is configured, else 0."""
    if pad_id is not None:
        return pad_id
    return eos_id if eos_id is not None else 0


def generate(model: LM, params, prompts: np.ndarray, *, gen_tokens: int,
             eos_id: int | None = None, greedy: bool = True, rng=None,
             max_len: int | None = None, temperature: float = 1.0,
             pad_id: int | None = None, engine: str = "auto",
             page_size: int | None = None, num_pages: int | None = None,
             mesh=None, cache_dtype=None, sharded=False):
    """prompts: (B, P) int -> ((B, <=gen_tokens) int32 tokens, stats).

    Rows that finish early are padded with ``pad_id`` (default: ``eos_id``
    when set, else 0). ``greedy=False`` samples from ``softmax(logits /
    temperature)`` with ``rng``, a ``torch.Generator`` on the model's device
    (default: seed 0). ``engine="auto"`` takes the engine when the model is
    pageable, ``"static"`` forces the static loop and ``"paged"`` the engine
    (which raises for an unpageable model). ``max_len`` sizes the caches on
    both paths (default: prompt + generation); ``page_size``/``num_pages``
    and ``cache_dtype`` pass through to the engine. ``mesh``: serve on every
    rank of this mesh, each rank calling ``generate`` with the same full
    ``params`` (or, with ``sharded=True``, its shards of them:
    ``make_shardings``' placements, e.g. ``LM.init(gen, placements=)``) and
    prompts; every rank returns the whole output."""
    if engine not in ("auto", "paged", "static"):
        raise ValueError(f"engine must be auto|paged|static, got {engine!r}")
    b, plen = prompts.shape
    max_len = max_len or (plen + gen_tokens)
    use_engine = model.pageable if engine == "auto" else engine == "paged"
    if not use_engine:
        kw = dict(gen_tokens=gen_tokens, eos_id=eos_id, greedy=greedy,
                  rng=rng, max_len=max_len, temperature=temperature,
                  pad_id=pad_id)
        if mesh is not None:
            return _generate_sharded(model, params, prompts, mesh,
                                     sharded=sharded, **kw)
        return _generate_static(model, params, prompts, **kw)
    eng = Engine(model, params, batch=b, max_len=max_len, page_size=page_size,
                 num_pages=num_pages, eos_id=eos_id, greedy=greedy,
                 temperature=temperature, rng=rng, mesh=mesh,
                 cache_dtype=cache_dtype, sharded=sharded)
    t0 = time.perf_counter()
    rids = [eng.submit(prompts[i].tolist(), gen_tokens) for i in range(b)]
    results = eng.drain(max_steps=8 * (b * gen_tokens + b))
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    decode_s = time.perf_counter() - t0
    pad = _pad_token(eos_id, pad_id)
    rows = [results[r] for r in rids]
    width = (max(len(r) for r in rows)
             if all(eos_id is not None and r and r[-1] == eos_id
                    for r in rows) else gen_tokens)
    out = np.full((b, width), pad, np.int32)
    n_gen = 0
    for i, r in enumerate(rows):
        out[i, :len(r)] = r
        n_gen += len(r)
    preempted = sum(req.preempted for req in eng._requests.values())
    return out, {"prefill_s": 0.0, "decode_s": decode_s,
                 "tokens_per_s": n_gen / max(decode_s, 1e-9),
                 "engine": True, "preempted": preempted,
                 "page_size": eng.page_size, "tuned": eng.tuned,
                 "device": str(model.device)}


def _generate_static(model: LM, params, prompts: np.ndarray, *,
                     gen_tokens: int, eos_id: int | None = None,
                     greedy: bool = True, rng=None,
                     max_len: int | None = None, temperature: float = 1.0,
                     pad_id: int | None = None, rules=None):
    """Static batching: one prefill, then ``build_serve_step``'s step over
    ``greedy_step`` (or ``decode_step`` + :func:`sample`) on a contiguous
    cache, every row in lockstep. The first token comes from the prefill's
    greedy argmax, as in the JAX loop. The serving path for models the
    engine cannot page. With ``rules`` (from :func:`_generate_sharded`):
    this rank's shards and rows, the prefill and steps under the rules on
    their mesh, sampled tokens drawn on the first rank of the "model" group
    and broadcast over it."""
    cfg = model.cfg
    b, plen = prompts.shape
    max_len = max_len or (plen + gen_tokens)
    if model.has_positional_cache and plen + gen_tokens > max_len:
        raise ValueError(
            f"kv cache overflow: prompt_len {plen} + gen_tokens {gen_tokens} "
            f"= {plen + gen_tokens} tokens but max_len={max_len}; raise "
            "max_len (rolling-window archs are exempt: their caches rotate)")
    if temperature <= 0:
        raise ValueError(f"temperature must be > 0, got {temperature}")
    if not greedy and rng is None:
        rng = torch.Generator(device=model.device).manual_seed(0)
    pad = _pad_token(eos_id, pad_id)
    toks = torch.as_tensor(np.asarray(prompts), dtype=torch.long,
                           device=model.device)

    def draw(logits):
        nxt = sample(logits, cfg.vocab_size, temperature, rng)
        if rules is not None and rules.size(rules.model_axis) > 1:
            nxt = comm.broadcast(nxt, 0, rules.group(rules.model_axis))
        return nxt

    t0 = time.perf_counter()
    with torch.no_grad(), use_rules(rules):
        logits, cache = model.prefill(params, toks, max_len=max_len)
        tok = model.greedy_token(logits).cpu().numpy()
        if rules is not None:
            # the prefill's layout into the decode steps' (once)
            gb = b * rules.data_size
            cache = reshard_cache(
                cache, cache_pspecs(model, rules.mesh, gb, max_len,
                                    kind="prefill"),
                cache_pspecs(model, rules.mesh, gb, max_len), rules.mesh)
    prefill_s = time.perf_counter() - t0
    # the persisted decode split, passed to the step (its graph keeps it)
    tuned = apply_tuned_winners(cfg, b, plen, max_len, device=model.device,
                                ops=("flash_decode",))
    split = tuned.knob("flash_decode", "split")
    if rules is None:
        step, _ = build_serve_step(model, batch=b, greedy=greedy, split=split)
    else:
        step, _ = build_serve_step(model, rules.mesh, batch=b,
                                   max_len=max_len, greedy=greedy,
                                   split=split)

    out = np.zeros((b, gen_tokens), np.int32)
    done = np.zeros((b,), bool)
    t0 = time.perf_counter()
    with torch.no_grad():
        for t in range(gen_tokens):
            out[:, t] = np.where(done, pad, tok)
            if eos_id is not None:
                done |= tok == eos_id
                if done.all():
                    out = out[:, :t + 1]
                    break
            step_in = torch.from_numpy(tok.reshape(b, 1).astype(np.int64))
            step_in = step_in.to(model.device)
            if greedy:
                nxt, _, cache = step(params, cache, step_in)
            else:
                logits, cache = step(params, cache, step_in)
                nxt = draw(logits)
            tok = nxt.cpu().numpy()
    decode_s = time.perf_counter() - t0
    n_gen = out.shape[1] * b
    return out, {"prefill_s": prefill_s, "decode_s": decode_s,
                 "tokens_per_s": n_gen / max(decode_s, 1e-9),
                 "engine": False, "tuned": tuned, "device": str(model.device)}


def _generate_sharded(model, params, prompts, mesh, *, sharded=False, **kw):
    """The static loop on ``mesh``: this rank's parameter shards (``params``
    cut to them, or ``params`` themselves with ``sharded``) and its rows of
    the prompts; the data ranks' rows gathered at the end, each padded to
    the longest (a row stopped early on EOS is padded, as the loop pads
    it)."""
    placements, _, rules, _ = make_shardings(model, mesh)
    n, i = rules.data_size, rules.data_index()
    b = prompts.shape[0]
    if b % n:
        raise NotImplementedError(
            f"generate(mesh=): a batch of {b} does not split over {n} data "
            "ranks (the sequence-sharded cache of cache_pspecs is not "
            "ported)")
    c = b // n
    local = params if sharded else shard_tree(params, placements)
    out, stats = _generate_static(model, local, prompts[i * c:(i + 1) * c],
                                  rules=rules, **kw)
    if n > 1:
        dev = model.device
        width = int(comm.all_reduce(torch.tensor([out.shape[1]], device=dev),
                                    "max")[0])
        mine = np.full((c, width), _pad_token(kw.get("eos_id"),
                                              kw.get("pad_id")), np.int32)
        mine[:, :out.shape[1]] = out
        full = torch.from_numpy(mine).to(dev)
        for a in reversed(rules.data_axes):
            full = comm.all_gather(full, 0, rules.group(a))
        out = full.cpu().numpy()
    return out, stats


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3_2_1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain PyTorch versions)")
    ap.add_argument("--engine", default="auto",
                    choices=("auto", "paged", "static"))
    ap.add_argument("--temperature", type=float, default=None,
                    help="sample at this temperature (default: greedy)")
    ap.add_argument("--data-axis", type=int, default=None)
    ap.add_argument("--model-axis", type=int, default=1)
    args = ap.parse_args(argv)

    from repro_torch.launch.train import start_mesh

    mesh = start_mesh(args.device, data=args.data_axis, model=args.model_axis)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    model = LM(cfg, device=args.device)
    gen = torch.Generator(device=model.device).manual_seed(args.seed)
    params = model.init(gen)
    prompts = np.random.RandomState(args.seed).randint(
        0, cfg.vocab_size, (args.batch, args.prompt_len)).astype(np.int32)
    greedy = args.temperature is None
    rng = (None if greedy else
           torch.Generator(device=model.device).manual_seed(args.seed))
    out, stats = generate(model, params, prompts, gen_tokens=args.gen,
                          engine=args.engine, greedy=greedy, rng=rng,
                          temperature=1.0 if greedy else args.temperature,
                          mesh=mesh)
    tuned = stats["tuned"]
    if tuned or tuned.refused or tuned.skipped:
        print(f"[serve] tune winners: {tuned.report()}")
    path = "paged-engine" if stats["engine"] else "static"
    print(f"[serve] {path} on {stats['device']} batch={args.batch} "
          f"prompt={args.prompt_len} gen={out.shape[1]}: prefill "
          f"{stats['prefill_s']:.3f}s, {stats['tokens_per_s']:.1f} tok/s")
    print("[serve] first row:", out[0, :16].tolist())
    return out


if __name__ == "__main__":
    main()
