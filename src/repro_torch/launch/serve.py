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
``stats["tuned"]``. The static loop has no mesh (not ported).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3_2_1b \
      --reduced --batch 4 --prompt-len 16 --gen 32 [--device cpu] \
      [--engine auto|paged|static] [--temperature T]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduced as reduce_cfg
from repro_torch.launch import tuning
from repro_torch.models import LM
from repro_torch.parallel.steps import build_serve_step
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
             page_size: int | None = None, num_pages: int | None = None):
    """prompts: (B, P) int -> ((B, <=gen_tokens) int32 tokens, stats).

    Rows that finish early are padded with ``pad_id`` (default: ``eos_id``
    when set, else 0). ``greedy=False`` samples from ``softmax(logits /
    temperature)`` with ``rng``, a ``torch.Generator`` on the model's device
    (default: seed 0). ``engine="auto"`` takes the engine when the model is
    pageable, ``"static"`` forces the static loop and ``"paged"`` the engine
    (which raises for an unpageable model). ``max_len`` sizes the caches on
    both paths (default: prompt + generation); ``page_size``/``num_pages``
    pass through to the engine."""
    if engine not in ("auto", "paged", "static"):
        raise ValueError(f"engine must be auto|paged|static, got {engine!r}")
    b, plen = prompts.shape
    max_len = max_len or (plen + gen_tokens)
    use_engine = model.pageable if engine == "auto" else engine == "paged"
    if not use_engine:
        return _generate_static(model, params, prompts,
                                gen_tokens=gen_tokens, eos_id=eos_id,
                                greedy=greedy, rng=rng, max_len=max_len,
                                temperature=temperature, pad_id=pad_id)
    eng = Engine(model, params, batch=b, max_len=max_len, page_size=page_size,
                 num_pages=num_pages, eos_id=eos_id, greedy=greedy,
                 temperature=temperature, rng=rng)
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
                     pad_id: int | None = None):
    """Static batching: one prefill, then ``build_serve_step``'s step over
    ``greedy_step`` (or ``decode_step`` + :func:`sample`) on a contiguous
    cache, every row in lockstep. The first token comes from the prefill's
    greedy argmax, as in the JAX loop. The serving path for models the
    engine cannot page."""
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
    t0 = time.perf_counter()
    with torch.no_grad():
        logits, cache = model.prefill(params, toks, max_len=max_len)
        tok = model.greedy_token(logits).cpu().numpy()
    prefill_s = time.perf_counter() - t0
    # the persisted decode split, passed to the step (its graph keeps it)
    tuned = apply_tuned_winners(cfg, b, plen, max_len, device=model.device,
                                ops=("flash_decode",))
    step, _ = build_serve_step(model, batch=b, greedy=greedy,
                               split=tuned.knob("flash_decode", "split"))

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
                nxt = sample(logits, cfg.vocab_size, temperature, rng)
            tok = nxt.cpu().numpy()
    decode_s = time.perf_counter() - t0
    n_gen = out.shape[1] * b
    return out, {"prefill_s": prefill_s, "decode_s": decode_s,
                 "tokens_per_s": n_gen / max(decode_s, 1e-9),
                 "engine": False, "tuned": tuned, "device": str(model.device)}


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
    args = ap.parse_args(argv)

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
                          temperature=1.0 if greedy else args.temperature)
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
