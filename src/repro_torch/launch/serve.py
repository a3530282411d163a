"""Batched greedy serving through the continuous-batching engine (the
counterpart of ``repro.launch.serve``).

``generate`` is a thin wrapper over :class:`repro_torch.serving.Engine`.
The static-batch loop of the JAX package needs the contiguous-cache decode
kernel (``flash_decode``), which is not ported yet, so models the paged path
cannot serve (rolling windows) raise here.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3_2_1b \
      --reduced --batch 4 --prompt-len 16 --gen 32 [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduced as reduce_cfg
from repro_torch.models import LM
from repro_torch.serving import Engine

__all__ = ["generate", "main"]


def _pad_token(eos_id, pad_id):
    """The token written after a sequence finishes: explicit ``pad_id``,
    else the EOS token when one is configured, else 0."""
    if pad_id is not None:
        return pad_id
    return eos_id if eos_id is not None else 0


def generate(model: LM, params, prompts: np.ndarray, *, gen_tokens: int,
             eos_id: int | None = None, max_len: int | None = None,
             pad_id: int | None = None, page_size: int | None = None,
             num_pages: int | None = None):
    """prompts: (B, P) int -> ((B, <=gen_tokens) int32 greedy tokens, stats).

    Rows that finish early are padded with ``pad_id`` (default: ``eos_id``
    when set, else 0). ``max_len`` sizes the caches (default: prompt +
    generation); ``page_size``/``num_pages`` pass through to the engine."""
    if not model.pageable:
        raise NotImplementedError(
            "generate: this model cannot decode from a paged cache, and the "
            "static-batch path (flash_decode) is not ported yet")
    b, plen = prompts.shape
    max_len = max_len or (plen + gen_tokens)
    eng = Engine(model, params, batch=b, max_len=max_len, page_size=page_size,
                 num_pages=num_pages, eos_id=eos_id)
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
    return out, {"decode_s": decode_s,
                 "tokens_per_s": n_gen / max(decode_s, 1e-9),
                 "engine": True, "preempted": preempted,
                 "page_size": eng.page_size, "device": str(model.device)}


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
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    model = LM(cfg, device=args.device)
    gen = torch.Generator(device=model.device).manual_seed(args.seed)
    params = model.init(gen)
    prompts = np.random.RandomState(args.seed).randint(
        0, cfg.vocab_size, (args.batch, args.prompt_len)).astype(np.int32)
    out, stats = generate(model, params, prompts, gen_tokens=args.gen)
    print(f"[serve] paged-engine on {stats['device']} batch={args.batch} "
          f"prompt={args.prompt_len} gen={out.shape[1]}: "
          f"{stats['tokens_per_s']:.1f} tok/s")
    print("[serve] first row:", out[0, :16].tolist())
    return out


if __name__ == "__main__":
    main()
