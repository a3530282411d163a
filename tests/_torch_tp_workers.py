"""Rank programs for the tensor-parallel and pipeline tests
(``test_torch_tp_*.py``, ``test_torch_pipeline.py``): the jobs of
``_torch_mesh_workers`` ("static", "engine", "train") and these:

- "prefill": ``build_prefill_step`` on the job's mesh, with the prefix
  embeddings where the payload has them: the (gathered) logits and the
  shapes of the first stack's cache leaves on this rank;
- "serve": the static path by hand with the prefix: the prefill step, the
  move into the decode layout (``reshard_cache``) and ``build_serve_step``'s
  greedy steps: the tokens and the first stack's decode cache shapes;
- "pipeline": ``pipeline_apply`` on a ("pipe",) mesh of every rank against
  JAX's setup: the outputs and this rank's stage gradients.

This module imports torch and the port only, as ``_torch_mesh_workers``.
"""

import _torch_mesh_workers as mw


def _np(t):
    return t.detach().cpu().numpy()


def _batch(payload):
    import torch

    b = {"tokens": torch.from_numpy(payload["tokens"])}
    if payload.get("prefix") is not None:
        b["prefix_embeddings"] = torch.from_numpy(payload["prefix"])
    return b


def _shapes(cache):
    """{leaf key: shape} of the first stack's cache (a zamba group's mamba
    and attention leaves together)."""
    sc = cache["stacks"][0]
    if "attn" in sc:
        sc = dict(sc["mamba"], **sc["attn"])
    return {k: tuple(v.shape) for k, v in sc.items()}


def _prefill_job(mesh, payload):
    import torch

    from repro_torch.parallel import build_prefill_step, shard_tree

    model, params = mw._model(payload)
    batch = _batch(payload)
    step = build_prefill_step(model, mesh, batch=batch["tokens"].shape[0],
                              max_len=payload["max_len"])
    local = shard_tree(params, step.shardings["params"])
    with torch.no_grad():
        logits, cache = step(local, batch)
    return dict(logits=_np(logits), cache=_shapes(cache))


def _serve_job(mesh, payload):
    import numpy as np
    import torch

    from repro_torch.parallel import (build_prefill_step, build_serve_step,
                                      shard_tree)
    from repro_torch.parallel.steps import reshard_cache

    model, params = mw._model(payload)
    batch = _batch(payload)
    b, max_len = batch["tokens"].shape[0], payload["max_len"]
    prefill = build_prefill_step(model, mesh, batch=b, max_len=max_len)
    local = shard_tree(params, prefill.shardings["params"])
    step, info = build_serve_step(model, mesh, batch=b, max_len=max_len)
    out = []
    with torch.no_grad():
        logits, cache = prefill(local, batch)
        cache = reshard_cache(cache, prefill.shardings["cache"],
                              info["cache_pspecs"], mesh)
        tok = torch.argmax(logits[:, :model.cfg.vocab_size], dim=-1)
        for _ in range(payload["gen"]):
            out.append(_np(tok))
            tok, _, cache = step(local, cache, tok[:, None])
    return dict(tokens=np.stack(out, axis=1), cache=_shapes(cache),
                gathered=list(step.stats["gathered_bytes"]))


def _pipeline_job(mesh, payload):
    import torch

    from repro_torch.launch.mesh import make_pipe_mesh
    from repro_torch.parallel.pipeline import pipeline_apply, split_stages

    del mesh
    pipe = make_pipe_mesh(device="cpu")
    stage = pipe.get_local_rank("pipe")
    stacked = {k: torch.from_numpy(v) for k, v in payload["stacked"].items()}
    stages = split_stages(stacked, pipe.shape[0])
    mine = {k: v[stage:stage + 1].clone().requires_grad_()
            for k, v in stages.items()}
    x = torch.from_numpy(payload["x"])

    def stage_fn(p, x):
        for i in range(p["w"].shape[0]):
            x = x + torch.tanh(x @ p["w"][i] + p["b"][i])
        return x

    y = pipeline_apply(stage_fn, mine, x, mesh=pipe)
    (y ** 2).sum().backward()
    return dict(y=_np(y), stage=stage,
                grads={k: _np(v.grad) for k, v in mine.items()})


mw.JOBS.update(prefill=_prefill_job, serve=_serve_job,
               pipeline=_pipeline_job)


def main(rank, world, rdv, out_dir, jobs, payloads):
    mw.main(rank, world, rdv, out_dir, jobs, payloads)
