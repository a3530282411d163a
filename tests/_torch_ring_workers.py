"""Rank programs for the distributed-ring tests in ``test_torch_ring.py``.

Each spawned process joins a gloo process group through a file rendezvous,
builds the port's ("data", "model") mesh on the CPU, runs one job and
pickles its numpy results to ``<out>/<job>_<rank>.pkl`` (a traceback to
``<out>/<job>_<rank>.err`` on failure). This module imports torch and the
port only, so the ranks start without JAX.
"""

import contextlib
import datetime
import os
import pickle
import traceback


def _np(t):
    return t.detach().cpu().numpy()


@contextlib.contextmanager
def _counting_ring_calls():
    """Count the calls of ``gqa_forward``'s ring branch (the layer module's
    ``_ring_attention``) while the block runs; yields the running count."""
    from repro_torch.layers import attention as attn

    calls = [0]
    real = attn._ring_attention

    def counted(*args, **kwargs):
        calls[0] += 1
        return real(*args, **kwargs)

    attn._ring_attention = counted
    try:
        yield calls
    finally:
        attn._ring_attention = real


def _ring_job(rank, world, mesh, payload):
    """Forward and q/k/v gradients of (o ** 2).sum() through the
    distributed ring, per case; this rank's shards of each."""
    import torch

    from repro_torch.kernels.flash_attention import ring_flash_attention

    out = {}
    for name, (arrays, kw) in payload["cases"].items():
        shards = []
        for a in arrays:
            c = a.shape[2] // world
            t = torch.from_numpy(a[:, :, rank * c:(rank + 1) * c].copy())
            shards.append(t.requires_grad_(True))
        o = ring_flash_attention(*shards, mesh=mesh, **kw)
        grads = torch.autograd.grad((o ** 2).sum(), shards)
        out[name] = [_np(o)] + [_np(g) for g in grads]
    q = torch.zeros(1, 1, 4, 16)
    try:
        ring_flash_attention(q, q, q, mesh=mesh, ring_steps=world + 1)
        out["contradicts"] = ""
    except ValueError as e:
        out["contradicts"] = str(e)
    return out


def _layer_job(rank, world, mesh, payload):
    """gqa_forward and its gradients without rules and under ring rules."""
    import torch

    from repro_torch.layers import attention as attn
    from repro_torch.parallel import Rules, use_rules

    cfg = payload["cfg"]
    params = {k: torch.from_numpy(v) for k, v in payload["params"].items()}
    x = torch.from_numpy(payload["x"])
    out = {"ring_calls": {}}
    ring_rules = Rules(mesh=mesh, ring_axis="model")
    for tag, rules in (("plain", None), ("ring", ring_rules)):
        leaves = dict(params, x=x.clone())
        for t in leaves.values():
            t.requires_grad_(True)
        xx = leaves.pop("x")
        with use_rules(rules), _counting_ring_calls() as calls:
            y = attn.gqa_forward(leaves, xx, cfg)
        grads = torch.autograd.grad((y ** 2).sum(), [xx, *leaves.values()])
        out[tag] = [_np(y)] + [_np(g) for g in grads]
        out["ring_calls"][tag] = calls[0]
    out["ring_axis"] = ring_rules.ring_axis
    return out


def _prefill_job(rank, world, mesh, payload):
    """Reduced llama3_2_1b prefill through build_prefill_step(ring=...)."""
    import torch

    from repro_torch.configs import get_config, reduced
    from repro_torch.models import LM, from_jax_params
    from repro_torch.parallel import build_prefill_step, make_shardings

    model = LM(reduced(get_config("llama3_2_1b")), device="cpu")
    params = from_jax_params(payload["params"], device="cpu")
    toks = torch.from_numpy(payload["tokens"])
    step = build_prefill_step(model, mesh, batch=toks.shape[0],
                              max_len=payload["max_len"], ring=payload["ring"])
    with torch.no_grad(), _counting_ring_calls() as calls:
        logits, cache = step(params, {"tokens": toks})
    sc = cache["stacks"][0]
    return dict(logits=_np(logits), k=_np(sc["k"]), v=_np(sc["v"]),
                pos=cache["pos"], ring_calls=calls[0],
                ring_axis=make_shardings(model, mesh, ring=True)[2].ring_axis)


JOBS = {"ring": _ring_job, "layer": _layer_job, "prefill": _prefill_job}


def main(rank, world, rdv, out_dir, jobs, payloads):
    """Join the group, run ``jobs`` in order with their payloads, leave."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_local_mesh

    torch.set_num_threads(1)
    job = "init"
    try:
        dist.init_process_group("gloo", init_method=f"file://{rdv}",
                                rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=60))
        mesh = make_local_mesh(model=world, device="cpu")
        for job in jobs:
            res = JOBS[job](rank, world, mesh, payloads[job])
            with open(os.path.join(out_dir, f"{job}_{rank}.pkl"), "wb") as f:
                pickle.dump(res, f)
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"{job}_{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
