"""Rank programs for the mesh tests (``test_torch_mesh_steps.py``,
``test_torch_mesh_elastic.py``).

Each spawned process joins a gloo process group through a file
rendezvous, runs its jobs in order, each on the ("data", "model") mesh the
job's payload names (``"mesh": (data, model)``), and pickles its numpy
results to ``<out>/<job>_<rank>.pkl`` (a traceback to
``<out>/<job>_<rank>.err`` on failure). The payloads carry full parameter
trees as numpy arrays (the JAX package's, made in the test process); this
module imports torch and the port only, so the ranks start without JAX.
"""

import datetime
import os
import pickle
import traceback


def _np(t):
    return t.detach().cpu().numpy()


def _model(payload):
    import torch

    from repro_torch.configs import get_config, reduced
    from repro_torch.models import LM, from_jax_params

    cfg = reduced(get_config(payload.get("arch", "llama3_2_1b")))
    if payload.get("cfg_changes"):
        import dataclasses
        cfg = dataclasses.replace(cfg, **payload["cfg_changes"])
    model = LM(cfg, device="cpu")
    params = from_jax_params(payload["params"], device="cpu")
    torch.manual_seed(0)
    return model, params


def _gathered(tree, placements):
    from repro_torch.parallel import gather_tree
    from repro_torch.tree import leaves_with_path

    return {k: _np(v) for k, v in leaves_with_path(
        gather_tree(tree, placements))}


def _prefill_job(mesh, payload):
    import torch

    from repro_torch.parallel import build_prefill_step, shard_tree

    model, params = _model(payload)
    toks = torch.from_numpy(payload["tokens"])
    step = build_prefill_step(model, mesh, batch=toks.shape[0],
                              max_len=payload["max_len"])
    local = shard_tree(params, step.shardings["params"])
    with torch.no_grad():
        logits, cache = step(local, {"tokens": toks})
    sc = cache["stacks"][0]
    return dict(logits=_np(logits), k_shape=tuple(sc["k"].shape),
                tp=step.shardings["rules"].tensor_parallel)


def _engine_job(mesh, payload):
    from repro_torch.serving import Engine

    model, params = _model(payload)
    eng = Engine(model, params, mesh=mesh, **payload["engine"])
    rids = [eng.submit(p, m) for p, m in payload["traffic"]]
    out = eng.drain(max_steps=500)
    kp = eng.cache["stacks"][0]["kp"]
    return dict(tokens=[out[r] for r in rids], pool=tuple(kp.shape),
                eager=eng._step.stats["eager"])


def _static_job(mesh, payload):
    from repro_torch.launch.serve import generate

    model, params = _model(payload)
    out, stats = generate(model, params, payload["prompts"],
                          gen_tokens=payload["gen"], engine="static",
                          mesh=mesh)
    return dict(tokens=out, engine=stats["engine"])


def _train_job(mesh, payload):
    import torch

    from repro_torch.optim import AdamW, WarmupCosine
    from repro_torch.parallel import build_train_step, shard_batch, shard_tree
    from repro_torch.tree import leaves, unflatten

    model, params = _model(payload)
    opt = AdamW(schedule=WarmupCosine(peak_lr=3e-3, warmup_steps=2,
                                      total_steps=3), eps=1e-6)
    step, info = build_train_step(model, opt, mesh, **payload["options"])
    state = opt.init(params)
    params, state = shard_tree((params, state), (info["params"], info["opt"]))
    params = unflatten(params, [p.requires_grad_() for p in leaves(params)])
    losses, norms = [], []
    for bt in payload["batches"]:
        batch = shard_batch({k: torch.from_numpy(v) for k, v in bt.items()},
                            info["rules"])
        params, state, loss, met = step(params, state, batch)
        losses.append(float(loss))
        norms.append(float(met["grad_norm"]))
    return dict(losses=losses, norms=norms,
                params=_gathered(params, info["params"]),
                m=_gathered(state["m"], info["opt"]["m"]),
                local_shapes=[tuple(p.shape) for p in leaves(params)],
                moment_shapes=[tuple(m.shape) for m in leaves(state["m"])],
                stats=dict(step.stats), step=int(state["step"]))


def _loop_job(mesh, payload):
    from repro_torch.launch.train import TrainLoop

    model, _ = _model(payload)
    out = TrainLoop(model=model, mesh=mesh, verbose=False,
                    **payload["loop"]).run()
    return dict(history=out["history"])


def _elastic_job(mesh, payload):
    """Train on this mesh and save (``"save"``), or restore the checkpoint
    onto this mesh (``"restore"``), then take one more step: the loss."""
    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.optim import AdamW, WarmupCosine
    from repro_torch.parallel import (build_train_step, comm, shard_batch,
                                      shard_tree)
    from repro_torch.parallel.steps import params_shape
    from repro_torch.tree import leaves, unflatten

    model, params = _model(payload)
    opt = AdamW(schedule=WarmupCosine(peak_lr=1e-3, warmup_steps=2,
                                      total_steps=20))
    step, info = build_train_step(model, opt, mesh)
    shardings = (info["params"], info["opt"])
    batch = shard_batch({"tokens": torch.from_numpy(payload["tokens"])},
                        info["rules"])
    mgr = CheckpointManager(payload["dir"], keep=1)
    first = torch.distributed.get_rank() == 0
    out = {}

    def trainable(tree):
        return unflatten(tree, [p.requires_grad_() for p in leaves(tree)])

    if payload["phase"] == "save":
        state = opt.init(params)
        params, state = shard_tree((params, state), shardings)
        params = trainable(params)
        for _ in range(3):
            params, state, loss, _ = step(params, state, batch)
        mgr.save(3, (params, state), async_=False, shardings=shardings,
                 write=first)
        comm.barrier()
        out["loss_before"] = float(loss)
    else:
        template = params_shape(model)
        got, (params, state), _ = mgr.restore(
            (template, opt.init(template)), device="cpu",
            shardings=shardings)
        params = trainable(params)
        out["restored_step"] = got
    _, _, loss, _ = step(params, state, batch)
    out["next_loss"] = float(loss)
    return out


def _ring_op_job(mesh, payload):
    """``ring_flash_op(..., mesh=)`` on this rank's sequence shards, and
    the op without an OpShard refusing ``mesh=``."""
    import torch
    import torch.distributed as dist

    from repro_torch.core import get_op

    rank, world = dist.get_rank(), dist.get_world_size()
    shards = []
    for a in payload["qkv"]:
        c = a.shape[2] // world
        shards.append(torch.from_numpy(a[:, :, rank * c:(rank + 1) * c]
                                       .copy()))
    o = get_op("ring_flash")(*shards, mesh=mesh, **payload["kw"])
    try:
        get_op("flash_attention")(*shards, mesh=mesh)
        refused = ""
    except ValueError as e:
        refused = str(e)
    return dict(o=_np(o), refused=refused)


JOBS = {"prefill": _prefill_job, "engine": _engine_job,
        "static": _static_job, "train": _train_job, "loop": _loop_job,
        "elastic": _elastic_job, "ring_op": _ring_op_job}


def main(rank, world, rdv, out_dir, jobs, payloads):
    """Join the group, run ``jobs`` (names ``kind`` or ``kind:tag``) in
    order with their payloads, leave."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_local_mesh

    torch.set_num_threads(1)
    job = "init"
    try:
        dist.init_process_group("gloo", init_method=f"file://{rdv}",
                                rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=60))
        for job in jobs:
            payload = payloads[job]
            data, model = payload.get("mesh", (1, world))
            mesh = make_local_mesh(data=data, model=model, device="cpu")
            res = JOBS[job.split(":")[0]](mesh, payload)
            with open(os.path.join(out_dir, f"{job}_{rank}.pkl"), "wb") as f:
                pickle.dump(res, f)
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"{job}_{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
