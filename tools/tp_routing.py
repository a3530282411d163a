#!/usr/bin/env python3
"""A MoE model's routing on a (data 1, model 2) mesh against one rank's,
one decode step from the same state, layer by layer.

    python3 tools/tp_routing.py [arch]        # default deepseek_v2_lite

Builds every kernel, then two spawned ranks on the card (gloo) draw the
whole bf16 model's shards (``LM.init(placements=)``), prefill
``chip_smoke``'s phase-23 prompts and take one greedy decode step, each
MoE router's top-k experts recorded. This process then loads the model
on one rank and takes the same step from the ranks' state (their cache,
whole, and their tokens; ``chip_smoke._tp_forced_step`` without its
routing and layer replay), recording its own routing. Prints the largest
logit difference of each row and, for each MoE layer, the rows whose
experts differ. Needs one card.
"""

import datetime
import os
import pickle
import shutil
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]


def _rank(rank, tmp, arch):
    import torch
    import torch.distributed as dist

    import chip_smoke as cs
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import LM
    from repro_torch.parallel import (build_prefill_step, build_serve_step,
                                      comm, make_shardings, reshard_cache)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rdv",
                            rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=300))
    mesh = make_local_mesh(data=1, model=2, device="cpu")
    model = LM(cs._tp_cfg(arch, {}))
    params = model.init(torch.Generator(device="cuda").manual_seed(61),
                        placements=make_shardings(model, mesh)[0])
    toks = torch.from_numpy(cs._tp_prompts(model.cfg.vocab_size)).cuda()
    b, max_len = toks.shape[0], toks.shape[1] + cs.TP_NEW
    prefill = build_prefill_step(model, mesh, batch=b, max_len=max_len)
    step, info = build_serve_step(model, mesh, batch=b, max_len=max_len)
    routes = []
    with torch.no_grad():
        logits, cache = prefill(params, {"tokens": toks.long()})
        cache = reshard_cache(cache, prefill.shardings["cache"],
                              info["cache_pspecs"], mesh)
        state = cs._tp_whole(cache, info["cache_pspecs"], mesh)
        tok = model.greedy_token(logits)[:, None]
        with cs._TPRoutes(record=routes):
            _, lg, _ = step(params, cache, tok)
        lg = comm.all_gather(lg, -1, info["rules"].group("model"))
    if rank == 0:
        with open(os.path.join(tmp, "rank.pkl"), "wb") as f:
            pickle.dump(dict(cache=state, tokens=tok.cpu(), routes=routes,
                             logits=lg.float().cpu()), f)
    dist.destroy_process_group()


def main():
    import multiprocessing as mp

    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.models import LM
    from repro_torch.tree import tree_map

    arch = sys.argv[1] if len(sys.argv) > 1 else "deepseek_v2_lite"
    _build.build_all()
    tmp = tempfile.mkdtemp(prefix="tp_routing_")
    try:
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_rank, args=(r, tmp, arch))
                 for r in range(2)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(600)
        if any(p.exitcode for p in procs):
            raise SystemExit(f"rank exit codes {[p.exitcode for p in procs]}")
        with open(os.path.join(tmp, "rank.pkl"), "rb") as f:
            got = pickle.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    model = LM(cs._tp_cfg(arch, {}))
    params = model.init(torch.Generator(device="cuda").manual_seed(61))
    cache = tree_map(lambda t: t.cuda(), got["cache"])
    routes = []
    with torch.no_grad(), cs._TPRoutes(record=routes):
        _, want, _ = model.greedy_step(params, got["tokens"].cuda(), cache)
    v = model.cfg.vocab_size
    err = (got["logits"][:, :v] - want.float().cpu()[:, :v]).abs()
    print(f"[routing] {arch}: largest |logit| {float(want[:, :v].abs().max()):.4f}; "
          f"each row's largest difference {[round(float(e), 4) for e in err.amax(-1)]}")
    for layer, (a, b) in enumerate(zip(got["routes"], routes)):
        a, b = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
        rows = [r for r in range(a.shape[0])
                if set(a[r].tolist()) != set(b[r].tolist())]
        print(f"[routing] MoE layer {layer}: rows routed otherwise {rows}")


if __name__ == "__main__":
    main()
