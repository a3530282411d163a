#!/usr/bin/env python3
"""A compiled decode step's kernels counted three ways on one card: by the
wrappers' launch counts (what the capture added), by the nodes of its CUDA
graph, and by ``torch.profiler``'s device records of replays and of eager
steps.

    python3 tools/graph_vs_profiler.py

The model is falcon_mamba_7b (its decode step has ~4,000 kernels) at full
width in bf16, its weights drawn on the card from a seed, after a prefill
of 4 seeded prompts of 512 tokens. Its
static step comes from ``parallel.build_serve_step`` with the capture kept
(``keep_graph=True``) so that ``debug_dump`` can list the graph's kernel
nodes. Each of 3 sessions profiles 4 replays, and 4 eager
``greedy_step`` calls, with the device activity alone and with the
host's too. It prints, for
every session, the device records in all and of the rmsnorm and LM-head
reduce kernels against what the graph holds, and a last JSON line with
the counts. Needs one card.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH, SESSIONS = "falcon_mamba_7b", 3
KERNELS = {"rmsnorm": "rmsnorm_", "lm_head": "lm_head_reduce"}


def main():
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        sys.exit("graph_vs_profiler: no CUDA device")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs import get_config
    from repro_torch.models import LM
    from repro_torch.parallel import steps

    graphs = []

    def capture(fn):
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(graph):
            out = fn()
        graph.instantiate()
        graphs.append(graph)
        return graph.replay, out

    steps.capture = capture
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"[card] {card}", flush=True)

    model = LM(get_config(ARCH))
    params = model.init(torch.Generator(device="cuda").manual_seed(32))
    prompts = np.random.RandomState(31).randint(0, model.cfg.vocab_size,
                                                (4, 512))
    with torch.no_grad():
        logits, cache = model.prefill(
            params, torch.from_numpy(prompts).cuda(), max_len=512 + 64)
    tok = model.greedy_token(logits)[:, None]
    step, _ = steps.build_serve_step(model, batch=4)
    step(params, cache, tok)                  # eager
    step(params, cache, tok)                  # capture, replay
    torch.cuda.synchronize()
    launches = {name: n for name, (n, _) in step.counts.items()}

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "graph.dot")
        graphs[-1].debug_dump(path)
        with open(path) as f:
            nodes = re.findall(r"ID \| \d+ \(topoId: \d+\) \| ([^\s|}]+)",
                               f.read())
    in_graph = {k: sum(key in n for n in nodes) for k, key in KERNELS.items()}
    print(f"[graph] {len(nodes)} kernel nodes; {in_graph} of them; the "
          f"capture counted {launches}", flush=True)

    def replay():
        step(params, cache, tok)

    def eager():
        with torch.no_grad():
            model.greedy_step(params, tok, cache)

    sessions = []
    for i in range(SESSIONS):
        for what, fn in (("graph", replay), ("eager", eager)):
            for acts in ((ProfilerActivity.CUDA,),
                         (ProfilerActivity.CPU, ProfilerActivity.CUDA)):
                torch.cuda.synchronize()
                with profile(activities=list(acts)) as prof:
                    for _ in range(4):
                        fn()
                    torch.cuda.synchronize()
                seen = dict.fromkeys(KERNELS, 0)
                total = 0
                for e in prof.key_averages():
                    if e.device_type != DeviceType.CUDA:
                        continue
                    total += e.count
                    for k, key in KERNELS.items():
                        if key in e.key:
                            seen[k] += e.count
                row = dict(session=i, steps=what, host=len(acts) > 1,
                           records=total, **seen)
                sessions.append(row)
                print(f"[session {i}] 4 {what} steps, host activity "
                      f"{row['host']}: {total} device records; rmsnorm "
                      f"{seen['rmsnorm']} of {4 * in_graph['rmsnorm']}, "
                      f"lm_head {seen['lm_head']} of "
                      f"{4 * in_graph['lm_head']}", flush=True)
    print(json.dumps(dict(card=card, arch=ARCH, nodes=len(nodes),
                          in_graph=in_graph, launches=launches,
                          sessions=sessions)))


if __name__ == "__main__":
    main()
