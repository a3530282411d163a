#!/usr/bin/env python3
"""What gloo's collectives cost between two processes on one card: the
data behind ``repro_torch.parallel.comm``'s constructions.

    python3 tools/gloo_probe.py

Spawns two ranks on cuda:0 (a file rendezvous) and prints, for rank 0,
the startup's parts (spawn to Python, importing the port, CUDA's first
call, joining the group) and the best of two runs of each collective on
CUDA tensors: an all-reduce of 800 MB f32, directly and staged through
pinned host memory; a gather of two 400 MB halves by one broadcast from
each rank (directly and staged); a two-rank reduce-scatter by two
broadcasts (each rank sends the half the other keeps, then adds); 50
all-reduces of 64 KB and 10 of 16 MB. Needs one card.
"""

import os
import sys
import tempfile
import time


def _rank(rank, world, rdv, t_spawn):
    import torch
    import torch.distributed as dist

    t_imp = time.time()
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src"))
    import repro_torch.models  # noqa: F401
    import repro_torch.serving  # noqa: F401
    t_port = time.time()
    torch.cuda.set_device(0)
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    t_cuda = time.time()
    dist.init_process_group("gloo", init_method=f"file://{rdv}", rank=rank,
                            world_size=world)
    t_pg = time.time()
    if rank == 0:
        print(f"startup: spawn to python {t_imp - t_spawn:.2f}s, the port's "
              f"import {t_port - t_imp:.2f}s, cuda's first call "
              f"{t_cuda - t_port:.2f}s, the group {t_pg - t_cuda:.2f}s",
              flush=True)
    n = 200_000_000                               # 800 MB of f32
    h = n // 2
    x = torch.ones(n, device="cuda")

    def best(fn, reps=2):
        out = float("inf")
        for _ in range(reps):
            torch.cuda.synchronize()
            t = time.time()
            fn()
            torch.cuda.synchronize()
            out = min(out, time.time() - t)
        return out

    def staged(t, fn):
        p = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        p.copy_(t)
        fn(p)
        t.copy_(p)

    def gather(t):
        works = [dist.broadcast(t[r * h:(r + 1) * h], src=r, async_op=True)
                 for r in range(world)]
        for w in works:
            w.wait()

    def reduce_scatter(t):
        mine = t[rank * h:(rank + 1) * h]
        other = t[(1 - rank) * h:(2 - rank) * h]
        got = torch.empty_like(mine)
        bufs = [other if r == rank else got for r in range(world)]
        works = [dist.broadcast(bufs[r], src=r, async_op=True)
                 for r in range(world)]
        for w in works:
            w.wait()
        mine.add_(got)

    dist.all_reduce(x)
    small = torch.ones(16384, device="cuda")
    mid = torch.ones(4_000_000, device="cuda")
    res = {
        "all-reduce 800 MB": best(lambda: dist.all_reduce(x)),
        "all-reduce 800 MB, staged": best(
            lambda: staged(x, dist.all_reduce)),
        "gather 2 x 400 MB by broadcasts": best(lambda: gather(x)),
        "gather by broadcasts, staged": best(lambda: staged(x, gather)),
        "reduce-scatter 800 MB by 2 broadcasts": best(
            lambda: reduce_scatter(x)),
        "50 all-reduces of 64 KB": best(
            lambda: [dist.all_reduce(small) for _ in range(50)]),
        "10 all-reduces of 16 MB": best(
            lambda: [dist.all_reduce(mid) for _ in range(10)]),
    }
    if rank == 0:
        for k, v in res.items():
            print(f"{k}: {v:.3f}s", flush=True)
    dist.destroy_process_group()


def main():
    import torch.multiprocessing as mp

    tmp = tempfile.mkdtemp(prefix="gloo_probe_")
    mp.spawn(_rank, args=(2, os.path.join(tmp, "rdv"), time.time()),
             nprocs=2)


if __name__ == "__main__":
    main()
