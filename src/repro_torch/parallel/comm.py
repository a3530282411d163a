"""The collectives of the sharded steps, over ``torch.distributed``.

Only two primitives are called: ``all_reduce`` (sum, max, min) and
``broadcast``. Everything else is built from them, on every backend:

- :func:`all_gather`: each rank broadcasts its slice (the gathered tensor
  holds each rank's bits);
- :func:`reduce_scatter`: on two ranks each broadcasts the half the other
  keeps and adds the half it receives (a + b on both: the sum's bits are
  the all-reduce's); on more, a sum over the group and this rank's slice;
- :func:`argmax_combine` turns each rank's row maximum and first-occurrence
  argmax over its slice of the columns into the global ones: the largest
  value, ties to the lowest global column (``torch.argmax``'s rule), with
  one max and one min reduction.

The gloo backend takes CUDA tensors for broadcast and all-reduce only, so
this one construction runs on the gloo ranks of the CPU tests and on ranks
that share a card alike. Native all-gather and reduce-scatter (NCCL) are
speed work for machines with a card a rank.

Broadcasts move half the bytes of a two-rank all-reduce: on the H100's
host, gloo gathered 2 x 400 MB by broadcasts in 0.353 s against 0.715 s
for an all-reduce of 800 MB (``tools/gloo_probe.py``; ``PERF.md``, PR
33).

A group is a ``torch.distributed`` process group (``mesh.get_group(axis)``)
or None for the default one. ``elapsed`` holds the host seconds spent in
these calls since :func:`reset_elapsed` (each call synchronises its device
first, so the time is the collective's, not the queued kernels'), and
"gathered_bytes" the bytes :func:`all_gather` received from other ranks.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

__all__ = ["all_reduce", "all_reduce_", "broadcast", "all_gather",
           "reduce_scatter", "argmax_combine", "group_size", "group_rank",
           "barrier", "reset_elapsed", "elapsed"]

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}
elapsed = {"seconds": 0.0, "calls": 0, "gathered_bytes": 0}


def reset_elapsed():
    elapsed["seconds"] = 0.0
    elapsed["calls"] = 0
    elapsed["gathered_bytes"] = 0


def group_size(group) -> int:
    return dist.get_world_size(group)


def group_rank(group) -> int:
    return dist.get_rank(group)


def _timed(fn, t):
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    t0 = time.perf_counter()
    fn()
    elapsed["seconds"] += time.perf_counter() - t0
    elapsed["calls"] += 1


def all_reduce(x, op="sum", group=None):
    """``x`` reduced over ``group`` (a new tensor; ``x`` is untouched).
    ``op``: "sum", "max" or "min"."""
    return all_reduce_(x.detach().clone().contiguous(), op, group)


def all_reduce_(x, op="sum", group=None):
    """``x`` (contiguous) reduced over ``group`` in place; returns it."""
    _timed(lambda: dist.all_reduce(x, op=_OPS[op], group=group), x)
    return x


def _global(group, r):
    return r if group is None else dist.get_global_rank(group, r)


def broadcast(x, src=0, group=None):
    """``x`` of the group's rank ``src`` on every rank (a new tensor)."""
    out = x.detach().clone().contiguous()
    _timed(lambda: dist.broadcast(out, src=_global(group, src), group=group),
           out)
    return out


def _broadcasts(bufs, group):
    """Broadcast ``bufs[r]`` from the group's rank r, for every r, in
    flight together (in place)."""
    def run():
        works = [dist.broadcast(b, src=_global(group, r), group=group,
                                async_op=True) for r, b in enumerate(bufs)]
        for w in works:
            w.wait()
    _timed(run, bufs[0])


def barrier(group=None):
    """Every rank of ``group`` reaches this point."""
    dist.barrier(group=group)


def all_gather(x, dim, group=None):
    """The ranks' ``x`` (equal shapes) concatenated along ``dim`` in rank
    order: each rank broadcasts its own."""
    n, r = group_size(group), group_rank(group)
    x = x.detach().contiguous()
    bufs = [x if i == r else torch.empty_like(x) for i in range(n)]
    _broadcasts(bufs, group)
    elapsed["gathered_bytes"] += (n - 1) * x.numel() * x.element_size()
    return torch.cat(bufs, dim)


def reduce_scatter(x, dim, group=None):
    """This rank's slice along ``dim`` (of ``x.shape[dim] / n``) of ``x``
    summed over the group."""
    n, r = group_size(group), group_rank(group)
    c = x.shape[dim] // n
    if n != 2:
        return all_reduce(x, "sum", group).narrow(dim, r * c, c).contiguous()
    mine = x.detach().narrow(dim, r * c, c).contiguous()
    other = x.detach().narrow(dim, (1 - r) * c, c).contiguous()
    got = torch.empty_like(mine)
    _broadcasts([other, got] if r == 0 else [got, other], group)
    return mine.add_(got)


def argmax_combine(m, arg, offset, group=None):
    """The global row max and argmax from each rank's over its columns.

    ``m`` (R, 1) f32 row maxima and ``arg`` (R, 1) int first-occurrence
    argmax within this rank's columns, which start at global column
    ``offset``. Returns (max (R, 1) f32, argmax (R, 1) int64): the largest
    value and the lowest global column holding it."""
    top = all_reduce(m.float(), "max", group)
    big = torch.iinfo(torch.int64).max
    col = torch.where(m.float() == top, arg.long() + offset, big)
    return top, all_reduce(col, "min", group)
