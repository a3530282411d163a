"""Pipeline parallelism (GPipe) over a "pipe" mesh axis: the counterpart of
``repro.parallel.pipeline``.

Stage weights live stage-sharded (leading dim S over the pipe axis: each
rank holds its stage's slice); M microbatches stream through the S stages,
each rank running its stage. The schedule is JAX's: T = M + S - 1 ticks
(bubble fraction (S - 1) / T); at tick t stage 0 takes microbatch t
(zeros past the last), every other stage the output its predecessor made
at tick t - 1, and the last stage's outputs for ticks S - 1 .. T - 1 are
the microbatches' results, replicated to every rank.

    y_mb = pipeline_apply(stage_fn, stage_params, x_mb, mesh=mesh)

``stage_fn(params_i, x) -> y`` must preserve x's shape and dtype (a
residual stack). The mesh is a one-axis ``DeviceMesh`` named "pipe", as
JAX's test builds it with ``jax.make_mesh((4,), ("pipe",))``.

The handoff between neighbouring stages is :class:`_Handoff`, an autograd
Function whose backward hands each gradient to the previous stage, so the
whole pipeline is differentiable as JAX's scan is (GPipe semantics: the
backward replays the schedule in reverse). It is built from
``parallel.comm``'s broadcasts within each pair of neighbouring ranks (a
process group of two), one construction on gloo CPU ranks and on ranks
that share a card alike.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.tree import tree_map

from . import comm

__all__ = ["pipeline_apply", "split_stages", "stage_param_specs"]


def split_stages(stacked_params, n_stages: int):
    """(L, ...) layer-stacked params -> (S, L/S, ...) stage-stacked."""
    def resh(a):
        n = a.shape[0]
        if n % n_stages:
            raise ValueError(f"split_stages: {n} layers do not split into "
                             f"{n_stages} stages")
        return a.reshape(n_stages, n // n_stages, *a.shape[1:])
    return tree_map(resh, stacked_params)


def stage_param_specs(pspecs, axis: str = "pipe"):
    """Prepend the pipe axis to every stage-stacked param spec."""
    def walk(t):
        if isinstance(t, tuple) and all(e is None or isinstance(e, (str,
                                                                    tuple))
                                        for e in t):
            return (axis, *t)
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        return type(t)(walk(v) for v in t)
    return walk(pspecs)


_PAIRS = {}


def _pairs(mesh, axis):
    """(stage, stages, [the process group of stages (i, i + 1)], the pipe
    group) of this rank on ``mesh``. Every rank creates every pair's group
    in the same order (``new_group`` is collective), once per mesh."""
    names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
    if names != (axis,):
        raise ValueError(f"pipeline_apply: the mesh must have the one axis "
                         f"{axis!r}, got {names}")
    key = (id(mesh), axis)
    if key not in _PAIRS:
        ranks = [int(r) for r in mesh.mesh.reshape(-1).tolist()]
        groups = [dist.new_group(ranks=[ranks[i], ranks[i + 1]])
                  for i in range(len(ranks) - 1)]
        _PAIRS[key] = (mesh, groups)
    groups = _PAIRS[key][1]
    return (mesh.get_local_rank(axis), mesh.shape[0], groups,
            mesh.get_group(axis))


def _send_recv(x, stage, n, groups, *, up):
    """Hand ``x`` to the next stage (``up``) or the previous one (not
    ``up``): each pair of neighbours (i, i + 1) in turn, a broadcast in
    their group from its sender. Returns what this rank received (zeros
    where it has no neighbour on that side)."""
    got = None
    for i, g in enumerate(groups):
        if stage not in (i, i + 1):
            continue
        sender = i if up else i + 1
        src = 0 if up else 1
        if stage == sender:
            comm.broadcast(x, src, g)
        else:
            got = comm.broadcast(torch.empty_like(x), src, g)
    return torch.zeros_like(x) if got is None else got


class _Handoff(torch.autograd.Function):
    """This stage's input for the next tick: the previous stage's output
    ``y`` of this tick, handed over (``feed``, the next microbatch, on
    stage 0). Backward: the input's gradient is handed back to the previous
    stage, and the gradient of ``y`` arrives from the next one (zeros on
    the last stage)."""

    @staticmethod
    def forward(ctx, y, feed, stage, n, groups):
        ctx.stage, ctx.n, ctx.groups = stage, n, groups
        got = _send_recv(y.detach().contiguous(), stage, n, groups, up=True)
        return feed.clone() if stage == 0 else got

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        gy = _send_recv(g, ctx.stage, ctx.n, ctx.groups, up=False)
        return gy, (g if ctx.stage == 0 else None), None, None, None


class _FromLast(torch.autograd.Function):
    """The last stage's ``x`` on every rank of the pipe group; the gradient
    goes to the last stage alone (every rank's loss is the one loss)."""

    @staticmethod
    def forward(ctx, x, stage, n, group):
        ctx.last = stage == n - 1
        return comm.broadcast(x.detach().contiguous(), n - 1, group)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.last else torch.zeros_like(g)), None, None, None


def pipeline_apply(stage_fn, stage_params, x_microbatches, *, mesh,
                   axis: str = "pipe"):
    """Run (M, mb, ...) microbatches through S pipeline stages.

    ``stage_params``: this rank's stage of the stage-stacked tree, with
    leading dim 1 (its ``stage_param_specs`` shard; ``stage_fn`` takes it
    without that dim). ``x_microbatches``: the full (M, mb, ...) on every
    rank. Returns the final stage's (M, mb, ...) outputs on every rank,
    differentiable in every stage's parameters."""
    stage, n, groups, group = _pairs(mesh, axis)
    params = tree_map(lambda a: a[0], stage_params)
    m = x_microbatches.shape[0]
    ticks = m + n - 1
    zero = torch.zeros_like(x_microbatches[0])
    x_in = x_microbatches[0] if stage == 0 else zero
    ys = []
    for t in range(ticks):
        y = stage_fn(params, x_in)
        ys.append(y)
        if t + 1 < ticks:
            feed = x_microbatches[t + 1] if t + 1 < m else zero
            x_in = _Handoff.apply(y, feed, stage, n, groups)
    # the final stage emitted microbatch i at tick i + S - 1
    return _FromLast.apply(torch.stack(ys[n - 1:]), stage, n, group)
