"""Sequence-parallel ring flash attention (counterpart of
``repro.kernels.flash_attention.ring``).

A ring STEP is flash attention of a query shard against one kv chunk at
absolute offsets (``ring_flash_fwd``: ``csrc/ring_flash.cu`` on the card,
its plain version on the CPU), emitting the chunk-local ``(o, lse)``.
``_RingStep`` makes it differentiable: its backward runs ``flash_delta``,
folds the lse cotangent into delta (``delta' = rowsum(do o) - g_lse``, the
JAX ``_ring_step_bwd``) and runs ``ring_flash_bwd``. Steps are combined by
:func:`ring_merge`, the exact logsumexp reweighting.

:func:`ring_flash_attention` runs the schedule in two forms:

* without ``mesh`` (the local form): the kv stream is split into
  ``ring_steps`` chunks in one process and every chunk is one step against
  all of q, queries aligned to the end of the stream;
* with ``mesh`` (a ``torch.distributed`` ``DeviceMesh``): q, k and v are
  this rank's sequence shards; at step t rank i holds kv chunk
  ``(i + t) % n`` and k/v rotate one rank along the ring between steps by
  ``batch_isend_irecv`` (``_Rotate``; gloo on CPU tensors, NCCL on CUDA
  tensors). Autograd retraces the ring: ``_Rotate``'s backward sends the
  gradients the other way, as JAX's transpose of ``ppermute`` does, so dk
  and dv arrive at the rank that owns their chunk.

On the card a gradient needs ``ring_flash_bwd``, which takes the head dims
``RING_BWD_HEAD_DIMS[route(q, k, v)]``: 32, 64, 112, 128 and 256 on the
tensor-core route (bf16 whose rows the kernel's 16-byte copies can read;
112 and 256 in ``csrc/ring_flash_wide.cu``), 32 and 64 on the CUDA-core
route (f32). Asked for at another head dim,
:func:`ring_flash_attention` raises before its first launch (as
``flash_attention`` does) instead of failing inside ``backward``.

``ring_flash_op`` declares one ring step over ``ring_flash_fwd_builder``
(o; ``raw`` gives (o, lse)) for the op front end (``repro_torch.core``)
under the JAX op's name. The step kernel's tiles are template constants,
so it declares no sweep; its ``OpShard`` runs the distributed ring below
when the op is called with ``mesh=``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ...core.op import OpShard, define_op
from .._build import on_cpu
from .kernel import ring_flash_fwd_builder
from .ops import (RING_BWD_HEAD_DIMS, _attn_defines, _grad_asked,
                  flash_delta, ring_flash_bwd, ring_flash_fwd, route)
from .ref import ring_fwd_ref

__all__ = ["ring_flash_attention", "ring_merge", "ring_flash_op"]

_NEG_INF = float("-inf")


def ring_merge(a, b):
    """Exactly merge two chunk-local softmax partials ``(o, lse)``: the
    logsumexp reweighting, guarded twice so that a partial with lse = -inf
    (a row that saw no key) contributes an exact 0 with clean gradients, no
    ``-inf - -inf`` NaN forward or backward. o is cast to ``o_a``'s dtype
    after the merge, as JAX does."""
    o_a, lse_a = a
    o_b, lse_b = b
    m = torch.maximum(lse_a, lse_b)
    m_s = torch.where(m == _NEG_INF, 0.0, m)
    dead_a, dead_b = lse_a == _NEG_INF, lse_b == _NEG_INF
    ea = torch.where(dead_a, 0.0, torch.exp(torch.where(dead_a, 0.0,
                                                        lse_a - m_s)))
    eb = torch.where(dead_b, 0.0, torch.exp(torch.where(dead_b, 0.0,
                                                        lse_b - m_s)))
    tot = ea + eb
    den = torch.where(tot == 0.0, 1.0, tot)
    o = (o_a.float() * (ea / den)[..., None]
         + o_b.float() * (eb / den)[..., None]).to(o_a.dtype)
    lse = torch.where(tot == 0.0, _NEG_INF, m_s + torch.log(den))
    return o, lse


class _RingStep(torch.autograd.Function):
    """One differentiable ring step ``(o, lse)`` at the given offsets."""

    @staticmethod
    def forward(ctx, q, k, v, q_start, k_start, causal, window, sm_scale,
                prefix_len):
        kw = dict(causal=causal, window=window, sm_scale=sm_scale,
                  prefix_len=prefix_len)
        o, lse = ring_flash_fwd(q, k, v, q_start, k_start, **kw)
        ctx.save_for_backward(q, k, v, o, lse, q_start, k_start)
        ctx.kw = kw
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, g_o, g_lse):
        q, k, v, o, lse, q_start, k_start = ctx.saved_tensors
        do = torch.zeros_like(q) if g_o is None else g_o.to(q.dtype)
        # a cotangent laid out unlike q, k, v must not change the kernel
        # ring_flash_attention promised: a copy reads as well as q does
        if do.stride(-1) != 1 or route(q, k, v, do) != route(q, k, v):
            do = do.contiguous()
        delta = flash_delta(do, o)
        # lse is an output the merge consumes, so its cotangent enters the
        # softmax jacobian: ds = p (dp - delta + g_lse)
        if g_lse is not None:
            delta = delta - g_lse
        dq, dk, dv = ring_flash_bwd(q, k, v, do, lse, delta, q_start,
                                    k_start, **ctx.kw)
        return (dq, dk.to(k.dtype), dv.to(v.dtype), None, None, None, None,
                None, None)


def _offset(value, device):
    return torch.full((1, 1), int(value), dtype=torch.int32, device=device)


def _shard_offsets(i, t, n, sq, skv):
    """(q_start, k_start) of rank i at step t of an n-rank ring with shards
    of sq queries and chunks of skv keys: queries sit at the end of the
    global kv stream and rank i holds chunk (i + t) % n (``_ring_shard_step``
    of the JAX package)."""
    return n * skv - n * sq + i * sq, ((i + t) % n) * skv


def _ring(q, steps, kw):
    """Merge the steps ``(k, v, q_start, k_start)`` yielded by ``steps``."""
    acc = None
    for k, v, qs, ks in steps:
        part = _RingStep.apply(q, k, v, _offset(qs, q.device),
                               _offset(ks, q.device), kw["causal"],
                               kw["window"], kw["sm_scale"],
                               kw["prefix_len"])
        acc = part if acc is None else ring_merge(acc, part)
    return acc[0]


def _shift(group, tensors, step):
    """Send each tensor to the rank ``step`` places on along ``group`` and
    receive its like from the rank ``step`` places back."""
    n, i = dist.get_world_size(group), dist.get_rank(group)
    dst = dist.get_global_rank(group, (i + step) % n)
    src = dist.get_global_rank(group, (i - step) % n)
    sent = [t.contiguous() for t in tensors]
    got = [torch.empty_like(t) for t in sent]
    ops = []
    for s, g in zip(sent, got):
        ops.append(dist.P2POp(dist.isend, s, dst, group))
        ops.append(dist.P2POp(dist.irecv, g, src, group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return got


class _Rotate(torch.autograd.Function):
    """k, v move one rank back along the ring (rank i receives what rank
    i + 1 held); the backward carries their gradients one rank forward."""

    @staticmethod
    def forward(ctx, group, k, v):
        ctx.group = group
        return tuple(_shift(group, (k, v), -1))

    @staticmethod
    def backward(ctx, gk, gv):
        gk, gv = _shift(ctx.group, (gk, gv), 1)
        return None, gk, gv


def _mesh_dim(mesh, mesh_axis):
    names = mesh.mesh_dim_names or ()
    if mesh_axis not in names:
        raise ValueError(f"ring_flash_attention: mesh has no axis "
                         f"{mesh_axis!r} (axes {names})")
    return names.index(mesh_axis)


def _distributed(q, k, v, mesh, mesh_axis, kw):
    dim = _mesh_dim(mesh, mesh_axis)
    n, i = mesh.size(dim), mesh.get_local_rank(dim)
    group = mesh.get_group(dim)
    sq, skv = q.shape[2], k.shape[2]

    def steps():
        kt, vt = k, v
        for t in range(n):
            if t:
                kt, vt = _Rotate.apply(group, kt, vt)
            yield (kt, vt, *_shard_offsets(i, t, n, sq, skv))

    return _ring(q, steps(), kw)


def ring_flash_attention(q, k, v, *, mesh=None, mesh_axis="model",
                         ring_steps=None, causal=True, window=None,
                         sm_scale=None, prefix_len=0):
    """Sequence-parallel ring flash attention, differentiable in both forms.

    With ``mesh`` (a ``DeviceMesh`` whose ``mesh_axis`` holds the ring),
    q (B, H, Sq, D) and k, v (B, Hk, Skv, D) are this rank's sequence
    shards and the result is this rank's o shard; ``ring_steps``, if given,
    must equal the axis size. Without ``mesh`` the same steps and merge run
    in one process over ``ring_steps`` (default 1) chunks of the kv stream,
    which must divide its length. Queries are aligned to the end of the
    global kv stream (the ``flash_attention`` convention). On the card a
    gradient at a head dim that ``ring_flash_bwd`` does not take for these
    inputs (``RING_BWD_HEAD_DIMS``) raises up front;
    the CPU differentiates the plain versions at any head dim."""
    d = q.shape[-1]
    if _grad_asked(q, k, v) and not on_cpu("ring_flash_attention", q, k, v):
        path = route(q, k, v)
        if d not in RING_BWD_HEAD_DIMS[path]:
            raise NotImplementedError(
                f"ring_flash_attention: no backward kernel for head dim {d} "
                f"of {q.dtype} inputs on the card (ring_flash.cu's "
                f"ring_flash_bwd takes head dims {RING_BWD_HEAD_DIMS[path]} "
                f"on its {path!r} route, {RING_BWD_HEAD_DIMS['wgmma']} for "
                "bf16 with 16-byte rows); call it under torch.no_grad()")
    kw = dict(causal=causal, window=window, sm_scale=sm_scale,
              prefix_len=prefix_len)
    if mesh is not None:
        n = mesh.size(_mesh_dim(mesh, mesh_axis))
        if ring_steps is not None and int(ring_steps) != n:
            raise ValueError(
                f"ring_flash_attention: ring_steps={ring_steps} contradicts "
                f"mesh axis {mesh_axis!r} of size {n}")
        return _distributed(q, k, v, mesh, mesh_axis, kw)
    n = 1 if ring_steps is None else int(ring_steps)
    sq, skv = q.shape[2], k.shape[2]
    if n < 1 or skv % n:
        raise ValueError(
            f"ring_flash_attention: ring_steps={n} does not divide the kv "
            f"length {skv}")
    c = skv // n
    return _ring(q, ((k[:, :, t * c:(t + 1) * c], v[:, :, t * c:(t + 1) * c],
                      skv - sq, t * c) for t in range(n)), kw)



# ---------------------------------------------------------------------------
# the op declaration (repro.kernels.flash_attention.ring.ring_flash)
# ---------------------------------------------------------------------------

def _ring_pre(args, params):
    q, k, v = args

    def offset(x):
        if x is None:
            x = 0
        if not torch.is_tensor(x):
            return torch.full((1, 1), int(x), dtype=torch.int32,
                              device=q.device)
        return x.to(torch.int32).reshape(1, 1)

    return q, k, v, offset(params.get("q_start")), \
        offset(params.get("k_start"))


def _ring_defines(args, params):
    """JAX's ``_ring_defines``: the prefill's, plus the ring's extent and
    mesh axis (the spec's ShardAxis)."""
    q, k, v = args[:3]
    return dict(_attn_defines("ring_flash", q, k, v, params),
                ring_steps=int(params["ring_steps"]),
                mesh_axis=str(params["mesh_axis"]))


def _ring_ref(q, k, v, *, q_start=None, k_start=None, **kw):
    """The step's o (its plain version)."""
    return ring_fwd_ref(q, k, v, 0 if q_start is None else q_start,
                        0 if k_start is None else k_start, **kw)[0]


def _ring_example(rng):
    import numpy as np

    q = rng.standard_normal((1, 4, 64, 32)).astype("float32")
    k = rng.standard_normal((1, 2, 64, 32)).astype("float32")
    v = rng.standard_normal((1, 2, 64, 32)).astype("float32")
    # the query shard at positions 32..95 against the chunk at 0..63: part
    # of the chunk lies after some of the queries
    return (q, k, v), dict(q_start=np.full((1, 1), 32, np.int32),
                           k_start=np.zeros((1, 1), np.int32), causal=True)


def _ring_in_specs(axis, args):
    p = (None, None, axis, None)                # q/k/v sharded on seq
    return (p, p, p)


def _ring_out_specs(axis):
    return (None, None, axis, None)


def _ring_run(op, mesh, axis, args, params):
    """The ring op's mesh schedule: the distributed ring over ``axis`` of
    ``mesh`` on this rank's sequence shards of q, k, v."""
    q, k, v = args
    kw = {n: params[n] for n in ("causal", "window", "sm_scale",
                                 "prefix_len") if n in params}
    return ring_flash_attention(q, k, v, mesh=mesh, mesh_axis=axis,
                                ring_steps=params.get("ring_steps"), **kw)


ring_flash_op = define_op(
    "ring_flash",
    builder=ring_flash_fwd_builder,
    ref=_ring_ref,
    derive_defines=_ring_defines,
    pre=_ring_pre,
    public_outputs=1,                        # lse is merge/backward-only
    defaults=dict(causal=True, window=None, sm_scale=None, prefix_len=0,
                  block_q=128, block_kv=128, ring_steps=1,
                  mesh_axis="model"),
    array_params=("q_start", "k_start"),     # dynamic absolute offsets
    ref_params=("q_start", "k_start", "causal", "window", "sm_scale",
                "prefix_len"),
    sources=("ring_flash", "ring_flash_wide"),
    example=_ring_example,
    shard=OpShard(
        mesh_axis="model", collective="ppermute",
        in_specs=_ring_in_specs, out_specs=_ring_out_specs,
        rotate=(1, 2),                       # k, v hop around the ring
        extent_param="ring_steps",           # defines/tune key track shards
        run=_ring_run),
    doc="""One ring step: q (B, H, Sq, D) at absolute positions q_start + i
    against one kv chunk at k_start + j ((1, 1) int32 offsets) -> o,
    normalised by the chunk's own softmax sum (``raw``: (o, lse)). The
    spec declares the ring's mesh binding (``ring_steps`` shards of
    ``mesh_axis``); with ``mesh=`` the op runs the whole distributed ring
    on this rank's sequence shards of q, k and v (``OpShard``).""",
)
