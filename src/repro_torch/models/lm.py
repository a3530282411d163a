"""Decoder LM: the dense and MoE transformer (GQA with rope or sinusoidal
positions, optional sliding window, audio-conditioning or vision prefix
with the prefix-LM mask and gemma's sqrt(d_model) embedding scale, or
MLA), mamba1 and mamba2 stacks, and the zamba2 hybrid (groups of mamba2
layers, each followed by one shared attention block with its own KV cache
per application): the counterpart of ``repro.models.lm``.

Parameters are a plain dict of tensors with the JAX package's tree paths and
shapes: ``embed`` (Vpad, d), ``final_norm`` (d,), ``head`` (d, Vpad) when
untied, and ``stacks`` (one per program entry) whose leaves carry the
stacked ``(n, ...)`` layer axis (a ``zamba_group`` stack's leaves carry
``(n, group, ...)``, and ``shared_attn`` holds the one shared block). The
layer loop is a Python loop over that axis (JAX scans it). Caches are
dicts of tensors too; the decode steps update their cache IN PLACE and
return it (JAX returns a new one). A static cache's ``"pos"`` is a 0-dim
int32 tensor on the model's device, as JAX's is, advanced in place: the
layers place their writes from it on the device, so a decode step reads
nothing back and can be captured into a CUDA graph
(``repro_torch.parallel.build_serve_step``). An eager step still checks
the cache's capacity with one read of it.

Every model runs on the CUDA card unless ``device="cpu"`` is asked for; on
the card the norms, attention and LM head go through the Hopper kernels, on
the CPU through their plain versions.

Training (``loss``) differentiates through the same wrappers: rmsnorm,
flash attention and the fused CE head are ``torch.autograd.Function``s on
both devices, and gradients come from ``torch.autograd.grad`` over the
parameter tree's leaves. ``LM(remat=, ce_chunks=, fused_head=)`` are JAX's
options: rematerialised layers (``torch.utils.checkpoint``), the einsum
head with its pad mask in place of the fused LM-head kernels, and the CE
over sequence chunks with rematerialised logits. A whole train step runs
as one CUDA graph on the card through ``parallel.build_train_step``.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import math

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.lm_head import (lm_head_bwd, lm_head_ce,
                                         lm_head_logits)
from repro_torch.layers import blocks
from repro_torch.layers.common import dense_init, keeping, rmsnorm
from repro_torch.layers.rope import sinusoidal_embedding
from repro_torch.parallel import comm
from repro_torch.parallel.context import (cache_split, copy_to_model,
                                          current_rules, data_sum,
                                          gather_over_model, model_split,
                                          shard_activation, tensor_parallel)
from repro_torch.parallel.steps import Placement, cache_overflow
from repro_torch.tree import leaves, tree_map

__all__ = ["LM", "StackSpec", "build_program", "pad_vocab"]


def pad_vocab(v: int, multiple: int = 256) -> int:
    """Megatron-style vocab padding (as the JAX package pads)."""
    return -(-v // multiple) * multiple


@dataclasses.dataclass(frozen=True)
class StackSpec:
    kind: str           # dense | moe | mamba1 | mamba2 | zamba_group
    n: int
    group: int = 0      # zamba_group: mamba layers per shared-attn application


def build_program(cfg: ArchConfig) -> list[StackSpec]:
    if (cfg.frontend not in ("", "audio_stub", "vision_stub")
            or cfg.pos_embed not in ("rope", "sinusoidal")
            or (cfg.shared_attn_every and cfg.ssm_type != "mamba2")
            or (not cfg.ssm_type and cfg.attn_type not in ("gqa", "mla"))):
        raise NotImplementedError(
            f"{cfg.name}: frontend {cfg.frontend!r}, pos_embed "
            f"{cfg.pos_embed!r}, attn_type {cfg.attn_type!r}, "
            f"shared_attn_every {cfg.shared_attn_every} with ssm_type "
            f"{cfg.ssm_type!r}: no ported program takes this combination")
    if cfg.shared_attn_every:                       # zamba2 hybrid
        g = cfg.shared_attn_every
        ngroups = cfg.n_layers // g
        tail = cfg.n_layers - ngroups * g
        prog = [StackSpec("zamba_group", ngroups, group=g)]
        if tail:
            prog.append(StackSpec("mamba2", tail))
        return prog
    if cfg.ssm_type in ("mamba1", "mamba2"):
        return [StackSpec(cfg.ssm_type, cfg.n_layers)]
    if cfg.n_experts:
        prog = []
        if cfg.first_dense_layers:
            prog.append(StackSpec("dense", cfg.first_dense_layers))
        prog.append(StackSpec("moe", cfg.n_layers - cfg.first_dense_layers))
        return prog
    return [StackSpec("dense", cfg.n_layers)]


_INIT = {"dense": blocks.tblock_init,
         "moe": functools.partial(blocks.tblock_init, moe=True),
         "mamba1": blocks.mamba_block_init,
         "mamba2": blocks.mamba_block_init}
_MAMBA = ("mamba1", "mamba2")


def _layer(tree, i):
    """Layer ``i`` of a stacked tree (views: in-place writes reach it)."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _unstack(tree, n):
    """The ``n`` layers of a stacked tree, each leaf unbound once: autograd
    then stacks the layers' gradients in one pass instead of adding ``n``
    dense zero-padded copies."""
    parts = {k: (_unstack(v, n) if isinstance(v, dict) else torch.unbind(v))
             for k, v in tree.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def _stack(trees):
    first = trees[0]
    return {k: (_stack([t[k] for t in trees]) if isinstance(v, dict)
                else torch.stack([t[k] for t in trees]))
            for k, v in first.items()}


def _regroup(tree, n, group):
    """A stack of ``n * group`` layers as ``n`` groups: leaves (n, group,
    ...), views of the same storage."""
    return {k: (_regroup(v, n, group) if isinstance(v, dict)
                else v.view(n, group, *v.shape[1:]))
            for k, v in tree.items()}


def _capturing(t) -> bool:
    """True while ``t``'s stream is being captured into a CUDA graph
    (nothing runs then, so nothing may be read back)."""
    return t.is_cuda and torch.cuda.is_current_stream_capturing()


# remat="dots": the outputs of 2-D products (the projections' matmuls) are
# kept, everything else (batched products such as the experts' einsums, the
# hand-written kernels, elementwise work) is recomputed in the backward: the
# counterpart of JAX's ``dots_with_no_batch_dims_saveable``
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_context():
    return create_selective_checkpoint_contexts(_dots_policy)


def _zeros(lead, single, device):
    """A stacked cache of ``single``'s (meta) leaves with leading axes
    ``lead``: zeros, except a rolling window's slot positions, -1."""
    return {k: (torch.full((*lead, *v.shape), -1, dtype=v.dtype,
                           device=device)
                if k == "slot_pos" else
                torch.zeros((*lead, *v.shape), dtype=v.dtype, device=device))
            for k, v in single.items()}


def _global_mean(x, count=None):
    """``x.mean()``, or ``x / count`` for a sum over ``count`` terms, over
    the global batch: under data parallelism the sum over the data axes
    over the global count (every rank then holds the global value)."""
    r = current_rules()
    n = r.data_size if r is not None and r.mesh is not None else 1
    if n == 1:
        return x.mean() if count is None else x / count
    total = data_sum(x.sum() if count is None else x)
    return total / ((x.numel() if count is None else count) * n)


class _ShardedCE(torch.autograd.Function):
    """The fused CE over a vocab-sharded head: each rank's (lse, gold) on
    its shard (``lm_head_ce.raw``; labels shifted to the shard, those
    outside it matching no column, gold 0), combined over "model" as a
    logsumexp of the lses and a sum of the golds. The backward runs
    ``lm_head_bwd`` on the shard with the global lse: dw is this rank's
    shard, dx a partial sum (the caller's ``shard_activation`` sums it)."""

    @staticmethod
    def forward(ctx, x, w, labels, vocab, group):
        lse_l, gold_l = lm_head_ce.raw(x, w, labels, vocab=vocab)
        top = comm.all_reduce(lse_l, "max", group)
        lse = top + torch.log(comm.all_reduce(torch.exp(lse_l - top), "sum",
                                              group))
        gold = comm.all_reduce(gold_l, "sum", group)
        ctx.save_for_backward(x, w, labels, lse)
        ctx.vocab = vocab
        return (lse - gold)[:, 0]

    @staticmethod
    def backward(ctx, g):
        x, w, labels, lse = ctx.saved_tensors
        dx, dw = lm_head_bwd(x, w, labels, lse,
                             g.float().reshape(-1, 1).contiguous(),
                             vocab=ctx.vocab)
        return dx.to(x.dtype), dw.to(w.dtype), None, None, None


class LM:
    """The decoder LM of ``cfg`` on ``device`` (the card unless "cpu").

    - ``moe_dispatch``: "einsum" (JAX's default) or "gather" for MoE
      layers.
    - ``remat``: "none", "full" (each layer, or each zamba group with its
      shared block, recomputed in the backward) or "dots" (only the 2-D
      products' outputs kept), as JAX's; it changes what is kept and what
      is launched twice, never a value.
    - ``fused_head``: True routes the head through the LM-head kernels
      (``lm_head_ce`` for the loss, ``lm_head_logits`` with its argmax for
      logits and greedy steps); False is JAX's einsum head, an f32 product
      plus a -1e30 mask on the padded vocab, differentiable.
    - ``ce_chunks``: with the einsum head, the loss's CE over this many
      sequence chunks (reduced until it divides the sequence), each
      chunk's logits recomputed in the backward.

    JAX's ``scan_layers`` (the dry run's unrolled cost model) and
    ``head_backend`` (the kernel language's expansion) have no counterpart
    here: the layer loop is always Python's and the head's kernels are the
    hand-written ones."""

    def __init__(self, cfg: ArchConfig, *, device=None,
                 moe_dispatch: str = "einsum", remat: str = "none",
                 ce_chunks: int = 1, fused_head: bool = True):
        if moe_dispatch not in ("einsum", "gather"):
            raise ValueError(f"moe_dispatch must be einsum|gather, got "
                             f"{moe_dispatch!r}")
        if remat not in ("none", "full", "dots"):
            raise ValueError(f"remat must be none|full|dots, got {remat!r}")
        if ce_chunks < 1:
            raise ValueError(f"ce_chunks must be >= 1, got {ce_chunks}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = getattr(torch, cfg.dtype)
        self.program = build_program(cfg)
        self.vpad = pad_vocab(cfg.vocab_size)
        self.moe_dispatch = moe_dispatch
        self.remat = remat
        self.ce_chunks = ce_chunks
        self.fused_head = fused_head
        # gemma's sqrt(d_model), rounded to the embedding's dtype first as
        # JAX rounds a Python scalar against a bf16 array (45.25 at d 2048);
        # the product is then rounded once, as JAX's bf16 multiply does
        self.embed_scale = (float(torch.tensor(math.sqrt(cfg.d_model),
                                               dtype=self.dtype))
                            if cfg.embed_scale else None)

    # ------------------------------------------------------------------ init
    def init(self, gen: torch.Generator, placements=None):
        """Random parameters drawn from ``gen`` (a generator on the model's
        device), with the JAX package's names and shapes.

        ``placements`` (a tree of ``parallel.Placement``, e.g.
        ``make_shardings``' first): this rank's shards of the same draws.
        Each leaf is drawn whole in the one-rank order and cut to its shard
        at once, so the shards are slices of the one-rank weights and a
        rank never holds more than one whole large leaf (the other leaves,
        norms and biases, are cut when the tree is done)."""
        if placements is None:
            return self._init(gen)
        order = iter(self._draw_order(placements))
        kept = set()

        def keep(t):
            # the leaf as drawn may carry its stack dims otherwise (a zamba
            # group's (n * group, ...), the shared block's (1, ...)): its
            # base dims, the last ones, take the leaf's spec
            p = next(order)
            k = min(len(p.spec), t.dim())
            spec = (None,) * (t.dim() - k) + tuple(p.spec[len(p.spec) - k:])
            out = Placement(p.mesh, spec).local(t)
            kept.add(id(out))
            return out

        with keeping(keep):
            tree = self._init(gen)

        def cut(t, p):
            return t if id(t) in kept or id(t._base) in kept else p.local(t)
        return tree_map(cut, tree, placements)

    def _draw_order(self, placements):
        """The placement of the leaf each :func:`dense_init` call of the
        init makes, in call order (a dry run on meta tensors; a stacked
        group's leaf is a view of the drawn tensor)."""
        meta = copy.copy(self)
        meta.device = torch.device("meta")
        drawn = []

        def tag(t):
            t.draw_index = len(drawn)
            drawn.append(t)
            return t

        with keeping(tag):
            shapes = meta._init(torch.Generator())
        order = [None] * len(drawn)
        for t, p in zip(leaves(shapes), leaves(placements)):
            src = t if hasattr(t, "draw_index") else t._base
            if src is not None and hasattr(src, "draw_index"):
                order[src.draw_index] = p
        return order

    def _init(self, gen):
        cfg, dtype, dev = self.cfg, self.dtype, self.device
        params = {
            "embed": dense_init(gen, (self.vpad, cfg.d_model), dtype, dev,
                                scale=cfg.d_model ** -0.5),
            "final_norm": torch.ones((cfg.d_model,), dtype=torch.float32,
                                     device=dev),
        }
        if not cfg.tie_embeddings:
            params["head"] = dense_init(gen, (cfg.d_model, self.vpad), dtype,
                                        dev)
        if cfg.shared_attn_every:
            params["shared_attn"] = _layer(
                blocks.tblock_init(gen, cfg, dtype, dev, n=1), 0)
        params["stacks"] = [
            _regroup(blocks.mamba_block_init(gen, cfg, dtype, dev,
                                             n=s.n * s.group), s.n, s.group)
            if s.kind == "zamba_group" else
            _INIT[s.kind](gen, cfg, dtype, dev, n=s.n)
            for s in self.program]
        return params

    def param_count(self, params) -> int:
        def count(t):
            if isinstance(t, dict):
                return sum(count(v) for v in t.values())
            if isinstance(t, list):
                return sum(count(v) for v in t)
            return t.numel()
        return count(params)

    def active_param_count(self, params) -> int:
        """Parameters touched per token (MoE: only top-k experts count)."""
        cfg = self.cfg
        total = self.param_count(params)
        if not cfg.n_experts:
            return total
        stack = params["stacks"][-1]
        expert_params = sum(stack["moe"][k].numel()
                            for k in ("w_gate", "w_up", "w_down"))
        inactive = expert_params * (1 - cfg.n_experts_per_tok / cfg.n_experts)
        return int(total - inactive)

    def _group_params(self, gp, group):
        """One zamba group's mamba2 leaves (group, ...) as its layers read
        them. JAX's rules peel a stacked leaf's dims until a rule of its
        name fits, so a group's ``A_log`` (n, group, H) takes the 2-D rule
        of mamba1's (d_inner, N) and splits the GROUP dim where it divides
        the axis (or stays replicated), while each layer's mamba2 rule
        splits its H heads. The group's leaf is gathered whole (the
        backward sums the ranks' gradients and keeps this rank's layers) and
        each layer takes its heads from it: the layers follow their own
        leaf's rule."""
        a = gp["mixer"]["A_log"]
        h = self.cfg.resolved_d_inner // self.cfg.ssm_head_dim
        whole = model_split("A_log", (group, h), a)
        per_layer = model_split("A_log", (h,))
        if whole is None and per_layer is None:
            return gp
        if whole is not None:
            a = gather_over_model(a, whole.dim)
        else:                    # replicated, entering this rank's heads
            a = copy_to_model(a)
        if per_layer is not None:
            a = a.narrow(1, per_layer.lo, per_layer.width)
        return dict(gp, mixer=dict(gp["mixer"], A_log=a))

    def _block_kw(self, spec):
        """The transformer block's MoE arguments for a stack of ``spec``."""
        return dict(moe=spec.kind == "moe", dispatch=self.moe_dispatch)

    # ----------------------------------------------------------- embed/head
    def _embed(self, params, tokens, prefix_embeddings=None, pos0=0):
        """Token embeddings (times sqrt(d_model) with ``cfg.embed_scale``),
        after ``prefix_embeddings`` (B, P, d) when given (the frontend stub's
        conditioning frames or image patches, unscaled), plus sinusoidal
        positions from ``pos0`` (an int, or the cache's 0-dim device
        position) when the config asks for them. Where ``embed`` is split
        by vocab, each rank looks up the tokens of its shard (zeros for the
        others) and the rows are summed over "model"; the prefix enters
        replicated beside them."""
        vs = self._vocab_shard(params, "embed")
        if vs is None:
            x = params["embed"][tokens.long()]
        else:
            off, width, _ = vs
            t = tokens.long() - off
            hit = ((t >= 0) & (t < width)).to(params["embed"].dtype)
            x = params["embed"][t.clamp(0, width - 1)] * hit[..., None]
        if self.embed_scale is not None:
            x = x * self.embed_scale
        if vs is not None:
            x = shard_activation(x, "act_btd", partial=True)
        if prefix_embeddings is not None:
            x = torch.cat([prefix_embeddings.to(x.dtype), x], dim=1)
        if self.cfg.pos_embed == "sinusoidal":
            pos = sinusoidal_embedding(
                pos0 + torch.arange(x.shape[1], device=x.device),
                self.cfg.d_model)
            x = x + pos[None].to(x.dtype)
        return x

    def _prefix_len(self, prefix_embeddings):
        """The prefix every query sees (the prefix-LM mask): P when prefix
        embeddings are given and ``cfg.prefix_lm`` is set, else 0."""
        if prefix_embeddings is None or not self.cfg.prefix_lm:
            return 0
        return prefix_embeddings.shape[1]

    def _head(self, params):
        """The (d_model, Vpad) head matrix: for tied embeddings the view
        ``embed.T`` (the LM-head kernel reads it in place). Where it is
        split by vocab, this rank's (d_model, Vpad / n) shard."""
        return (params["embed"].T if self.cfg.tie_embeddings
                else params["head"])

    def _head_leaf(self):
        return "embed" if self.cfg.tie_embeddings else "head"

    def _vocab_shard(self, params, leaf=None):
        """(first column, padded width, true columns) of this rank's vocab
        shard of ``leaf`` ("embed", or "head": the head's leaf, the
        embedding where tied) where its spec splits it over "model"
        (``model_split``), else None (``make_shardings`` refuses a mesh
        whose last shard holds no true column)."""
        leaf = leaf or self._head_leaf()
        d, v = self.cfg.d_model, self.vpad
        full = (v, d) if leaf == "embed" else (d, v)
        sp = model_split(leaf, full, params[leaf])
        if sp is None:
            return None
        return sp.lo, sp.width, min(self.cfg.vocab_size - sp.lo, sp.width)

    def _logits(self, params, x):
        """(B, S, Vpad) f32 logits of the hidden states ``x``: the fused
        LM-head kernel, or with ``fused_head=False`` JAX's einsum head, the
        product in f32 (of the operands' values: bf16 products are exact in
        f32) with the padded vocab masked to -1e30, differentiable (on one
        rank). Under tensor parallelism each rank computes its vocab
        shard's columns and the shards are gathered (exactly)."""
        vs = self._vocab_shard(params)
        if vs is not None:
            with torch.no_grad():
                return comm.all_gather(self._local_logits(params, x), -1,
                                       tensor_parallel()[0])
        return self._local_logits(params, x)

    def _local_logits(self, params, x):
        b, s, d = x.shape
        head = self._head(params)
        vs = self._vocab_shard(params)
        vocab = self.cfg.vocab_size if vs is None else vs[2]
        width = head.shape[1]
        if not self.fused_head:
            logits = torch.matmul(x.float(), head.float())
            pad = torch.arange(width, device=x.device) >= vocab
            return logits + torch.where(pad, -1e30, 0.0)
        logits = lm_head_logits(x.reshape(b * s, d), head.to(x.dtype),
                                vocab=vocab)
        return logits.reshape(b, s, width)

    def _greedy_head(self, params, x):
        """(next (B,), logits) of the final hidden states x (B, 1, d): the
        argmax out of the fused LM-head pass. Under tensor parallelism the
        ranks' row maxima and argmaxes combine into the global argmax (ties
        to the lowest column, as ``torch.argmax``) and the logits are this
        rank's vocab shard (B, Vpad / n): the 128k columns are not
        gathered."""
        if not self.fused_head:
            logits = self._logits(params, x)[:, 0]
            return self.greedy_token(logits), logits
        b, _, d = x.shape
        vs = self._vocab_shard(params)
        logits, m, arg = lm_head_logits.raw(
            x.reshape(b, d), self._head(params).to(x.dtype),
            vocab=self.cfg.vocab_size if vs is None else vs[2])
        if vs is None:
            return arg[:, 0], logits
        _, nxt = comm.argmax_combine(m, arg, vs[0], tensor_parallel()[0])
        return nxt[:, 0], logits

    # ------------------------------------------------------------- training
    def _wrap_remat(self, body):
        """``body`` as the unit ``remat`` recomputes in the backward: itself
        with "none", else a non-reentrant checkpoint of it (with "dots" a
        selective one that keeps the 2-D products' outputs). The model
        draws no random numbers, so no RNG state is kept (nor read, which
        a CUDA graph's capture would refuse)."""
        if self.remat == "none":
            return body
        kw = {"context_fn": _dots_context} if self.remat == "dots" else {}

        def unit(*args):
            return checkpoint(body, *args, use_reentrant=False,
                              preserve_rng_state=False, **kw)
        return unit

    def _stack_body(self, params, spec, prefix_len):
        """``body(x, layer_params) -> (x, aux or None)`` for one unit of a
        stack of ``spec``, the unit JAX's scan body holds: a layer, or a
        zamba group (its mamba2 layers, then the shared block)."""
        cfg = self.cfg
        if spec.kind == "zamba_group":
            def body(x, gp):
                for lp in _unstack(self._group_params(gp, spec.group),
                                   spec.group):
                    x = blocks.mamba_block_forward(lp, x, cfg)
                return blocks.tblock_forward(params["shared_attn"], x, cfg)
        elif spec.kind in _MAMBA:
            def body(x, lp):
                return blocks.mamba_block_forward(lp, x, cfg), None
        else:
            def body(x, lp):
                return blocks.tblock_forward(lp, x, cfg,
                                             prefix_len=prefix_len,
                                             **self._block_kw(spec))
        return body

    def _hidden_states(self, params, tokens, prefix_embeddings=None):
        """Embed -> layer stacks -> final norm: the shared forward trunk.
        Returns (hidden (B, P + S, d), aux (2,) f32): the MoE layers'
        [moe_lb_loss, moe_z_loss] summed over the layers (zero without
        MoE layers). The aux losses leave each rematerialised unit as its
        outputs, as in JAX."""
        cfg = self.cfg
        x = self._embed(params, tokens, prefix_embeddings)
        prefix_len = self._prefix_len(prefix_embeddings)
        aux = torch.zeros((2,), dtype=torch.float32, device=x.device)
        for spec, sp in zip(self.program, params["stacks"]):
            body = self._wrap_remat(self._stack_body(params, spec,
                                                     prefix_len))
            for lp in _unstack(sp, spec.n):
                x, a = body(x, lp)
                if a is not None:
                    aux = aux + a
        return rmsnorm(x, params["final_norm"], eps=cfg.norm_eps), aux

    def forward(self, params, tokens, prefix_embeddings=None):
        """Full-sequence forward: (logits (B, P + S, Vpad) f32, aux). The
        LM-head kernel has no backward, so the logits carry no gradient
        (``loss`` differentiates either head)."""
        x, aux = self._hidden_states(params, tokens, prefix_embeddings)
        with torch.no_grad():
            return self._logits(params, x), aux

    def _fused_ce(self, params, x, labels):
        """Mean NLL through ``lm_head_ce``: the (B*S, Vpad) logits are never
        kept, forward or backward. Under tensor parallelism each rank runs
        the kernels on its vocab shard (labels outside it match no column)
        and the ranks' (lse, gold) combine (``_ShardedCE``). Under data
        parallelism the mean is the global sum over the global count."""
        b, s, d = x.shape
        head = self._head(params).to(x.dtype)
        lab = labels.reshape(b * s, 1).to(torch.int32)
        vs = self._vocab_shard(params)
        if vs is None:
            nll = lm_head_ce(x.reshape(b * s, d), head, lab.contiguous(),
                             vocab=self.cfg.vocab_size)
        else:
            xs = shard_activation(x.reshape(b * s, d), "act_btd")
            nll = _ShardedCE.apply(xs, head, (lab - vs[0]).contiguous(),
                                   vs[2], tensor_parallel()[0])
        return _global_mean(nll)

    def _nll_sum(self, params, x, labels):
        """Summed NLL of ``labels`` under the einsum head's logits of
        ``x``."""
        logits = self._logits(params, x)
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
        return torch.sum(logz - gold)

    def _ce_from_hidden(self, params, x, labels):
        """Mean NLL of the einsum head over ``ce_chunks`` sequence chunks
        (reduced until it divides S), each chunk's (B, S / k, Vpad) logits
        recomputed in the backward, so no full-sequence logits stay live:
        JAX's ``_ce_from_hidden``."""
        b, s, _ = x.shape
        k = self.ce_chunks
        while s % k:
            k -= 1
        total = 0.0
        for xc, lc in zip(x.chunk(k, dim=1), labels.chunk(k, dim=1)):
            total = total + checkpoint(
                functools.partial(self._nll_sum, params), xc, lc,
                use_reentrant=False, preserve_rng_state=False)
        return _global_mean(total, b * s)

    def _check_labels(self, labels):
        """Labels >= vocab_size index padded-vocab columns, which the kernel
        excludes, so training would silently optimize against nothing.
        Raise on the host (one read of the labels' min and max), except
        while the labels' stream is captured into a CUDA graph (nothing
        runs then; JAX likewise skips traced labels): the train loop checks
        each host batch before it is copied in."""
        if labels.numel() == 0 or _capturing(labels):
            return
        lo, hi = int(labels.min()), int(labels.max())
        if lo < 0 or hi >= self.cfg.vocab_size:
            raise ValueError(
                f"labels out of range [{lo}, {hi}] for vocab_size="
                f"{self.cfg.vocab_size} (vpad={self.vpad}): CE would "
                "silently train on padded-vocab logits; clean the batch")

    def loss(self, params, batch):
        """Next-token CE of ``batch["tokens"]`` (B, S) after the optional
        ``batch["prefix_embeddings"]`` (B, P, d): (total, {"ce", "moe_lb",
        "moe_z"}), total = ce + (0.02 moe_lb + 1e-3 moe_z) / layers (== ce
        without MoE layers)."""
        tokens = batch["tokens"]
        prefix = batch.get("prefix_embeddings")
        p = prefix.shape[1] if prefix is not None else 0
        labels = tokens[:, 1:]
        self._check_labels(labels)
        x, aux = self._hidden_states(params, tokens, prefix)
        pred_x = x[:, p:-1] if x.shape[1] > p + 1 else x[:, p:]
        if not self.fused_head and tensor_parallel() is not None:
            raise NotImplementedError(
                "LM.loss: tensor parallelism trains through the fused head "
                "(fused_head=True); the einsum head's loss is one-rank")
        if self.fused_head:
            ce = self._fused_ce(params, pred_x, labels)
        elif self.ce_chunks > 1:
            ce = self._ce_from_hidden(params, pred_x, labels)
        else:
            ce = _global_mean(self._nll_sum(params, pred_x, labels),
                              labels.numel())
        lb, z = aux[0], aux[1]
        nl = max(sum(s.n * max(s.group, 1) for s in self.program), 1)
        total = ce + (0.02 * lb + 1e-3 * z) / nl
        return total, {"ce": ce, "moe_lb": lb, "moe_z": z}

    # ---------------------------------------------------------------- cache
    def init_cache(self, batch, max_len, dtype=None):
        """Empty static caches for ``batch`` sequences of up to ``max_len``
        tokens: per stack, k/v (n, B, Hk, m, hd) (m = min(max_len, window)
        for a rolling window, with slot_pos (n, m)), MLA's latent ckv
        (n, B, m, lora) and krope (n, B, m, rope), or the mamba conv tail
        (n, B, K-1, C) and state (n, B, di, N) (mamba1) or (n, B, H, P, N)
        (mamba2) f32; a zamba group stack {"mamba": those leaves with
        (n, group, ...), "attn": the shared block's k/v, one per
        application (n, ...)}. Under tensor parallelism each leaf is this
        rank's shard in the ambient rules' cache layout (``Rules.cache``:
        kv heads, head dim or sequence; MLA's lora columns; mamba's
        channels)."""
        cfg, dev = self.cfg, self.device
        dtype = dtype or self.dtype
        stacks = []
        def ssm():
            return blocks.mamba_block_cache_init(cfg, batch, dtype, "meta")

        def att():
            return blocks.tblock_cache_init(cfg, batch, max_len, dtype, "meta")

        for spec in self.program:
            if spec.kind == "zamba_group":
                stacks.append({"mamba": _zeros((spec.n, spec.group), ssm(),
                                               dev),
                               "attn": _zeros((spec.n,), att(), dev)})
            else:
                stacks.append(_zeros((spec.n,), ssm() if spec.kind in _MAMBA
                                     else att(), dev))
        return {"pos": torch.zeros((), dtype=torch.int32, device=dev),
                "stacks": stacks}

    @property
    def has_positional_cache(self) -> bool:
        """True when decode positions are bounded by the cache's max_len:
        attention stacks without a rolling window (rolling caches rotate and
        never overflow; SSM stacks carry O(1) state)."""
        return (not self.cfg.window
                and any(s.kind in ("dense", "moe", "zamba_group")
                        for s in self.program))

    def cache_capacity(self, cache) -> int | None:
        """Token positions the attention caches can hold, or None when
        unbounded (rolling-window or attention-free programs). Stacked
        leaves: ckv (n, B, m, lora), k (n, B, Hk, m, hd)."""
        if not self.has_positional_cache:
            return None
        caps = []
        for spec, sc in zip(self.program, cache["stacks"]):
            if spec.kind == "zamba_group":
                sc = sc["attn"]
            elif spec.kind not in ("dense", "moe"):
                continue
            if "ckv" in sc:
                caps.append(sc["ckv"].shape[2])
                continue
            # a cache split by sequence holds m / n slots a rank
            sp = cache_split("k", tuple(sc["k"].shape[1:]), local=True)
            caps.append(sp.size if sp is not None and sp.dim == 2
                        else sc["k"].shape[3])
        return min(caps) if caps else None

    # -------------------------------------------------------------- prefill
    def prefill(self, params, tokens, prefix_embeddings=None, max_len=None):
        """tokens (B, S) after optional ``prefix_embeddings`` (B, P, d) ->
        (last-token logits (B, Vpad) f32, cache): per stack a contiguous
        cache k/v (n, B, Hk, m, hd) of m = max_len slots (a rolling window's
        m = min(max_len, window), with slot_pos), or the mamba conv tail and
        final state; MLA's latent ckv/krope (n, B, m, .) of m = max_len
        slots. ``cache["pos"]`` = P + S, a 0-dim int32 tensor on the
        model's device."""
        cfg = self.cfg
        x = self._embed(params, tokens, prefix_embeddings)
        s = x.shape[1]
        max_len = max_len or s
        if self.has_positional_cache and s > max_len:
            raise ValueError(
                f"kv cache overflow: prefilling {s} tokens into a cache of "
                f"max_len={max_len}; decode would attend truncated history, "
                "raise max_len")
        prefix_len = self._prefix_len(prefix_embeddings)
        caches = []
        for spec, sp in zip(self.program, params["stacks"]):
            if spec.kind == "zamba_group":
                x, c = self._zamba_prefill(params, sp, spec, x, max_len)
                caches.append(c)
                continue
            layer_caches = []
            for i in range(spec.n):
                if spec.kind in _MAMBA:
                    x, c = blocks.mamba_block_prefill(_layer(sp, i), x, cfg)
                else:
                    x, c = blocks.tblock_prefill(_layer(sp, i), x, cfg,
                                                 max_len=max_len,
                                                 prefix_len=prefix_len,
                                                 **self._block_kw(spec))
                layer_caches.append(c)
            caches.append(_stack(layer_caches))
        x = rmsnorm(x, params["final_norm"], eps=cfg.norm_eps)
        logits = self._logits(params, x[:, -1:])[:, 0]
        pos = torch.full((), s, dtype=torch.int32, device=x.device)
        return logits, {"pos": pos, "stacks": caches}

    def _zamba_prefill(self, params, sp, spec, x, max_len):
        """A zamba group stack's prefill: each group's mamba2 layers, then
        the shared block with a fresh KV cache of ``max_len`` slots.
        Returns (x, {"mamba": (n, group, ...) leaves, "attn": (n, ...)})."""
        cfg = self.cfg
        mamba, attn = [], []
        for i in range(spec.n):
            gp, group = self._group_params(_layer(sp, i), spec.group), []
            for j in range(spec.group):
                x, c = blocks.mamba_block_prefill(_layer(gp, j), x, cfg)
                group.append(c)
            mamba.append(_stack(group))
            x, c = blocks.tblock_prefill(params["shared_attn"], x, cfg,
                                         max_len=max_len)
            attn.append(c)
        return x, {"mamba": _stack(mamba), "attn": _stack(attn)}

    def greedy_token(self, logits):
        return torch.argmax(logits[..., :self.cfg.vocab_size], dim=-1)

    # ------------------------------------------------------- static decoding
    def _decode_hidden(self, params, tokens, cache, split=None):
        """One decode step up to the final norm: tokens (B, 1) -> hidden
        (B, 1, d); ``cache`` is updated in place and its ``pos`` advanced
        in place. ``split``: ``flash_decode``'s split length in every
        attention layer (None: its rule). Decoding past a positional cache is an error, not a
        silent overwrite of the last slot: checked here with one read of
        ``pos`` unless the step is being captured into a CUDA graph (as JAX
        checks only a concrete ``pos``), where the compiled step counts
        positions on the host instead."""
        cfg = self.cfg
        pos = cache["pos"]
        cap = self.cache_capacity(cache)
        if cap is not None and not _capturing(pos) and int(pos) >= cap:
            raise cache_overflow(int(pos), cap)
        x = self._embed(params, tokens, pos0=pos)
        for spec, sp, sc in zip(self.program, params["stacks"],
                                cache["stacks"]):
            if spec.kind == "zamba_group":
                for i in range(spec.n):
                    gp = self._group_params(_layer(sp, i), spec.group)
                    gc = _layer(sc["mamba"], i)
                    for j in range(spec.group):
                        x, _ = blocks.mamba_block_decode(
                            _layer(gp, j), x, _layer(gc, j), cfg)
                    x, _ = blocks.tblock_decode(params["shared_attn"], x,
                                                _layer(sc["attn"], i), cfg,
                                                pos=pos, split=split)
                continue
            for i in range(spec.n):
                if spec.kind in _MAMBA:
                    x, _ = blocks.mamba_block_decode(_layer(sp, i), x,
                                                     _layer(sc, i), cfg)
                else:
                    x, _ = blocks.tblock_decode(_layer(sp, i), x,
                                                _layer(sc, i), cfg, pos=pos,
                                                split=split,
                                                **self._block_kw(spec))
        pos.add_(1)
        return rmsnorm(x, params["final_norm"], eps=cfg.norm_eps), cache

    def decode_step(self, params, tokens, cache, *, split=None):
        """One token for every sequence. tokens: (B, 1). Returns (logits
        (B, Vpad) f32, cache). ``split``: decode attention's split length
        (a tune winner; None: the kernel's rule)."""
        x, cache = self._decode_hidden(params, tokens, cache, split)
        return self._logits(params, x)[:, 0], cache

    def greedy_step(self, params, tokens, cache, *, split=None):
        """One greedy decode step: tokens (B, 1) -> (next (B,), logits
        (B, Vpad) f32, cache); the argmax comes out of the fused LM-head
        pass, or with ``fused_head=False`` from ``greedy_token``.
        ``split`` as :meth:`decode_step`'s. Under tensor parallelism the
        fused head's logits are this rank's vocab shard (``_greedy_head``)."""
        x, cache = self._decode_hidden(params, tokens, cache, split)
        nxt, logits = self._greedy_head(params, x)
        return nxt, logits, cache

    # -------------------------------------------------------- paged decoding
    @property
    def pageable(self) -> bool:
        """True when the program can decode against a paged KV pool: dense
        or MoE GQA stacks with rope positions and no rolling window."""
        cfg = self.cfg
        return (all(s.kind in ("dense", "moe") for s in self.program)
                and cfg.attn_type != "mla" and not cfg.window
                and cfg.pos_embed == "rope")

    def init_paged_cache(self, batch, num_pages, page_size, nseq_pages,
                         dtype=None):
        """Per-layer KV pools of ``num_pages`` pages of ``page_size`` tokens
        shared by ``batch`` slots, in ``dtype`` (default the model's), plus
        per-slot block tables, lengths and the pool-wide slot -> position
        map. Page 0 is the NULL page (idle slots point at it; its positions
        stay -1). Under tensor parallelism the pools hold this rank's kv
        heads, or all of them where the ambient cache layout replicates
        them."""
        if not self.pageable:
            raise ValueError(
                "paged decode needs an attention-only GQA program with rope "
                f"positions and no rolling window (attn_type="
                f"{self.cfg.attn_type}, window={self.cfg.window})")
        dev = self.device

        def stacked(n, single):
            return {k: torch.zeros((n, *v.shape), dtype=v.dtype, device=dev)
                    for k, v in single.items()}

        cfg = self.cfg
        stacks = [stacked(s.n, blocks.tblock_paged_cache_init(
                      cfg, num_pages, page_size, dtype or self.dtype, "meta"))
                  for s in self.program]
        i32 = torch.int32
        return {"table": torch.zeros((batch, nseq_pages), dtype=i32,
                                     device=dev),
                "len": torch.zeros((batch,), dtype=i32, device=dev),
                "pos_pages": torch.full((num_pages, page_size), -1,
                                        dtype=i32, device=dev),
                "stacks": stacks}

    def _paged_decode_hidden(self, params, tokens, cache, split=None):
        """One paged decode step up to the final norm; updates ``cache`` in
        place. Every slot decodes every step: idle slots carry len 0 and a
        zero block table, writing into and reading from the null page.
        ``split``: paged decode's split length (None: its rule)."""
        cfg = self.cfg
        table, lens = cache["table"], cache["len"]
        pos_pages = cache["pos_pages"]
        b, nsp = table.shape
        pg = pos_pages.shape[1]
        # pool coordinates of this step's KV write, shared by every layer
        rows = torch.arange(b, device=table.device)
        page_ids = table[rows, torch.clamp(lens // pg, 0, nsp - 1).long()]
        page_ids = page_ids.long()
        offs = (lens % pg).long()
        # stamp the new positions; the null page is pinned to -1 so idle
        # slots' writes never masquerade as valid history
        pos_pages[page_ids, offs] = lens
        pos_pages[0] = -1
        x = self._embed(params, tokens)
        for spec, sp, sc in zip(self.program, params["stacks"],
                                cache["stacks"]):
            for i in range(spec.n):
                x, _ = blocks.tblock_paged_decode(
                    _layer(sp, i), x, _layer(sc, i), cfg, table=table,
                    lens=lens, pos_pages=pos_pages, page_ids=page_ids,
                    offs=offs, split=split, **self._block_kw(spec))
        x = rmsnorm(x, params["final_norm"], eps=cfg.norm_eps)
        lens += 1
        return x, cache

    def paged_decode_step(self, params, tokens, cache, *, split=None):
        """One paged token for every slot. tokens: (B, 1). Returns (logits
        (B, Vpad) f32, cache). ``split``: paged decode attention's split
        length (a tune winner; None: the kernel's rule)."""
        x, cache = self._paged_decode_hidden(params, tokens, cache, split)
        return self._logits(params, x)[:, 0], cache

    def paged_greedy_step(self, params, tokens, cache, *, split=None):
        """One paged greedy token for every slot. tokens: (B, 1). Returns
        (next (B,), logits (B, Vpad) f32, cache); the argmax comes out of
        the fused LM-head pass, or with ``fused_head=False`` from
        ``greedy_token``. ``split`` as :meth:`paged_decode_step`'s. Under
        tensor parallelism the fused head's logits are this rank's vocab
        shard (``_greedy_head``)."""
        x, cache = self._paged_decode_hidden(params, tokens, cache, split)
        nxt, logits = self._greedy_head(params, x)
        return nxt, logits, cache
