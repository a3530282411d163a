"""Tune probes and winner adoption for the launchers and ``tune_cli`` (the
counterpart of ``repro.launch.tuning``).

One place derives the op shapes a workload meets, as ``{op name: (args,
params)}`` probes: serving (the prefill's attention, the static path's
decode, the engine's paged decode, the decode head at ``batch`` rows) and
training (causal attention at the train sequence, the CE head at ``B (S -
1)`` rows). Probe tensors are meta tensors (shapes and dtypes, no memory),
except the paged probe's block table, lengths and positions, which are
real and small. One place (:func:`adopt`) looks up the persisted
``op.tune`` winners of those probes: a pure cache lookup that builds,
launches and times nothing, and sets nothing. The caller passes what it
adopts to the launches it builds.

Consumers: ``serving.Engine`` (at construction: the paged split goes to
its step builder, whose CUDA graph keeps it), ``launch.serve.generate``
(the static loop's ``flash_decode`` split) and ``apply_tuned_winners``,
``launch.train.TrainLoop`` and ``apply_tuned_winners``, and ``tune_cli``
(which makes the probes real and runs the sweeps). :func:`mesh_probes`
gives the ring prefill's per-shard probe on a mesh.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import registered_ops
from repro_torch.device import fit_block

__all__ = ["Adopted", "adopt", "adopt_winners", "mesh_probes",
           "serving_probes", "train_probes"]


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _dims(cfg):
    h = getattr(cfg, "n_heads", 0) or 0
    hk = getattr(cfg, "n_kv_heads", 0) or h
    attn = h and getattr(cfg, "attn_type", "gqa") != "mla"
    return h, hk, cfg.resolved_head_dim if attn else 0


def _head(cfg, rows):
    from repro_torch.models.lm import pad_vocab

    dtype = getattr(torch, cfg.dtype)
    return (_meta((rows, cfg.d_model), dtype),
            _meta((cfg.d_model, pad_vocab(cfg.vocab_size)), dtype))


def serving_probes(cfg, batch: int, prompt_len: int, max_len: int, *,
                   page_size: int | None = None, paged_lens=None) -> dict:
    """Probes for one serving config: the prefill's attention, one-token
    decode against the static cache (``max_len`` slots, a rolling
    window's ``min(max_len, window)``), paged decode on the engine's pool
    (pages of ``page_size``, default the engine's ``fit_block(512,
    max_len)``) and the decode head.

    A decode split's best length depends on how many slots are live, which
    the shapes do not say; a winner is keyed by the shapes alone, so the
    lengths matter only to the sweep that times the probe. They are the
    JAX package's, every cache full, unless the caller measured its
    traffic: ``paged_lens`` the ``batch`` live lengths of one engine step
    (the kv_len each slot's query sees; 0 an idle slot, which reads the
    null page as the engine's do)."""
    probes = {}
    h, hk, hd = _dims(cfg)
    dtype = getattr(torch, cfg.dtype)
    window = cfg.window
    if h and hd:
        probes["flash_attention"] = (
            (_meta((batch, h, prompt_len, hd), dtype),
             _meta((batch, hk, prompt_len, hd), dtype),
             _meta((batch, hk, prompt_len, hd), dtype)),
            dict(causal=True, window=window))
        m = min(max_len, window) if window else max_len
        probes["flash_decode"] = (
            (_meta((batch, h, 1, hd), dtype), _meta((batch, hk, m, hd), dtype),
             _meta((batch, hk, m, hd), dtype)),
            dict(window=window))
        if not window:
            from repro_torch.kernels.flash_attention.ops import paged_positions

            page = page_size or fit_block(512, max_len)
            nsp = -(-max_len // page)
            npages = batch * nsp + 1          # + the null page 0
            lens = np.array([max_len] * batch if paged_lens is None
                            else paged_lens, np.int32)
            if lens.shape != (batch,) or not (
                    (lens >= 0) & (lens <= max_len)).all():
                raise ValueError(f"paged_lens: {batch} lengths in [0, "
                                 f"{max_len}], got {lens.tolist()}")
            table = np.arange(1, batch * nsp + 1, dtype=np.int32).reshape(
                batch, nsp)
            table[lens == 0] = 0              # idle: the null page
            probes["flash_decode_paged"] = (
                (_meta((batch, h, 1, hd), dtype),
                 _meta((npages, hk, page, hd), dtype),
                 _meta((npages, hk, page, hd), dtype)),
                dict(block_table=torch.from_numpy(table),
                     kv_len=torch.from_numpy(np.maximum(lens, 1)),
                     pos_pages=torch.from_numpy(paged_positions(
                         table, lens, npages, page))))
    probes["lm_head_logits"] = (_head(cfg, batch), dict(vocab=cfg.vocab_size))
    return probes


def train_probes(cfg, global_batch: int, seq_len: int) -> dict:
    """Probes for one train step: causal attention at the full sequence
    and the fused CE head at ``B (S - 1)`` rows."""
    probes = {}
    h, hk, hd = _dims(cfg)
    dtype = getattr(torch, cfg.dtype)
    if h and hd:
        probes["flash_attention"] = (
            (_meta((global_batch, h, seq_len, hd), dtype),
             _meta((global_batch, hk, seq_len, hd), dtype),
             _meta((global_batch, hk, seq_len, hd), dtype)),
            dict(causal=True, window=cfg.window))
    rows = global_batch * max(seq_len - 1, 1)
    probes["lm_head_ce"] = ((*_head(cfg, rows), _meta((rows, 1), torch.int32)),
                            dict(vocab=cfg.vocab_size))
    return probes


def mesh_probes(cfg, batch: int, prompt_len: int, *, shards: int,
                mesh_axis: str = "model") -> dict:
    """Probes for ring-attention prefill over ``shards`` ranks: every rank
    runs the per-shard kernel (sequence ``prompt_len // shards``), so that
    is the shape to tune; ``ring_steps`` rides in the params, keeping the
    persisted key distinct per mesh size."""
    probes = {}
    # the attention widths as JAX's probes read them (MLA's included)
    h = getattr(cfg, "n_heads", 0)
    hk = getattr(cfg, "n_kv_heads", 0) or h
    hd = cfg.resolved_head_dim
    dtype = getattr(torch, cfg.dtype)
    if shards < 1 or prompt_len % shards:
        raise ValueError(
            f"mesh_probes: shards={shards} does not divide prompt_len="
            f"{prompt_len}")
    loc = prompt_len // shards
    if h and hd:
        probes["ring_flash"] = (
            (_meta((batch, h, loc, hd), dtype),
             _meta((batch, hk, loc, hd), dtype),
             _meta((batch, hk, loc, hd), dtype)),
            dict(causal=True, window=cfg.window, ring_steps=shards,
                 mesh_axis=mesh_axis))
    return probes


class Adopted(dict):
    """``{op name: winner}`` found in the cache, with ``.refused``
    ``{op name: reason}`` (a persisted winner the wrapper would refuse at
    these shapes: not adopted) and ``.skipped`` ``{op name: reason}`` (a
    probe outside the op's domain: nothing looked up)."""

    def __init__(self):
        super().__init__()
        self.refused = {}
        self.skipped = {}

    def knob(self, name: str, knob: str):
        """The adopted value of ``name``'s ``knob``, or None (its rule)."""
        return self.get(name, {}).get(knob)

    def report(self) -> str:
        parts = [f"adopted {dict(self)}"]
        if self.refused:
            parts.append(f"refused {self.refused}")
        if self.skipped:
            parts.append(f"skipped {self.skipped}")
        return "; ".join(parts)


def _winner_overflows(op, args, params, winner) -> str | None:
    """Why a persisted winner's spec overflows the shared-memory budget
    at these probe shapes (``$REPRO_SMEM_BUDGET``; a stale entry tuned
    under other limits is not adopted: its first torch or loops build
    would raise SMEM_OVERFLOW), or None. On the card the wrapper's own
    limits decide (:meth:`Op.refused`)."""
    from types import SimpleNamespace

    from repro_torch.core.analyze import smem_budget, smem_footprint

    defines = op.derive_defines(args, dict(op.defaults, **params))
    need = smem_footprint(op.builder(SimpleNamespace(
        **dict(defines, **winner))))[0]
    if need > smem_budget():
        return (f"the winner's spec needs {need} B of shared memory a "
                f"block > budget {smem_budget()} B")
    return None


def adopt_winners(probes: dict, *, device, ops=None) -> Adopted:
    """The persisted ``op.tune`` winner of every probe with a sweep (of
    the ``ops`` named, default all), as timed on ``device``: a lookup
    alone. A miss adopts nothing. A probe whose shapes the op's own domain
    check refuses (``ValueError`` from its defines) is skipped and named;
    a winner the wrapper would refuse at these shapes, or (off the card)
    whose spec overflows the shared-memory budget, is not adopted and is
    named; any other error raises."""
    registry = registered_ops()
    device = torch.device(device)
    out = Adopted()
    for name, (args, params) in probes.items():
        op = registry.get(name)
        if op is None or not op.sweep or (ops is not None
                                          and name not in ops):
            continue
        try:
            op.derive_defines(args, dict(op.defaults, **params))
        except ValueError as e:
            out.skipped[name] = str(e)
            continue
        winner = op.cached_winner(args, device=device, **params)
        if not winner:
            continue
        reason = op.refused(args, winner, **params)
        if reason is None and device.type != "cuda":
            reason = _winner_overflows(op, args, params, winner)
        if reason is not None:
            out.refused[name] = reason
            continue
        out[name] = winner
    return out


def adopt(cfg, shapes: dict, *, kind: str, device, ops=None) -> Adopted:
    """The warmup surface: build ``kind``'s probes from ``shapes`` and
    look up their winners for ``device`` (:func:`adopt_winners`; ``ops``
    the op names the caller launches, default all).

      kind="serve":  batch, prompt_len, max_len [, page_size]
      kind="train":  global_batch, seq_len
      kind="mesh":   batch, prompt_len, shards [, mesh_axis]
    """
    if kind == "serve":
        probes = serving_probes(cfg, shapes["batch"], shapes["prompt_len"],
                                shapes["max_len"],
                                page_size=shapes.get("page_size"))
    elif kind == "train":
        probes = train_probes(cfg, shapes["global_batch"], shapes["seq_len"])
    elif kind == "mesh":
        probes = mesh_probes(cfg, shapes["batch"], shapes["prompt_len"],
                             shards=shapes["shards"],
                             mesh_axis=shapes.get("mesh_axis", "model"))
    else:
        raise ValueError(f"adopt: kind must be serve|train|mesh, got "
                         f"{kind!r}")
    return adopt_winners(probes, device=torch.device(device), ops=ops)
