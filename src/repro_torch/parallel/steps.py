"""Distributed step builders (counterpart of ``repro.parallel.steps``),
reduced to what sequence parallelism needs: the ambient :class:`Rules` and
a prefill step that runs under them. There is no jit and there are no
parameter shardings: weights stay replicated on every rank until tensor
parallelism is ported."""

from __future__ import annotations

from .context import Rules, use_rules

__all__ = ["make_shardings", "build_prefill_step"]


def make_shardings(model, mesh, *, ring=False):
    """The :class:`Rules` for ``model`` on ``mesh``: ``ring=True`` declares
    sequence-parallel ring attention over the "model" axis when that axis
    has more than one rank (``ring_axis`` stays None otherwise)."""
    del model  # parameter shardings come with tensor parallelism
    names = mesh.mesh_dim_names or ()
    size = mesh.size(names.index("model")) if "model" in names else 1
    return Rules(mesh=mesh, ring_axis="model" if ring and size > 1 else None)


def build_prefill_step(model, mesh, *, batch, max_len, ring=False):
    """``prefill(params, batch)`` -> ``model.prefill``'s (logits, cache)
    under :func:`make_shardings`'s rules; ``batch`` holds "tokens" (B, S)
    and optionally "prefix_embeddings". ``ring=True`` sends prefill
    attention down the ring schedule when S divides the ring (every rank
    then holds the full logits and cache)."""
    del batch  # the batch size shards nothing until data parallelism
    rules = make_shardings(model, mesh, ring=ring)

    def prefill(params, batch_):
        with use_rules(rules):
            return model.prefill(
                params, batch_["tokens"],
                prefix_embeddings=batch_.get("prefix_embeddings"),
                max_len=max_len)

    return prefill
