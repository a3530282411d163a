"""Sharding rules (counterpart of ``repro.parallel.rules``): the ring-axis
rule. The per-parameter tables come with tensor parallelism."""

from __future__ import annotations

__all__ = ["ring_axis_for"]


def ring_axis_for(mesh, seq_len, *, model_axis="model"):
    """The mesh axis a sequence of ``seq_len`` can ring over, or None.

    Ring attention needs the model axis present, more than one shard, and an
    evenly divisible sequence (every shard runs the same kernel grid)."""
    if mesh is None:
        return None
    shape = dict(zip(mesh.mesh_dim_names or (), mesh.shape))
    n = int(shape.get(model_axis, 1))
    if n > 1 and seq_len % n == 0:
        return model_axis
    return None
