"""Elastic scaling: the mesh shape for the surviving ranks, and live or
restored state placed onto a new mesh (the counterpart of
``repro.runtime.elastic``).

Policy: keep the model axis (tensor parallelism must match the weights'
partitioning) and shrink or grow the data axis to the largest size that
fits the surviving ranks: the data-parallel degree is the elastic
dimension. A new mesh is a new process group (a restarted job); the state
crosses over as full arrays, from a checkpoint
(``CheckpointManager.restore(shardings=)``) or gathered on the old mesh
(``parallel.gather_tree``), and :func:`reshard` slices them to the new
mesh.
"""

from __future__ import annotations

__all__ = ["choose_mesh_shape", "reshard"]


def choose_mesh_shape(n_devices: int, *, model: int = 16,
                      pod: int | None = None) -> tuple:
    """Largest (pod?, data, model) grid with fixed model axis."""
    assert n_devices >= model, (n_devices, model)
    if pod:
        data = n_devices // (pod * model)
        assert data >= 1
        return (pod, data, model)
    data = n_devices // model
    return (data, model)


def reshard(tree, specs, new_mesh):
    """This rank's shard on ``new_mesh`` of every full leaf of ``tree``
    under ``specs`` (a matching tree of specs, e.g. ``make_shardings``'
    pspecs)."""
    from repro_torch.parallel import rules as R
    from repro_torch.parallel.steps import Placement
    from repro_torch.tree import leaves, unflatten

    return unflatten(tree, [Placement(new_mesh, s).local(t) for t, s in zip(
        leaves(tree), R.spec_leaves(specs), strict=True)])
