"""Local device meshes (counterpart of ``repro.launch.mesh``).

A mesh here is a ``torch.distributed`` ``DeviceMesh`` over the ranks of a
process group the caller has already started: ``torchrun --nproc-per-node
N`` (its environment and ``init_process_group``) on the card, or spawned
processes with a file rendezvous and the gloo backend in the CPU tests.
The 256-chip production mesh comes with tensor parallelism.
"""

from __future__ import annotations

from repro_torch.device import resolve_device

__all__ = ["make_local_mesh"]


def make_local_mesh(*, data=None, model=1, device=None):
    """A ("data", "model") mesh over every rank of the default process
    group: ``model`` ranks on the model axis, ``data`` (default: the rest)
    on the data axis. Runs on the CUDA card unless ``device="cpu"``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("make_local_mesh: no process group; start one "
                           "first (torchrun, or init_process_group)")
    n = dist.get_world_size()
    data = data or n // model
    if data * model != n:
        raise ValueError(f"make_local_mesh: data={data} x model={model} "
                         f"!= world size {n}")
    return init_device_mesh(dev.type, (data, model),
                            mesh_dim_names=("data", "model"))
