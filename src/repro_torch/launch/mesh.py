"""Device meshes (counterpart of ``repro.launch.mesh``): functions, never
module-level constants, so an import touches no process group.

A mesh here is a ``torch.distributed`` ``DeviceMesh`` over the ranks of a
process group the caller has already started: ``torchrun --nproc-per-node
N`` (its environment and ``init_process_group``), or spawned processes with
a file rendezvous and the gloo backend in the CPU tests.
"""

from __future__ import annotations

from repro_torch.device import resolve_device

__all__ = ["make_production_mesh", "make_local_mesh", "make_pipe_mesh"]


def _world(what):
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError(f"{what}: no process group; start one first "
                           "(torchrun, or init_process_group)")
    return dist.get_world_size()


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """16 x 16 = 256 ranks a pod as ("data", "model"); the multi-pod mesh
    adds a pure-DP "pod" axis (2 x 16 x 16 = 512 ranks, ("pod", "data",
    "model")). The process group must hold exactly that many ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = _world("make_production_mesh")
    want = 1
    for s in shape:
        want *= s
    if n != want:
        raise ValueError(
            f"make_production_mesh(multi_pod={multi_pod}): the {shape} mesh "
            f"{axes} needs a process group of {want} ranks, this one has "
            f"{n}; use make_local_mesh for another size")
    return init_device_mesh(resolve_device(device).type, shape,
                            mesh_dim_names=axes)


def make_local_mesh(*, data=None, model=1, device=None):
    """A ("data", "model") mesh over every rank of the default process
    group: ``model`` ranks on the model axis, ``data`` (default: the rest)
    on the data axis. Runs on the CUDA card unless ``device="cpu"``."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    n = _world("make_local_mesh")
    data = data or n // model
    if data * model != n:
        raise ValueError(f"make_local_mesh: data={data} x model={model} "
                         f"!= world size {n}")
    return init_device_mesh(dev.type, (data, model),
                            mesh_dim_names=("data", "model"))


def make_pipe_mesh(*, stages=None, device=None):
    """A one-axis ("pipe",) mesh of ``stages`` ranks (default: every rank
    of the default process group), for ``parallel.pipeline``: JAX's
    ``jax.make_mesh((S,), ("pipe",))``. Runs on the CUDA card unless
    ``device="cpu"``."""
    from torch.distributed.device_mesh import init_device_mesh

    n = _world("make_pipe_mesh")
    stages = stages or n
    if stages != n:
        raise ValueError(f"make_pipe_mesh: {stages} stages != world size "
                         f"{n}")
    return init_device_mesh(resolve_device(device).type, (stages,),
                            mesh_dim_names=("pipe",))
