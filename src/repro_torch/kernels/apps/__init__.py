"""The paper apps' kernels (FD, SEM, DG), one wrapper each: the CUDA kernel
for CUDA tensors, the plain PyTorch version for CPU tensors."""

from .dg import (GRAV, dg_surface, dg_volume, surface_ref, volume_folded_ref,
                 volume_ref)
from .fd2d import fd2d, fd2d_ref, fd2d_stream_ref
from .sem import apply_ref, sem_apply, sem_route

__all__ = ["GRAV", "apply_ref", "dg_surface", "dg_volume", "fd2d",
           "fd2d_ref", "fd2d_stream_ref", "sem_apply", "sem_route", "surface_ref",
           "volume_folded_ref", "volume_ref"]
