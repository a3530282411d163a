"""The paper apps' kernels (FD, SEM, DG), one wrapper each: the CUDA kernel
for CUDA tensors, the plain PyTorch version for CPU tensors."""

from .dg import GRAV, dg_surface, dg_volume, surface_ref, volume_ref
from .fd2d import fd2d, fd2d_ref
from .sem import apply_ref, sem_apply

__all__ = ["GRAV", "apply_ref", "dg_surface", "dg_volume", "fd2d",
           "fd2d_ref", "sem_apply", "surface_ref", "volume_ref"]
