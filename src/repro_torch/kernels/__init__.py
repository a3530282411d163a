"""Hand-written Hopper kernels of the port, one package per TPU kernel.

Each wrapper launches its kernel for a CUDA tensor (or raises) and takes
its plain PyTorch version only for a tensor on the CPU. Every wrapper keeps
a launch count (``wrapper.launches``) that rises by one where the kernel is
launched and nowhere else, so a run can show that it went through the
kernels: :func:`reset_launches` zeroes them, :func:`launch_counts` reads
them.
"""

from __future__ import annotations

from .apps import dg_surface, dg_volume, fd2d, sem_apply
from .flash_attention import (flash_attention_fwd, flash_bwd, flash_delta,
                              paged_decode_attention)
from .lm_head import lm_head_bwd, lm_head_ce, lm_head_logits
from .rmsnorm import rmsnorm

__all__ = ["KERNELS", "launch_counts", "reset_launches"]

# kernel name -> the wrapper that launches it (and carries ``.launches``)
KERNELS = {
    "rmsnorm": rmsnorm,
    "flash_fwd": flash_attention_fwd,
    "paged_decode": paged_decode_attention,
    "lm_head": lm_head_logits,
    "lm_head_ce": lm_head_ce,
    "lm_head_bwd": lm_head_bwd,
    "flash_delta": flash_delta,
    "flash_bwd": flash_bwd,
    "fd2d": fd2d,
    "sem_apply": sem_apply,
    "dg_volume": dg_volume,
    "dg_surface": dg_surface,
}


def reset_launches():
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}
