"""Hand-written Hopper kernels of the port, one package per TPU kernel.

Each wrapper launches its kernel for a CUDA tensor (or raises) and takes
its plain PyTorch version only for a tensor on the CPU. Every wrapper keeps
a launch count (``wrapper.launches``) that rises by one where the kernel is
launched and nowhere else, and by a replay of a CUDA graph that holds its
launches (below), so a run can show that it went through the kernels:
:func:`reset_launches` zeroes them, :func:`launch_counts` reads them. A wrapper with two kernels (``matmul``, ``lm_head_logits``,
``lm_head_ce``, ``lm_head_bwd``, ``flash_attention_fwd``, ``flash_bwd``,
``ring_flash_fwd``, ``ring_flash_bwd``: a tensor-core and a CUDA-core
route; ``rmsnorm``, ``fd2d`` and ``flash_delta``: a 16-byte-vector and a
narrower variant; ``dg_volume``: an instance per np of N = 1..7 and a
generic one; ``sem_apply``: an instance per nq of N = 1..9 and a generic
one) also
counts its launches by route in ``wrapper.routes``, which
:func:`reset_launches` zeroes too.

The counts rise in Python, so a CUDA graph's replay would not move them:
a compiled step (``repro_torch.parallel.GraphStep``) takes what capturing
it counted (:func:`launch_state`, :func:`launches_since`), takes that back
(capture launches nothing) and adds it again at every replay
(:func:`add_launches`), so the counts stay what eager code would count.
These replayed counts come from the capture, not from the launch itself:
``chip_smoke.py`` reads each captured graph's kernel nodes on the card and
holds them against the counts.
"""

from __future__ import annotations

from .apps import dg_surface, dg_volume, fd2d, sem_apply
from .flash_attention import (flash_attention_fwd, flash_bwd, flash_decode,
                              flash_delta, paged_decode_attention,
                              ring_flash_bwd, ring_flash_fwd)
from .lm_head import lm_head_bwd, lm_head_ce, lm_head_logits
from .matmul import matmul
from .rmsnorm import rmsnorm
from .ssm_scan import ssm_scan_fwd

__all__ = ["KERNELS", "launch_counts", "reset_launches", "launch_state",
           "launches_since", "add_launches"]

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
    "flash_decode": flash_decode,
    "ssm_scan": ssm_scan_fwd,
    "ring_flash_fwd": ring_flash_fwd,
    "ring_flash_bwd": ring_flash_bwd,
    "matmul": matmul,
}


def reset_launches():
    for fn in KERNELS.values():
        fn.launches = 0
        for path in getattr(fn, "routes", ()):
            fn.routes[path] = 0


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def launch_state() -> dict:
    """Every wrapper's count and route counts: {name: (launches,
    {route: n})}, to hand to :func:`launches_since`."""
    return {name: (fn.launches, dict(getattr(fn, "routes", {})))
            for name, fn in KERNELS.items()}


def launches_since(state: dict) -> dict:
    """What the wrappers counted since ``state`` (:func:`launch_state`), in
    the same form, for the wrappers that counted anything."""
    moved = {}
    for name, (n, routes) in launch_state().items():
        n0, routes0 = state[name]
        by_route = {r: k - routes0[r] for r, k in routes.items()
                    if k != routes0[r]}
        if n != n0 or by_route:
            moved[name] = (n - n0, by_route)
    return moved


def add_launches(counts: dict, times: int = 1):
    """Add ``times`` x ``counts`` (:func:`launches_since`'s form) to the
    wrappers' counts and route counts."""
    for name, (n, routes) in counts.items():
        fn = KERNELS[name]
        fn.launches += times * n
        for r, k in routes.items():
            fn.routes[r] += times * k
