"""PyTorch/CUDA port of ``repro`` for NVIDIA Hopper (H100).

The package mirrors the JAX package's layout so each counterpart is easy to
find, imports ``torch`` and never ``jax`` or ``repro``, and carries one
hand-written Hopper kernel (``csrc/`` CUDA C++, or Triton for rmsnorm and
the flash backward's delta) per TPU kernel on the ported paths (serving,
training and the paper's FD/SEM/DG apps), each with its plain PyTorch
version beside it. A kernel wrapper
takes the plain version only for a tensor on the CPU.
"""

from .device import fit_block, resolve_device

__all__ = ["fit_block", "resolve_device"]
