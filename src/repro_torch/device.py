"""Device selection and block fitting for the PyTorch port.

Every entry point of the port (``LM``, ``Engine``, ``launch.serve``) runs on
the CUDA card unless the caller asks for the CPU: :func:`resolve_device`
returns ``cuda`` for ``device=None`` and raises when there is no card, so a
missing GPU is an error, never a silent CPU run.
"""

from __future__ import annotations

import torch

__all__ = ["fit_block", "resolve_device"]


def fit_block(block: int, n: int) -> int:
    """Largest divisor of ``n`` that is <= ``block`` (blocks must tile exactly)."""
    if n <= 0:
        raise ValueError(f"fit_block: cannot tile a dimension of size {n}")
    if block <= 0:
        raise ValueError(f"fit_block: block must be positive, got {block}")
    n = int(n)
    # the largest n // k <= block: walk k up from the fewest blocks (at most
    # n / block steps, not block)
    for k in range(-(-n // min(int(block), n)), n + 1):
        if n % k == 0:
            return n // k
    return 1


def resolve_device(device=None) -> torch.device:
    """``None`` -> the CUDA card (raises without one); otherwise the device
    the caller named (``"cpu"`` runs the plain PyTorch versions)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain PyTorch "
                "versions on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} asked for but CUDA is not "
                           "available")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device!r} (cpu or cuda)")
    return dev
