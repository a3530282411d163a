"""occa::memory analogue: a device memory handle over a torch tensor (the
counterpart of ``repro.core.memory``).

Torch tensors are mutable, so a kernel writes its outputs into the
``Memory`` it is given, in place, as OCCA does (the JAX package rebinds
the handle to a fresh array instead). ``swap`` exchanges two handles'
tensors: the paper's listing 9 rotates the FD solutions with it, and no
step allocates.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["Memory"]


class Memory:
    __slots__ = ("device", "_t")

    def __init__(self, device, tensor):
        self.device = device
        self._t = tensor

    # -- handle access ------------------------------------------------------
    @property
    def data(self) -> torch.Tensor:
        return self._t

    @property
    def shape(self):
        return tuple(self._t.shape)

    @property
    def dtype(self):
        return self._t.dtype

    @property
    def nbytes(self) -> int:
        return self._t.numel() * self._t.element_size()

    # -- paper listing 9: o_u1.swap(o_u2) ------------------------------------
    def swap(self, other: "Memory") -> None:
        if not isinstance(other, Memory):
            raise TypeError(f"swap: expected Memory, got {type(other).__name__}")
        if other.device is not self.device:
            # memory belongs to the device that allocated it
            raise ValueError(
                f"swap: Memory handles belong to different devices "
                f"({self.device!r} vs {other.device!r})")
        self._t, other._t = other._t, self._t

    # -- host<->device copies -------------------------------------------------
    def to_host(self) -> np.ndarray:
        """A numpy copy (bfloat16 comes back as float32)."""
        t = self._t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    def from_host(self, array) -> None:
        """Copy ``array`` (numpy or tensor, this handle's shape and dtype)
        into the handle's tensor in place."""
        src = array if torch.is_tensor(array) else torch.from_numpy(
            np.asarray(array))
        if tuple(src.shape) != self.shape or src.dtype != self.dtype:
            raise ValueError(
                f"from_host: expected {self.shape}/{self.dtype}, "
                f"got {tuple(src.shape)}/{src.dtype}")
        self._t.copy_(src)

    def __repr__(self):
        return (f"Memory(shape={self.shape}, dtype={self.dtype}, "
                f"backend={self.device.backend}, device={self._t.device})")
