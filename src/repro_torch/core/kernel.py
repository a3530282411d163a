"""occa::kernel analogue: a built (backend-expanded) kernel handle (the
counterpart of ``repro.core.kernel``)."""

from __future__ import annotations

from .memory import Memory

__all__ = ["Kernel"]


class Kernel:
    """Callable kernel handle.

    The call follows the paper's host code (listing 9): the kernel's inputs
    (``Memory`` or tensors), then its outputs, which must be ``Memory``s of
    this kernel's device and are written in place. :meth:`run` takes the
    inputs only and returns the outputs as the backend makes them (on the
    cuda backend the wrapper's own tensors, with no copy).
    """

    def __init__(self, device, spec, fn, defines: dict, *, report=None):
        self.device = device
        self.report = report    # the analyzer's report of the build
        self.spec = spec
        self.defines = dict(defines)
        self._fn = fn
        self.n_in = len(spec.inputs)
        self.n_out = len(spec.outputs)
        self._in_shapes = [t.shape for t in spec.inputs]
        self._out_sig = [(t.shape, t.dtype) for t in spec.outputs]

    @property
    def name(self) -> str:
        return self.spec.name

    @property
    def binding(self):
        """The cuda backend's binding (None on the torch and loops ones)."""
        return getattr(self._fn, "binding", None)

    def _inputs(self, args):
        ins = []
        for a, shape, t in zip(args, self._in_shapes, self.spec.inputs):
            if isinstance(a, Memory):
                if a.device is not self.device:
                    raise ValueError(
                        f"kernel {self.name!r}: input {t.name!r} belongs to "
                        f"{a.device!r}, not this kernel's {self.device!r}")
                a = a.data
            if tuple(a.shape) != shape:
                raise ValueError(
                    f"kernel {self.name!r}: input {t.name!r} has shape "
                    f"{tuple(a.shape)}, the spec's is {shape}")
            ins.append(a)
        return ins

    def __call__(self, *args):
        if len(args) != self.n_in + self.n_out:
            raise TypeError(
                f"kernel {self.name!r} expects {self.n_in} inputs + "
                f"{self.n_out} outputs, got {len(args)} args")
        ins = self._inputs(args[: self.n_in])
        outs = []
        for slot, (shape, dtype), t in zip(args[self.n_in:], self._out_sig,
                                           self.spec.outputs):
            if not isinstance(slot, Memory):
                raise TypeError(f"kernel {self.name!r}: output args must be Memory")
            if slot.device is not self.device:
                raise ValueError(
                    f"kernel {self.name!r}: output Memory belongs to "
                    f"{slot.device!r}, not this kernel's {self.device!r}")
            if slot.shape != shape or slot.dtype != dtype:
                raise ValueError(
                    f"kernel {self.name!r}: output {t.name!r} has shape/"
                    f"dtype {slot.shape}/{slot.dtype}, the spec's are "
                    f"{shape}/{dtype}")
            outs.append(slot.data)
        return self._fn(*ins, outs=outs)

    def run(self, *inputs):
        """The kernel on ``inputs`` (Memory or tensors): its outputs."""
        if len(inputs) != self.n_in:
            raise TypeError(f"kernel {self.name!r} expects {self.n_in} "
                            f"inputs, got {len(inputs)}")
        return self._fn(*self._inputs(inputs))

    def __repr__(self):
        return (f"Kernel({self.name!r}, backend={self.device.backend}, "
                f"defines={self.defines})")
