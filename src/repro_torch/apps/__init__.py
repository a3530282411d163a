"""The paper's three numerical applications (FD wave, SEM operator, DG
shallow water), each driven through its hand-written Hopper kernels on the
card or their plain PyTorch versions on the CPU."""

from . import dg_swe, fd2d, numerics, sem  # noqa: F401
