"""The paper's three numerical applications (FD wave, SEM operator, DG
shallow water), each written in the kernel language and driven through the
OCCA host API (``repro_torch.core``): the hand-written Hopper kernels on
the card (``model="cuda"``), the language's torch or loops expansion
otherwise."""

from . import dg_swe, fd2d, numerics, sem  # noqa: F401
