from .ops import rmsnorm
from .ref import rmsnorm_ref

__all__ = ["rmsnorm", "rmsnorm_ref"]
