from .ops import rmsnorm, route
from .ref import rmsnorm_ref

__all__ = ["rmsnorm", "rmsnorm_ref", "route"]
