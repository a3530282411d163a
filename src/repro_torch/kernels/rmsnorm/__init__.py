from .kernel import rmsnorm_builder
from .ops import rmsnorm, route
from .ref import rmsnorm_ref

__all__ = ["rmsnorm", "rmsnorm_builder", "rmsnorm_ref", "route"]
