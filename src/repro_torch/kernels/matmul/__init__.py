from .kernel import matmul_builder
from .ops import matmul
from .ref import matmul_ref

__all__ = ["matmul", "matmul_builder", "matmul_ref"]
