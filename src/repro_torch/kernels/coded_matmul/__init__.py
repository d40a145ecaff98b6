from .ops import coded_matmul
from .ref import coded_matmul_ref

__all__ = ["coded_matmul", "coded_matmul_ref"]
