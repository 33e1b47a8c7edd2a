"""Linear algebra (counterpart of ``heat_tpu/core/linalg``). This slice has
the W8A8 int8 path only; ``matmul`` and the rest are still to port."""

from .quant import int8_matmul, matmul_int8, quantize_int8

__all__ = ["int8_matmul", "matmul_int8", "quantize_int8"]
