"""Linear algebra (counterpart of ``heat_tpu/core/linalg``): the basics
(``matmul`` and the rest), ``qr`` (TSQR, CholeskyQR2), ``svd``, the W8A8
int8 path and the iterative solvers ``cg`` and ``lanczos``."""

from .basics import *
from .qr import *
from .svd import *
from .solver import *
from .quant import int8_matmul, matmul_int8, quantize_int8

__all__ = basics.__all__ + ["cg", "lanczos", "qr", "svd", "int8_matmul", "matmul_int8", "quantize_int8"]
