"""Linear algebra (counterpart of ``heat_tpu/core/linalg``): the basics
(``matmul`` and the rest), ``qr`` (TSQR, CholeskyQR2), ``svd`` and the W8A8
int8 path. ``solver`` (``cg``, ``lanczos``) is still to port."""

from .basics import *
from .qr import *
from .svd import *
from .quant import int8_matmul, matmul_int8, quantize_int8

__all__ = basics.__all__ + ["qr", "svd", "int8_matmul", "matmul_int8", "quantize_int8"]
