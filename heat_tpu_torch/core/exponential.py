"""Exponential and logarithmic functions (counterpart of
``heat_tpu/core/exponential.py``, all 11 names). Exact input gives its
inexact type, as in the JAX package: int64 float64, bool, uint8, int8,
int16 and int32 float32; ``square`` keeps the type."""

from __future__ import annotations

import torch

from ._operations import binary_op, local_op, tensor_operands
from .dndarray import DNDarray

__all__ = [
    "exp",
    "expm1",
    "exp2",
    "log",
    "log2",
    "log10",
    "log1p",
    "logaddexp",
    "logaddexp2",
    "sqrt",
    "square",
]


def exp(x: DNDarray, out=None) -> DNDarray:
    return local_op(torch.exp, x, out, promote_exact=True)


def expm1(x: DNDarray, out=None) -> DNDarray:
    return local_op(torch.expm1, x, out, promote_exact=True)


def exp2(x: DNDarray, out=None) -> DNDarray:
    return local_op(torch.exp2, x, out, promote_exact=True)


def log(x: DNDarray, out=None) -> DNDarray:
    return local_op(torch.log, x, out, promote_exact=True)


def log2(x: DNDarray, out=None) -> DNDarray:
    return local_op(torch.log2, x, out, promote_exact=True)


def log10(x: DNDarray, out=None) -> DNDarray:
    return local_op(torch.log10, x, out, promote_exact=True)


def log1p(x: DNDarray, out=None) -> DNDarray:
    return local_op(torch.log1p, x, out, promote_exact=True)


def logaddexp(t1, t2, out=None) -> DNDarray:
    """``log(exp(t1) + exp(t2))``."""
    return binary_op(tensor_operands(torch.logaddexp), t1, t2, out, inexact=True)


def logaddexp2(t1, t2, out=None) -> DNDarray:
    """``log2(2**t1 + 2**t2)``."""
    return binary_op(tensor_operands(torch.logaddexp2), t1, t2, out, inexact=True)


def sqrt(x: DNDarray, out=None) -> DNDarray:
    return local_op(torch.sqrt, x, out, promote_exact=True)


def square(x: DNDarray, out=None) -> DNDarray:
    return local_op(torch.square, x, out)


DNDarray.exp = lambda self, out=None: exp(self, out)
DNDarray.exp2 = lambda self, out=None: exp2(self, out)
DNDarray.expm1 = lambda self, out=None: expm1(self, out)
DNDarray.log = lambda self, out=None: log(self, out)
DNDarray.log2 = lambda self, out=None: log2(self, out)
DNDarray.log10 = lambda self, out=None: log10(self, out)
DNDarray.log1p = lambda self, out=None: log1p(self, out)
DNDarray.sqrt = lambda self, out=None: sqrt(self, out)
DNDarray.square = lambda self, out=None: square(self, out)
