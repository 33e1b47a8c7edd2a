"""Arithmetic operations (counterpart of ``heat_tpu/core/arithmetics.py``,
the subset of this slice: add, sub, mul, div, pow, neg, sum)."""

from __future__ import annotations

import torch

from ._operations import binary_op, local_op, reduce_op
from .dndarray import DNDarray

__all__ = ["add", "div", "mul", "neg", "pow", "sub", "sum"]


def add(t1, t2, out=None) -> DNDarray:
    """Elementwise addition."""
    return binary_op(torch.add, t1, t2, out)


def sub(t1, t2, out=None) -> DNDarray:
    """Elementwise subtraction."""
    return binary_op(torch.sub, t1, t2, out)


def mul(t1, t2, out=None) -> DNDarray:
    """Elementwise multiplication."""
    return binary_op(torch.mul, t1, t2, out)


def div(t1, t2, out=None) -> DNDarray:
    """Elementwise true division (an exact result type becomes inexact:
    int64 float64, the narrower ones and bool float32)."""
    return binary_op(torch.true_divide, t1, t2, out, true_divide=True)


def pow(t1, t2, out=None) -> DNDarray:
    """Elementwise power."""
    return binary_op(torch.pow, t1, t2, out)


def neg(a: DNDarray, out=None) -> DNDarray:
    """Elementwise negation."""
    return local_op(torch.neg, a, out)


def sum(a: DNDarray, axis=None, out=None, keepdims: bool = False) -> DNDarray:
    """Sum of elements over axis (reference `sum`: local sum + Allreduce)."""
    return reduce_op("sum", a, axis, neutral=0, out=out, keepdims=keepdims)


DNDarray.__add__ = lambda self, other: add(self, other)
DNDarray.__radd__ = lambda self, other: add(other, self)
DNDarray.__sub__ = lambda self, other: sub(self, other)
DNDarray.__rsub__ = lambda self, other: sub(other, self)
DNDarray.__mul__ = lambda self, other: mul(self, other)
DNDarray.__rmul__ = lambda self, other: mul(other, self)
DNDarray.__truediv__ = lambda self, other: div(self, other)
DNDarray.__rtruediv__ = lambda self, other: div(other, self)
DNDarray.__pow__ = lambda self, other: pow(self, other)
DNDarray.__rpow__ = lambda self, other: pow(other, self)
DNDarray.__neg__ = lambda self: neg(self)
DNDarray.sum = lambda self, axis=None, out=None, keepdims=False: sum(self, axis, out, keepdims)
