"""Trigonometric and hyperbolic functions (counterpart of
``heat_tpu/core/trigonometrics.py``, all 24 names). Exact input gives its
inexact type, as in the JAX package."""

from __future__ import annotations

import torch

from ._operations import binary_op, local_op, tensor_operands
from .dndarray import DNDarray

__all__ = [
    "acos",
    "acosh",
    "asin",
    "asinh",
    "atan",
    "atan2",
    "atanh",
    "arccos",
    "arccosh",
    "arcsin",
    "arcsinh",
    "arctan",
    "arctan2",
    "arctanh",
    "cos",
    "cosh",
    "deg2rad",
    "degrees",
    "rad2deg",
    "radians",
    "sin",
    "sinh",
    "tan",
    "tanh",
]


def acos(x, out=None) -> DNDarray:
    return local_op(torch.acos, x, out, promote_exact=True)


arccos = acos


def acosh(x, out=None) -> DNDarray:
    return local_op(torch.acosh, x, out, promote_exact=True)


arccosh = acosh


def asin(x, out=None) -> DNDarray:
    return local_op(torch.asin, x, out, promote_exact=True)


arcsin = asin


def asinh(x, out=None) -> DNDarray:
    return local_op(torch.asinh, x, out, promote_exact=True)


arcsinh = asinh


def atan(x, out=None) -> DNDarray:
    return local_op(torch.atan, x, out, promote_exact=True)


arctan = atan


def atan2(t1, t2) -> DNDarray:
    """Elementwise quadrant-correct ``arctan(t1 / t2)``."""
    return binary_op(tensor_operands(torch.atan2), t1, t2, inexact=True)


arctan2 = atan2


def atanh(x, out=None) -> DNDarray:
    return local_op(torch.atanh, x, out, promote_exact=True)


arctanh = atanh


def cos(x, out=None) -> DNDarray:
    return local_op(torch.cos, x, out, promote_exact=True)


def cosh(x, out=None) -> DNDarray:
    return local_op(torch.cosh, x, out, promote_exact=True)


def deg2rad(x, out=None) -> DNDarray:
    return local_op(torch.deg2rad, x, out, promote_exact=True)


radians = deg2rad


def rad2deg(x, out=None) -> DNDarray:
    return local_op(torch.rad2deg, x, out, promote_exact=True)


degrees = rad2deg


def sin(x, out=None) -> DNDarray:
    return local_op(torch.sin, x, out, promote_exact=True)


def sinh(x, out=None) -> DNDarray:
    return local_op(torch.sinh, x, out, promote_exact=True)


def tan(x, out=None) -> DNDarray:
    return local_op(torch.tan, x, out, promote_exact=True)


def tanh(x, out=None) -> DNDarray:
    return local_op(torch.tanh, x, out, promote_exact=True)


DNDarray.cos = lambda self, out=None: cos(self, out)
DNDarray.sin = lambda self, out=None: sin(self, out)
DNDarray.tan = lambda self, out=None: tan(self, out)
DNDarray.cosh = lambda self, out=None: cosh(self, out)
DNDarray.sinh = lambda self, out=None: sinh(self, out)
DNDarray.tanh = lambda self, out=None: tanh(self, out)
