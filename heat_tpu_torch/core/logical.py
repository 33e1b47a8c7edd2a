"""Logical tests and reductions (counterpart of
``heat_tpu/core/logical.py``).

``all`` and ``any`` reduce the truth of each element, carried as uint8
(gloo and NCCL reduce no bool): a minimum for ``all``, a maximum for
``any``, one allreduce when the reduction crosses the split axis, and an
empty chunk contributes the neutral element.
"""

from __future__ import annotations

import builtins

import torch

from ._operations import binary_op, into, local_op, reduce_op
from .dndarray import DNDarray

__all__ = [
    "all",
    "allclose",
    "any",
    "isclose",
    "isfinite",
    "isinf",
    "isnan",
    "isneginf",
    "isposinf",
    "logical_and",
    "logical_not",
    "logical_or",
    "logical_xor",
    "signbit",
]


def _truth_reduce(reduction: str, neutral: int, x: DNDarray, axis, out, keepdims) -> DNDarray:
    truth = local_op(lambda t: (t != 0).to(torch.uint8), x)
    res = reduce_op(reduction, truth, axis, neutral=neutral, keepdims=keepdims)
    return into(res.astype(bool, copy=False), out)


def all(x: DNDarray, axis=None, out=None, keepdims: builtins.bool = False) -> DNDarray:
    """True where all elements (along ``axis``) are truthy (reference
    logical.py `all`: local all and one allreduce)."""
    return _truth_reduce("min", 1, x, axis, out, keepdims)


def any(x: DNDarray, axis=None, out=None, keepdims: builtins.bool = False) -> DNDarray:
    """True where any element (along ``axis``) is truthy (reference
    logical.py `any`)."""
    return _truth_reduce("max", 0, x, axis, out, keepdims)


def allclose(x: DNDarray, y: DNDarray, rtol: float = 1e-05, atol: float = 1e-08,
             equal_nan: builtins.bool = False) -> builtins.bool:
    """Scalar closeness test (reference logical.py:144: local isclose and
    one allreduce)."""
    res = isclose(x, y, rtol=rtol, atol=atol, equal_nan=equal_nan)
    return builtins.bool(all(res).larray.item())


def isclose(x, y, rtol: float = 1e-05, atol: float = 1e-08,
            equal_nan: builtins.bool = False) -> DNDarray:
    """Elementwise ``|x - y| <= atol + rtol |y|`` (reference logical.py:240)."""
    return binary_op(lambda a, b: torch.isclose(a, b, rtol=rtol, atol=atol, equal_nan=equal_nan),
                     x, y)


def isfinite(x) -> DNDarray:
    return local_op(torch.isfinite, x)


def isinf(x) -> DNDarray:
    return local_op(torch.isinf, x)


def isnan(x) -> DNDarray:
    return local_op(torch.isnan, x)


def isneginf(x, out=None) -> DNDarray:
    return local_op(torch.isneginf, x, out)


def isposinf(x, out=None) -> DNDarray:
    return local_op(torch.isposinf, x, out)


def logical_and(t1, t2) -> DNDarray:
    return binary_op(torch.logical_and, t1, t2)


def logical_not(t, out=None) -> DNDarray:
    return local_op(torch.logical_not, t, out)


def logical_or(t1, t2) -> DNDarray:
    return binary_op(torch.logical_or, t1, t2)


def logical_xor(t1, t2) -> DNDarray:
    return binary_op(torch.logical_xor, t1, t2)


def signbit(x, out=None) -> DNDarray:
    """True where the sign bit is set (reference logical.py `signbit`)."""
    return local_op(torch.signbit, x, out)


DNDarray.all = lambda self, axis=None, out=None, keepdims=False: all(self, axis, out, keepdims)
DNDarray.any = lambda self, axis=None, out=None, keepdims=False: any(self, axis, out, keepdims)
DNDarray.allclose = lambda self, other, rtol=1e-05, atol=1e-08, equal_nan=False: allclose(
    self, other, rtol, atol, equal_nan
)
DNDarray.isclose = lambda self, other, rtol=1e-05, atol=1e-08, equal_nan=False: isclose(
    self, other, rtol, atol, equal_nan
)
