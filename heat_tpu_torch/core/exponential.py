"""Exponential functions (counterpart of ``heat_tpu/core/exponential.py``,
the subset of this slice: exp, sqrt, log). Exact input gives its inexact
type, as in the JAX package: int64 float64, bool, uint8, int8, int16 and
int32 float32."""

from __future__ import annotations

import torch

from ._operations import local_op
from .dndarray import DNDarray

__all__ = ["exp", "log", "sqrt"]


def exp(x: DNDarray, out=None) -> DNDarray:
    return local_op(torch.exp, x, out, promote_exact=True)


def log(x: DNDarray, out=None) -> DNDarray:
    return local_op(torch.log, x, out, promote_exact=True)


def sqrt(x: DNDarray, out=None) -> DNDarray:
    return local_op(torch.sqrt, x, out, promote_exact=True)


DNDarray.exp = lambda self, out=None: exp(self, out)
DNDarray.log = lambda self, out=None: log(self, out)
DNDarray.sqrt = lambda self, out=None: sqrt(self, out)
