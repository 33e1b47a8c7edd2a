"""Statistical reductions (counterpart of ``heat_tpu/core/statistics.py``,
the subset of this slice: mean, var, std, min, max).

``mean`` and ``var`` route the f32 axis-0 reduction of a 2-D array through
the moments kernel exactly where the JAX package routes them through its
Pallas kernel (``statistics.py:616-628`` and ``:912-924`` there): one read
of X gives mean and M2, and across ranks the closed-form merge takes two
allreduces. Every other case takes the plain reduction path. A kernel
failure raises; nothing falls back.
"""

from __future__ import annotations

import builtins

from . import arithmetics, exponential, types
from ._operations import reduce_op
from .dndarray import DNDarray
from .stride_tricks import sanitize_axis

__all__ = ["max", "mean", "min", "std", "var"]


def _neutral_extreme(x: DNDarray, is_max: bool):
    if issubclass(x.dtype, types.integer):
        info = types.iinfo(x.dtype)
        return info.min if is_max else info.max
    if issubclass(x.dtype, types.bool):
        return not is_max
    return -float("inf") if is_max else float("inf")


def _reduced_count(x: DNDarray, axis) -> int:
    if axis is None:
        return x.size
    axes = (axis,) if isinstance(axis, builtins.int) else tuple(axis)
    n = 1
    for a in axes:
        n *= x.shape[a]
    return n


def _column_moments(x: DNDarray):
    """(mean, M2) of a 2-D f32 array over axis 0 from the moments kernel,
    merged across ranks; None when the kernel's gate does not admit ``x``."""
    from .cuda_moments import column_moments, pallas_moments_applicable, sharded_merge

    if not (x.ndim == 2 and x.split in (None, 0)):
        return None
    if not pallas_moments_applicable(x.comm.size, x.split, x.ndim, 0, x.shape[1],
                                     x.dtype.torch_type()):
        return None
    buf = x.larray.contiguous()
    mu, m2 = column_moments(buf)
    if x.comm.size > 1 and x.split == 0:
        mu, m2 = sharded_merge(x.comm, buf.shape[0], mu, m2, x.shape[0])
    return mu, m2


def _replicated(t, like: DNDarray) -> DNDarray:
    return DNDarray(t, tuple(t.shape), types.canonical_heat_type(t.dtype), None,
                    like.device, like.comm, True)


def max(x: DNDarray, axis=None, out=None, keepdims: bool = False) -> DNDarray:
    """Maximum along axis (reference `max`: local max + Allreduce MAX)."""
    return reduce_op("max", x, axis, neutral=_neutral_extreme(x, True), out=out, keepdims=keepdims)


def min(x: DNDarray, axis=None, out=None, keepdims: bool = False) -> DNDarray:
    """Minimum along axis (reference `min`: local min + Allreduce MIN)."""
    return reduce_op("min", x, axis, neutral=_neutral_extreme(x, False), out=out, keepdims=keepdims)


def mean(x: DNDarray, axis=None, keepdims_internal: bool = False, keepdims: bool = False) -> DNDarray:
    """Arithmetic mean (reference `mean`). The f32 axis-0 2-D case goes
    through the moments kernel, as :func:`var` does."""
    if axis == 0 and not keepdims and not keepdims_internal and isinstance(x, DNDarray):
        moments = _column_moments(x)
        if moments is not None:
            return _replicated(moments[0], x)
    keep = keepdims or keepdims_internal
    s = arithmetics.sum(x, axis, keepdims=keep)
    n = _reduced_count(x, sanitize_axis(x.shape, axis) if axis is not None else None)
    return arithmetics.div(s, n)


def var(x: DNDarray, axis=None, ddof: int = 0, keepdims: bool = False) -> DNDarray:
    """Variance (reference `var`). The f32 axis-0 2-D case is
    ``M2 / (n - ddof)`` from the moments kernel; elsewhere two passes."""
    if not isinstance(ddof, builtins.int):
        raise ValueError(f"ddof must be integer, is {type(ddof)}")
    if ddof not in (0, 1):
        raise ValueError("Heat currently supports ddof of 0 or 1 only")
    if axis == 0 and not keepdims and isinstance(x, DNDarray):
        moments = _column_moments(x)
        if moments is not None:
            return _replicated(moments[1] / (x.shape[0] - ddof), x)
    mu = mean(x, axis, keepdims_internal=True)
    d = arithmetics.sub(x, mu)
    sq = arithmetics.mul(d, d)
    s = arithmetics.sum(sq, axis, keepdims=keepdims)
    n = _reduced_count(x, sanitize_axis(x.shape, axis) if axis is not None else None)
    return arithmetics.div(s, n - ddof)


def std(x: DNDarray, axis=None, ddof: int = 0, keepdims: bool = False) -> DNDarray:
    """Standard deviation (reference `std`)."""
    return exponential.sqrt(var(x, axis, ddof=ddof, keepdims=keepdims))


DNDarray.max = lambda self, axis=None, out=None, keepdims=False: max(self, axis, out, keepdims)
DNDarray.min = lambda self, axis=None, out=None, keepdims=False: min(self, axis, out, keepdims)
DNDarray.mean = lambda self, axis=None, keepdims=False: mean(self, axis, keepdims=keepdims)
DNDarray.std = lambda self, axis=None, ddof=0, keepdims=False: std(self, axis, ddof, keepdims)
DNDarray.var = lambda self, axis=None, ddof=0, keepdims=False: var(self, axis, ddof, keepdims)
