"""Rounding and absolute-value operations (counterpart of
``heat_tpu/core/rounding.py``).

The types are the JAX package's: ``floor``, ``ceil``, ``trunc`` and
``round`` keep an exact type (the values are already whole), ``modf``
makes it inexact (int64 float64, the narrower ones float32), ``fabs`` makes
an integer float32, ``clip`` joins the array's type with its bounds as an
elementwise operation does (``clip(int32, 0.5, 2.5)`` is float64), and
``sign`` of a bool array raises ``TypeError``.
"""

from __future__ import annotations

import builtins
import functools

import torch

from . import types
from ._operations import _UNSIGNED, _apply, into, local_op, result_type
from .dndarray import DNDarray

__all__ = ["abs", "absolute", "ceil", "clip", "fabs", "floor", "modf", "round", "sign", "trunc"]


def _exact(t: torch.Tensor) -> builtins.bool:
    return not (t.is_floating_point() or t.is_complex())


@functools.lru_cache(maxsize=None)
def _whole(fn):
    """``fn`` on inexact data; exact data is whole already and is copied.
    One function per ``fn``, allowlisted for fusion."""
    from . import fusion

    def whole(t):
        return t.clone() if _exact(t) else fn(t)

    return fusion.register_elementwise(whole, f"_whole({fn.__module__}.{fn.__name__})")


def abs(x, out=None, dtype=None) -> DNDarray:
    """Elementwise absolute value (reference rounding.py `abs`); a bool or
    unsigned array is its own absolute value."""
    dt = x.dtype.torch_type()
    whole = dt == torch.bool or dt in _UNSIGNED
    res = local_op(torch.clone if whole else torch.abs, x)
    if dtype is not None:
        res = res.astype(types.canonical_heat_type(dtype), copy=False)
    return into(res, out)


absolute = abs


def ceil(x, out=None) -> DNDarray:
    return local_op(_whole(torch.ceil), x, out)


def clip(x: DNDarray, min, max, out=None) -> DNDarray:
    """Clip values to [min, max] (reference rounding.py `clip`); either
    bound may be None."""
    if min is None and max is None:
        raise ValueError("either min or max must be set")
    if out is None:
        from . import fusion

        res = fusion.defer_unary("clip", _clip, x, {"lo": min, "hi": max})
        if res is not None:
            return res
    res = _clip(None, x.larray, lo=min, hi=max)
    return into(DNDarray(res, x.shape, types.canonical_heat_type(res.dtype), x.split, x.device,
                         x.comm, True), out)


def _clip(_, buf: torch.Tensor, *, lo, hi) -> torch.Tensor:
    bounds = [b for b in (lo, hi) if b is not None]
    return _apply(torch.clamp, buf.to(result_type(buf, *bounds)), lo, hi, unsigned="order")


def fabs(x, out=None) -> DNDarray:
    """Float absolute value (reference rounding.py `fabs`): integers give
    float32."""
    res = abs(x)
    if issubclass(res.dtype, types.integer):
        res = res.astype(types.float32, copy=False)
    return into(res, out)


def floor(x, out=None) -> DNDarray:
    return local_op(_whole(torch.floor), x, out)


def modf(x: DNDarray, out=None):
    """Fractional and integral parts (reference rounding.py `modf`), each
    in the inexact type of ``x``: the integral part is ``x`` rounded toward
    zero and the fractional part ``x`` less it."""
    intg = local_op(torch.trunc, x, promote_exact=True)
    frac = DNDarray(x.larray.to(intg.larray.dtype) - intg.larray, x.shape, intg.dtype, x.split,
                    x.device, x.comm, True)
    if out is not None:
        if not isinstance(out, tuple) or len(out) != 2:
            raise TypeError("expected out to be None or a tuple of two DNDarrays")
        return into(frac, out[0]), into(intg, out[1])
    return frac, intg


def round(x: DNDarray, decimals: int = 0, out=None, dtype=None) -> DNDarray:
    """Round half to even to ``decimals`` digits (reference rounding.py
    `round`). Exact data is whole already; with ``decimals < 0`` it raises,
    as in the JAX package."""

    def op(t):
        if not _exact(t):
            return torch.round(t, decimals=decimals)
        if decimals < 0:
            raise NotImplementedError("integer round is not implemented for decimals < 0")
        return t.clone()

    res = local_op(op, x)
    if dtype is not None:
        res = res.astype(types.canonical_heat_type(dtype), copy=False)
    return into(res, out)


def sign(x, out=None) -> DNDarray:
    """Elementwise sign indicator (-1, 0 or 1 in the type of ``x``)."""
    if isinstance(x, DNDarray) and x.dtype is types.bool:
        raise TypeError("sign is not defined for bool arrays")
    if x.larray.dtype in _UNSIGNED:  # on the bits of the wide ones: a value is 0 or positive
        return local_op(lambda t: (t != 0).to(t.dtype), x, out)
    return local_op(torch.sign, x, out)


def trunc(x, out=None) -> DNDarray:
    return local_op(_whole(torch.trunc), x, out)


DNDarray.__abs__ = lambda self: abs(self)
DNDarray.abs = lambda self, out=None, dtype=None: abs(self, out, dtype)
DNDarray.ceil = lambda self, out=None: ceil(self, out)
DNDarray.clip = lambda self, a_min=None, a_max=None, out=None: clip(self, a_min, a_max, out)
DNDarray.fabs = lambda self, out=None: fabs(self, out)
DNDarray.floor = lambda self, out=None: floor(self, out)
DNDarray.modf = lambda self, out=None: modf(self, out)
DNDarray.round = lambda self, decimals=0, out=None, dtype=None: round(self, decimals, out, dtype)
DNDarray.trunc = lambda self, out=None: trunc(self, out)
