"""Arithmetic operations (counterpart of ``heat_tpu/core/arithmetics.py``,
all 35 names).

Every function is one of the op wrappers of ``_operations``: ``binary_op``
and ``local_op`` with the JAX package's result types, ``reduce_op`` (local
reduce + one allreduce across ranks) and ``cum_op`` (local scan + the
exclusive carry of the ranks before). ``diff`` along the split axis fetches
the ``n`` rows after its chunk from the next ranks (its halo) and differences
locally.
"""

from __future__ import annotations

import builtins

import torch

from . import types
from ._operations import _apply, binary_op, cum_op, local_op, reduce_op, tensor_operands
from .dndarray import DNDarray
from .stride_tricks import sanitize_axis

__all__ = [
    "add",
    "bitwise_and",
    "bitwise_not",
    "bitwise_or",
    "bitwise_xor",
    "cumprod",
    "cumproduct",
    "copysign",
    "cumsum",
    "diff",
    "div",
    "divide",
    "floordiv",
    "floor_divide",
    "fmod",
    "hypot",
    "invert",
    "left_shift",
    "mod",
    "mul",
    "multiply",
    "nanprod",
    "nansum",
    "neg",
    "negative",
    "pos",
    "positive",
    "pow",
    "power",
    "prod",
    "remainder",
    "right_shift",
    "sub",
    "subtract",
    "sum",
]


def add(t1, t2, out=None) -> DNDarray:
    """Elementwise addition."""
    return binary_op(torch.add, t1, t2, out)


def _check_int_or_bool(*ts):
    for t in ts:
        if isinstance(t, DNDarray) and not issubclass(t.dtype, (types.integer, types.bool)):
            raise TypeError(f"operation not supported for input type {t.dtype}")
        if isinstance(t, builtins.float):
            raise TypeError("operation not supported for float scalars")


def bitwise_and(t1, t2, out=None) -> DNDarray:
    _check_int_or_bool(t1, t2)
    return binary_op(torch.bitwise_and, t1, t2, out)


def bitwise_or(t1, t2, out=None) -> DNDarray:
    _check_int_or_bool(t1, t2)
    return binary_op(torch.bitwise_or, t1, t2, out)


def bitwise_xor(t1, t2, out=None) -> DNDarray:
    _check_int_or_bool(t1, t2)
    return binary_op(torch.bitwise_xor, t1, t2, out)


def bitwise_not(t, out=None) -> DNDarray:
    _check_int_or_bool(t)
    return local_op(torch.bitwise_not, t, out)


invert = bitwise_not


def cumprod(a: DNDarray, axis: int, dtype=None, out=None) -> DNDarray:
    """Cumulative product along axis."""
    return cum_op("prod", a, axis, out=out, dtype=dtype)


cumproduct = cumprod


def cumsum(a: DNDarray, axis: int, dtype=None, out=None) -> DNDarray:
    """Cumulative sum along axis."""
    return cum_op("sum", a, axis, out=out, dtype=dtype)


def _diff(t: torch.Tensor, n: int, axis: int) -> torch.Tensor:
    """``n``-th difference of a tensor; bool takes ``!=`` as numpy does."""
    for _ in range(n):
        hi, lo = t.narrow(axis, 1, max(t.shape[axis] - 1, 0)), t.narrow(
            axis, 0, max(t.shape[axis] - 1, 0))
        t = hi != lo if t.dtype == torch.bool else _apply(torch.sub, hi, lo)
    return t


def diff(a: DNDarray, n: int = 1, axis: int = -1) -> DNDarray:
    """The ``n``-th discrete difference along ``axis``. Off the split axis it
    is local. Along it each rank needs the input rows ``[o0, o1 + n)`` for
    its result chunk ``[o0, o1)`` (the result's own chunk rule): it fetches
    the rows it lacks from their owners in one exchange and differences
    locally."""
    if n == 0:
        return a
    if n < 0:
        raise ValueError(f"order must be non-negative but was {n}")
    axis = sanitize_axis(a.shape, axis)
    gshape = tuple(max(s - n, 0) if d == axis else s for d, s in enumerate(a.shape))
    comm = a.comm
    if a.split != axis or comm.size == 1:
        data = _diff(a.larray, n, axis)
    else:
        from .indexing import _fetch_rows

        length, dev = a.shape[axis], a.larray.device

        def wanted(q):
            start, lshape, _ = comm.chunk(gshape, axis, rank=q)
            stop = start + lshape[axis] + n if lshape[axis] else start
            return torch.arange(start, min(stop, length), dtype=torch.int64, device=dev)

        rows = _fetch_rows(a.larray.movedim(axis, 0), length, comm, wanted)
        data = _diff(rows, n, 0).movedim(0, axis)
    return DNDarray(data.contiguous(), gshape, types.canonical_heat_type(data.dtype), a.split,
                    a.device, comm, True)


def div(t1, t2, out=None) -> DNDarray:
    """Elementwise true division (an exact result type becomes inexact:
    int64 float64, the narrower ones and bool float32)."""
    return binary_op(torch.true_divide, t1, t2, out, inexact=True)


divide = div


def floordiv(t1, t2, out=None) -> DNDarray:
    """Elementwise division rounded toward minus infinity."""
    return binary_op(torch.floor_divide, t1, t2, out, unsigned="value")


floor_divide = floordiv


def fmod(t1, t2, out=None) -> DNDarray:
    """Elementwise C-style remainder (the sign of the dividend)."""
    return binary_op(torch.fmod, t1, t2, out, unsigned="value")


def left_shift(t1, t2, out=None) -> DNDarray:
    _check_int_or_bool(t1)
    return binary_op(torch.bitwise_left_shift, t1, t2, out)


def mod(t1, t2, out=None) -> DNDarray:
    """Elementwise python-style modulo (the sign of the divisor)."""
    return binary_op(torch.remainder, t1, t2, out, unsigned="value")


remainder = mod


def mul(t1, t2, out=None) -> DNDarray:
    """Elementwise multiplication."""
    return binary_op(torch.mul, t1, t2, out)


multiply = mul


def neg(t, out=None) -> DNDarray:
    """Elementwise negation."""
    return local_op(torch.neg, t, out)


negative = neg


def pos(t, out=None) -> DNDarray:
    """Elementwise ``+t``."""
    return local_op(torch.positive, t, out)


positive = pos


def pow(t1, t2, out=None) -> DNDarray:
    """Elementwise power."""
    return binary_op(torch.pow, t1, t2, out)


power = pow


def prod(a: DNDarray, axis=None, out=None, keepdims: bool = False) -> DNDarray:
    """Product of the elements over axis (local product + one allreduce)."""
    return reduce_op("prod", a, axis, neutral=1, out=out, keepdims=keepdims)


def nanprod(a: DNDarray, axis=None, out=None, keepdims: bool = False) -> DNDarray:
    """Product counting NaN as 1; exact types cannot hold NaN and take
    :func:`prod`."""
    if not a.dtype.torch_type().is_floating_point:
        return prod(a, axis, out=out, keepdims=keepdims)
    return reduce_op("nanprod", a, axis, neutral=1, out=out, keepdims=keepdims)


def nansum(a: DNDarray, axis=None, out=None, keepdims: bool = False) -> DNDarray:
    """Sum counting NaN as 0; exact types take :func:`sum`."""
    if not a.dtype.torch_type().is_floating_point:
        return sum(a, axis, out=out, keepdims=keepdims)
    return reduce_op("nansum", a, axis, neutral=0, out=out, keepdims=keepdims)


def right_shift(t1, t2, out=None) -> DNDarray:
    _check_int_or_bool(t1)
    return binary_op(torch.bitwise_right_shift, t1, t2, out, unsigned="value")


def sub(t1, t2, out=None) -> DNDarray:
    """Elementwise subtraction."""
    return binary_op(torch.sub, t1, t2, out)


subtract = sub


def sum(a: DNDarray, axis=None, out=None, keepdims: bool = False) -> DNDarray:
    """Sum of elements over axis (local sum + one allreduce)."""
    return reduce_op("sum", a, axis, neutral=0, out=out, keepdims=keepdims)


def copysign(a, b, out=None) -> DNDarray:
    """The magnitude of ``a`` with the sign of ``b`` (inexact result)."""
    return binary_op(tensor_operands(torch.copysign), a, b, out, inexact=True)


def hypot(a, b, out=None) -> DNDarray:
    """Elementwise ``sqrt(a**2 + b**2)`` (inexact result)."""
    return binary_op(tensor_operands(torch.hypot), a, b, out, inexact=True)


DNDarray.__add__ = lambda self, other: add(self, other)
DNDarray.__radd__ = lambda self, other: add(other, self)
DNDarray.__iadd__ = lambda self, other: add(self, other)
DNDarray.__sub__ = lambda self, other: sub(self, other)
DNDarray.__rsub__ = lambda self, other: sub(other, self)
DNDarray.__isub__ = lambda self, other: sub(self, other)
DNDarray.__mul__ = lambda self, other: mul(self, other)
DNDarray.__rmul__ = lambda self, other: mul(other, self)
DNDarray.__imul__ = lambda self, other: mul(self, other)
DNDarray.__truediv__ = lambda self, other: div(self, other)
DNDarray.__rtruediv__ = lambda self, other: div(other, self)
DNDarray.__itruediv__ = lambda self, other: div(self, other)
DNDarray.__floordiv__ = lambda self, other: floordiv(self, other)
DNDarray.__rfloordiv__ = lambda self, other: floordiv(other, self)
DNDarray.__mod__ = lambda self, other: mod(self, other)
DNDarray.__rmod__ = lambda self, other: mod(other, self)
DNDarray.__pow__ = lambda self, other: pow(self, other)
DNDarray.__rpow__ = lambda self, other: pow(other, self)
DNDarray.__neg__ = lambda self: neg(self)
DNDarray.__pos__ = lambda self: pos(self)
DNDarray.__invert__ = lambda self: bitwise_not(self)
DNDarray.__and__ = lambda self, other: bitwise_and(self, other)
DNDarray.__rand__ = lambda self, other: bitwise_and(other, self)
DNDarray.__or__ = lambda self, other: bitwise_or(self, other)
DNDarray.__ror__ = lambda self, other: bitwise_or(other, self)
DNDarray.__xor__ = lambda self, other: bitwise_xor(self, other)
DNDarray.__rxor__ = lambda self, other: bitwise_xor(other, self)
DNDarray.__lshift__ = lambda self, other: left_shift(self, other)
DNDarray.__rshift__ = lambda self, other: right_shift(self, other)

DNDarray.sum = lambda self, axis=None, out=None, keepdims=False: sum(self, axis, out, keepdims)
DNDarray.prod = lambda self, axis=None, out=None, keepdims=False: prod(self, axis, out, keepdims)
DNDarray.cumsum = lambda self, axis, dtype=None, out=None: cumsum(self, axis, dtype, out)
DNDarray.cumprod = lambda self, axis, dtype=None, out=None: cumprod(self, axis, dtype, out)
