"""Generic operation machinery.

Counterpart of ``heat_tpu/core/_operations.py`` (``binary_op`` :50,
``local_op`` :145, ``reduce_op`` :178). With fusion on (the default,
:mod:`.fusion`), ``binary_op`` and ``local_op`` defer into a pending chain
and ``reduce_op`` absorbs a pending operand's chain; each deferred call is
the very call the eager path makes. Each rank computes on its own chunk; a
reduction across the split dimension ends in one ``allreduce``, with the
neutral element standing in for an empty chunk (reference
_operations.py:401-410).

Types follow the JAX package, which runs with 64-bit types on; the result
type is computed first (:func:`result_type`) and every operand is cast to
it, so torch's own promotion decides nothing:

* arrays of any rank, 0-d ones included, and numpy scalars are typed
  strongly and join on the JAX lattice (``types.promote_types``: torch's
  own promotion, and the JAX package's table for uint16, uint32 and
  uint64); a python ``bool`` is a strong ``bool``;
* a python ``int``, ``float`` or ``complex`` is weak: it keeps the array's
  type unless its kind is higher, and then gives the 64-bit type of its
  kind (``int8 + 2`` is int8, ``bool + 2`` int64, ``int32 + 2.5`` float64,
  ``float16 + 2.5`` float16, ``float32 + 1j`` complex64);
* true division and ``exp``/``sqrt``/``log`` make an exact result type
  inexact: int64 and uint64 give float64, bool, uint8, uint16, uint32,
  int8, int16 and int32 give float32. So ``int32 / 2`` and ``sqrt(bool)``
  give float32, while ``bool / 2`` gives float64 (``bool`` joined with a
  python int is int64).

torch has few kernels for uint16, uint32 and uint64 (on the card no
``add``, ``mul``, comparison, ``amax``, ``where`` or ``sort``), so every
operation on them runs on the signed type of their width
(:func:`_apply`), in one of three ways that the caller names:

* ``"bits"`` (add, subtract, multiply, negate, power, the bitwise
  operations, the left shift, the cumulative sum and product): two's
  complement gives the same bits modulo 2^w, so the operation runs on the
  bits as the signed type and its result is read back as unsigned;
* ``"order"`` (comparisons, ``maximum``/``minimum``, ``clip``, ``max``/
  ``min``, ``argmax``/``argmin``, sort keys): the bits with the sign bit
  flipped (:func:`order_key`) order as the unsigned values do;
* ``"value"`` (floor division, remainder, the right shift): uint16 and
  uint32 widen to int64 and wrap back modulo 2^w; the routines of
  :data:`_VALUE` divide and shift such values and uint64 bits as unsigned
  (a zero divisor gives the quotient all ones and the remainder 0, as
  ``jnp``'s do).

Sums and products reduce unsigned types as uint64, exact modulo 2^64 as
the reference's are.
"""

from __future__ import annotations

import builtins
import functools
from typing import Any, Callable, Optional, Tuple, Type, Union

import numpy as np
import torch

from . import sanitation, types
from .dndarray import DNDarray
from .stride_tricks import broadcast_shape, sanitize_axis

__all__ = ["binary_op", "cum_op", "into", "local_op", "reduce_op", "result_type", "tensor_operands"]

_SCALARS = (builtins.int, builtins.float, builtins.bool, builtins.complex, np.generic)
# the inexact type of each exact one, as jnp's true_divide and
# transcendental functions choose it
_INEXACT = {
    torch.bool: torch.float32, torch.uint8: torch.float32, torch.int8: torch.float32,
    torch.int16: torch.float32, torch.int32: torch.float32, torch.int64: torch.float64,
    torch.uint16: torch.float32, torch.uint32: torch.float32, torch.uint64: torch.float64,
}
_UNSIGNED = (torch.uint8, torch.uint16, torch.uint32, torch.uint64)
# the unsigned types for which torch lacks most kernels, and their widths
_WIDTH = {torch.uint16: 16, torch.uint32: 32, torch.uint64: 64}
# the signed type of the same width, whose kernels compute on their bits
_SIGNED = {torch.uint16: torch.int16, torch.uint32: torch.int32, torch.uint64: torch.int64}


def _sign_bit(dtype: torch.dtype) -> builtins.int:
    return -(1 << (_WIDTH[dtype] - 1))


def order_key(t: torch.Tensor) -> torch.Tensor:
    """A tensor that orders as ``t``'s values do: for uint16, uint32 and
    uint64 their bits as the signed type of the width with the sign bit
    flipped; any other tensor is its own key."""
    if t.dtype not in _WIDTH:
        return t
    return t.view(_SIGNED[t.dtype]) ^ _sign_bit(t.dtype)


def from_order_key(k: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The values of type ``dtype`` whose :func:`order_key` is ``k``."""
    if dtype not in _WIDTH:
        return k
    return (k ^ _sign_bit(dtype)).view(dtype)


def _widen(t: torch.Tensor) -> torch.Tensor:
    """The values of a uint16 or uint32 tensor in int64."""
    return t.view(_SIGNED[t.dtype]).to(torch.int64) & ((1 << _WIDTH[t.dtype]) - 1)


def _wrap(r: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """An int64 tensor modulo 2^w as the unsigned type ``dtype``."""
    return r.to(_SIGNED[dtype]).view(dtype)


_U64_MAX_SIGNED = (1 << 63) - 1


def _u64_divmod(a: torch.Tensor, b: torch.Tensor):
    """Quotient and remainder of uint64 values given as their int64 bits.
    For a divisor below 2^63 the halved dividend is divided as a signed
    value, doubled, and corrected once (the remainder is then below twice
    the divisor); a divisor from 2^63 up goes at most once. A zero divisor
    gives the quotient all ones and the remainder 0, as ``jnp``'s do."""
    a, b = torch.broadcast_tensors(a, torch.as_tensor(b, dtype=torch.int64, device=a.device))
    big = b < 0
    zero = b == 0
    bs = torch.where(big | zero, torch.ones_like(b), b)
    q = (((a >> 1) & _U64_MAX_SIGNED) // bs) << 1
    r = a - q * bs
    more = ((r ^ _sign_bit(torch.uint64)) >= (bs ^ _sign_bit(torch.uint64))).to(torch.int64)
    q, r = q + more, r - more * bs
    once = ((a ^ _sign_bit(torch.uint64)) >= (b ^ _sign_bit(torch.uint64))).to(torch.int64)
    q = torch.where(big, once, q)
    r = torch.where(big, a - once * b, r)
    return torch.where(zero, torch.full_like(q, -1), q), torch.where(zero, torch.zeros_like(r), r)


def _u64_right_shift(a: torch.Tensor, s) -> torch.Tensor:
    """The logical right shift of uint64 bits ``a`` by ``s``: one shift
    that clears the sign, then an arithmetic shift of a non-negative
    value."""
    s = torch.as_tensor(s, dtype=torch.int64, device=a.device)
    half = ((a >> 1) & _U64_MAX_SIGNED) >> (s - 1).clamp(min=0)
    return torch.where(s <= 0, a, half)


# the "value" operations on uint64 bits in int64 (uint16 and uint32 values
# widened to int64 are such bits too)
_VALUE = {
    torch.floor_divide: lambda a, b: _u64_divmod(a, b)[0],
    torch.remainder: lambda a, b: _u64_divmod(a, b)[1],
    torch.fmod: lambda a, b: _u64_divmod(a, b)[1],
    torch.bitwise_right_shift: _u64_right_shift,
}


def _apply(operation: Callable, *operands, unsigned: str = "bits") -> torch.Tensor:
    """``operation(*operands)``. Operands of a limited unsigned type (all of
    one type: the caller casts them to the result type first) go through
    the signed type of their width as ``unsigned`` names (``"bits"``,
    ``"order"`` or ``"value"``, the module docstring); a python int beside
    them is mapped as they are."""
    limited = [o.dtype for o in operands if isinstance(o, torch.Tensor) and o.dtype in _WIDTH]
    if not limited:
        return operation(*operands)
    dtype = limited[0]
    width, signed = _WIDTH[dtype], _SIGNED[dtype]
    if unsigned == "value":
        if operation not in _VALUE:
            raise TypeError(f"no unsigned form of {operation!r}")
        operation = _VALUE[operation]

        def enter(o):
            if isinstance(o, torch.Tensor) and o.dtype == dtype:
                return o.view(signed) if dtype == torch.uint64 else _widen(o)
            return o

        def leave(r):
            return r.view(dtype) if dtype == torch.uint64 else _wrap(r, dtype)
    elif unsigned == "order":
        def enter(o):
            if isinstance(o, torch.Tensor) and o.dtype == dtype:
                return order_key(o)
            if isinstance(o, (builtins.int, np.integer)) and not isinstance(o, builtins.bool):
                # a number past the type's range wraps into it, as the JAX package casts it
                return builtins.int(o) % (1 << width) + _sign_bit(dtype)
            return o

        def leave(r):
            return from_order_key(r, dtype) if r.dtype == signed else r
    elif unsigned == "bits":
        def enter(o):
            if isinstance(o, torch.Tensor) and o.dtype == dtype:
                return o.view(signed)
            if isinstance(o, (builtins.int, np.integer)) and not isinstance(o, builtins.bool):
                return (builtins.int(o) - _sign_bit(dtype)) % (1 << width) + _sign_bit(dtype)
            return o

        def leave(r):
            return r.view(dtype) if r.dtype == signed else r
    else:
        raise ValueError(f"unsigned must be 'bits', 'order' or 'value', got {unsigned!r}")
    return leave(operation(*(enter(o) for o in operands)))


def _is_exact(t: torch.Tensor) -> bool:
    return not (t.is_floating_point() or t.is_complex())


def _join_weak(dtype: torch.dtype, scalar) -> torch.dtype:
    """``dtype`` joined with a weakly typed python number."""
    exact = dtype in _INEXACT
    if isinstance(scalar, builtins.int):  # bool was taken as a strong type
        return torch.int64 if dtype == torch.bool else dtype
    if isinstance(scalar, builtins.float):
        return torch.float64 if exact else dtype
    if dtype.is_complex:
        return dtype
    if exact or dtype == torch.float64:
        return torch.complex128
    return torch.complex64


def result_type(*operands) -> torch.dtype:
    """The JAX package's result type of an elementwise operation on
    ``operands`` (tensors, numpy scalars and python numbers; at least one
    tensor), as the module docstring states it."""
    strong = [x.dtype for x in operands if isinstance(x, torch.Tensor)]
    strong += [types.canonical_heat_type(x.dtype).torch_type() for x in operands
               if isinstance(x, np.generic)]
    strong += [torch.bool for x in operands if isinstance(x, builtins.bool)]
    dtype = strong[0]
    for other in strong[1:]:
        dtype = types.promote_types(dtype, other).torch_type()
    for x in operands:
        if isinstance(x, (builtins.int, builtins.float, builtins.complex)) and not isinstance(
                x, builtins.bool):
            dtype = _join_weak(dtype, x)
    return dtype


def _cast(x, dtype: torch.dtype):
    if isinstance(x, torch.Tensor):
        return x.to(dtype)
    if isinstance(x, np.generic):
        return x.item()  # its type has been joined: now a plain number of it
    return x


@functools.lru_cache(maxsize=None)
def tensor_operands(operation: Callable) -> Callable:
    """``operation`` for torch functions that take no python number (such
    as ``hypot``, ``atan2``, ``maximum``): a number operand becomes a 0-d
    tensor of the other operand's type, on the host beside a card's tensor
    (torch's elementwise kernels read a 0-d host tensor as a scalar, where a
    copy of a pageable number to the card would wait for the stream). One
    function per ``operation``, allowlisted for fusion."""
    def scalar(v, like):
        return torch.tensor(v, dtype=like.dtype, device="cpu" if like.is_cuda else like.device)

    def apply(a, b):
        if not isinstance(a, torch.Tensor):
            a = scalar(a, b)
        if not isinstance(b, torch.Tensor):
            b = scalar(b, a)
        return operation(a, b)

    from . import fusion

    name = getattr(operation, "__qualname__", None) or getattr(operation, "__name__", "")
    return fusion.register_elementwise(
        apply, f"tensor_operands({getattr(operation, '__module__', '')}.{name})")


def into(res: DNDarray, out: Optional[DNDarray]) -> DNDarray:
    """``res``, or, given an ``out`` buffer of ``res``'s shape, split and
    device, ``res`` copied into it in ``out``'s type."""
    if out is None:
        return res
    from . import fusion

    sanitation.sanitize_out(out, res.shape, res.split, res.device)
    value = res.larray.to(out.dtype.torch_type())
    fusion.before_write(out.larray)
    out.larray.copy_(value)
    return out


def _as_operand(x, like: DNDarray):
    if isinstance(x, (DNDarray,) + _SCALARS):
        return x
    from . import factories

    return factories.array(x, device=like.device, comm=like.comm)


def binary_op(
    operation: Callable,
    t1,
    t2,
    out: Optional[DNDarray] = None,
    inexact: bool = False,
    unsigned: str = "bits",
) -> DNDarray:
    """Elementwise binary operation with broadcasting and split
    reconciliation (reference _operations.py:25-181). A replicated operand
    that spans the output's split dimension is cut to this rank's chunk; a
    split operand of size 1 along its split axis is gathered whole and
    broadcasts. The result's split is an operand's split, as in the JAX
    package. ``inexact`` makes an exact result type inexact, as true
    division and jnp's ``hypot``, ``arctan2``, ``logaddexp`` do.
    ``unsigned`` names how the operation sees uint16, uint32 and uint64
    (:func:`_apply`)."""
    arrays = [a for a in (t1, t2) if isinstance(a, DNDarray)]
    if not arrays:
        raise TypeError(f"expected at least one DNDarray operand, got {type(t1)}, {type(t2)}")
    t1 = _as_operand(t1, arrays[0])
    t2 = _as_operand(t2, arrays[0])
    comm, device = arrays[0].comm, arrays[0].device

    shape1 = t1.shape if isinstance(t1, DNDarray) else ()
    shape2 = t2.shape if isinstance(t2, DNDarray) else ()
    out_shape = broadcast_shape(shape1, shape2)
    ndim_out = len(out_shape)

    def out_split_of(a):
        if not isinstance(a, DNDarray) or a.split is None:
            return None
        return a.split + (ndim_out - a.ndim)

    s1, s2 = out_split_of(t1), out_split_of(t2)
    if s1 is not None and s2 is not None and s1 != s2:
        raise ValueError(
            f"operands are distributed along different axes (splits {t1.split}/{t2.split}); "
            f"resplit one operand first"
        )
    out_split = s1 if s1 is not None else s2
    if out is None:
        from . import fusion

        res = fusion.defer_binary(operation, t1, t2, s1, s2, out_shape, out_split, inexact,
                                  unsigned, comm, device)
        if res is not None:
            return res

    def local(a, s):
        if not isinstance(a, DNDarray):
            return a
        if s is not None and a.shape[a.split] != out_shape[s]:
            # size 1 along its split axis: it broadcasts like a replicated
            # operand, so every rank takes all of it (the one row or column)
            return a._global()
        buf = a.larray
        if out_split is not None and a.split is None:
            own_dim = out_split - (ndim_out - a.ndim)
            if own_dim >= 0 and buf.shape[own_dim] == out_shape[out_split] and out_shape[out_split] != 1:
                _, _, slices = comm.chunk(out_shape, out_split)
                buf = buf.narrow(own_dim, slices[out_split].start,
                                 slices[out_split].stop - slices[out_split].start)
        return buf

    a, b = local(t1, s1), local(t2, s2)
    dtype = result_type(a, b)
    if inexact:
        dtype = _INEXACT.get(dtype, dtype)
    result = _apply(operation, _cast(a, dtype), _cast(b, dtype), unsigned=unsigned)

    res = DNDarray(result, out_shape, types.canonical_heat_type(result.dtype), out_split,
                   device, comm, True)
    return into(res, out)


def local_op(
    operation: Callable,
    x: DNDarray,
    out: Optional[DNDarray] = None,
    promote_exact: bool = False,
    unsigned: str = "bits",
) -> DNDarray:
    """Elementwise operation, independent on every rank (reference
    _operations.py:281-352). ``promote_exact`` casts exact input to its
    inexact type first (int64 to float64, the narrower ones and bool to
    float32), as the JAX package's transcendental functions do.
    ``unsigned`` is :func:`_apply`'s."""
    sanitation.sanitize_in(x)
    if out is None:
        from . import fusion

        res = fusion.defer_local(operation, x, promote_exact, unsigned)
        if res is not None:
            return res
    buf = x.larray
    if promote_exact:
        buf = buf.to(_INEXACT.get(buf.dtype, buf.dtype))
    result = _apply(operation, buf, unsigned=unsigned)
    res = DNDarray(result, x.shape, types.canonical_heat_type(result.dtype), x.split,
                   x.device, x.comm, True)
    return into(res, out)


_ALLREDUCE = {"sum": "sum", "prod": "prod", "max": "max", "min": "min", "nansum": "sum",
              "nanprod": "prod"}


def reduce_op(
    reduction: str,
    x: DNDarray,
    axis: Union[int, Tuple[int, ...], None],
    neutral: Any,
    out: Optional[DNDarray] = None,
    keepdims: bool = False,
    dtype: Optional[Type[types.datatype]] = None,
) -> DNDarray:
    """Reduction ``reduction`` in ``{"sum", "prod", "max", "min", "nansum",
    "nanprod"}`` (reference _operations.py:355-478): local reduce, then one
    allreduce when the reduction crosses the split dimension. An empty chunk
    contributes the neutral element; the nan-variants count a NaN as it.
    Sums and products of exact types are taken in 64 bits, as numpy's and
    the JAX package's are (unsigned input gives uint64)."""
    sanitation.sanitize_in(x)
    axes = sanitize_axis(x.shape, axis)
    if axes is None:
        red_axes = tuple(range(x.ndim))
    elif isinstance(axes, builtins.int):
        red_axes = (axes,)
    else:
        red_axes = tuple(axes)

    split = x.split
    crosses_split = split is not None and split in red_axes
    if split is None or crosses_split:
        out_split = None
    elif keepdims:
        out_split = split
    else:
        out_split = split - sum(1 for a in red_axes if a < split)
    if keepdims:
        out_gshape = tuple(1 if d in red_axes else s for d, s in enumerate(x.shape))
    else:
        out_gshape = tuple(s for d, s in enumerate(x.shape) if d not in red_axes)

    from . import fusion

    local = functools.partial(_reduce_local, reduction=reduction, red_axes=red_axes,
                              keepdims=keepdims, neutral=neutral)
    node = fusion.absorbing(x)
    if node is not None:
        result = fusion.absorb(node, "fusion_reduce",
                               ("reduce", reduction, red_axes, bool(keepdims), repr(neutral)),
                               local, op=reduction, axes=list(red_axes),
                               crosses_split=crosses_split)
    else:
        result = local(x.larray)
    xdtype = x.dtype.torch_type()
    unsigned = xdtype in _UNSIGNED
    if crosses_split:
        result = x.comm.allreduce(result.contiguous(), _ALLREDUCE[reduction])
    if reduction in ("max", "min"):
        result = from_order_key(result, xdtype)
    if reduction in ("sum", "prod", "nansum", "nanprod") and unsigned:
        result = result.view(torch.uint64)  # the reference reduces unsigned types as uint64
    if dtype is not None:
        result = result.to(types.canonical_heat_type(dtype).torch_type())

    res = DNDarray(result, out_gshape, types.canonical_heat_type(result.dtype), out_split,
                   x.device, x.comm, True)
    return into(res, out)


def _reduce_local(buf: torch.Tensor, *, reduction: str, red_axes: Tuple[int, ...],
                  keepdims: bool, neutral) -> torch.Tensor:
    """The local part of :func:`reduce_op` on this rank's chunk: the
    reduction before the allreduce, max and min on their order keys."""
    if reduction in ("nansum", "nanprod") and buf.is_floating_point():
        buf = torch.where(torch.isnan(buf), neutral, buf)
    if reduction in ("sum", "prod", "nansum", "nanprod"):
        if buf.dtype == torch.uint64:
            buf = buf.view(torch.int64)  # the same bits: sums and products agree modulo 2^64
        elif buf.dtype == torch.bool or (_is_exact(buf) and buf.dtype != torch.int64):
            buf = buf.to(torch.int64)  # numpy/JAX x64 reduce small ints as int64
        if not red_axes:
            result = buf.clone()
        elif reduction in ("sum", "nansum"):
            result = torch.sum(buf, dim=red_axes, keepdim=keepdims)
        else:
            result = buf
            for d in sorted(red_axes, reverse=True):
                result = torch.prod(result, dim=d, keepdim=keepdims)
    else:
        fn = torch.amax if reduction == "max" else torch.amin
        keyed = order_key(buf)  # max and min of the wide unsigned types on their order keys
        if buf.numel() == 0:
            shape = tuple(1 if d in red_axes else s for d, s in enumerate(buf.shape)) if keepdims \
                else tuple(s for d, s in enumerate(buf.shape) if d not in red_axes)
            result = order_key(torch.full(shape, neutral, dtype=buf.dtype, device=buf.device))
        else:
            result = fn(keyed, dim=red_axes, keepdim=keepdims) if red_axes else keyed.clone()
    return result


def cum_op(
    operation: str,
    x: DNDarray,
    axis: int,
    out: Optional[DNDarray] = None,
    dtype: Optional[Type[types.datatype]] = None,
) -> DNDarray:
    """Cumulative ``"sum"`` or ``"prod"`` along ``axis`` (the JAX package's
    ``cum_op``, _operations.py:256; the original Heat's local scan +
    exclusive scan + combine). Off the split axis it is local. Along it,
    each rank scans its chunk, the ranks' last slices are gathered, and each
    rank combines those of the ranks before it, in rank order, with its own
    scan. Types are the JAX package's: every type keeps its own (bool
    accumulates in int64); ``dtype`` casts the result."""
    sanitation.sanitize_in(x)
    axis = sanitize_axis(x.shape, axis)
    if not isinstance(axis, builtins.int):
        raise TypeError(f"axis must be an integer, got {axis!r}")
    buf = x.larray
    unsigned = buf.dtype in _WIDTH
    if unsigned:  # the sums and products of the bits wrap as the unsigned values do
        buf = buf.view(_SIGNED[buf.dtype])
    elif buf.dtype == torch.bool:
        buf = buf.to(torch.int64)
    scan = torch.cumsum if operation == "sum" else torch.cumprod
    # along the last axis of a contiguous copy: torch's scan along a strided
    # axis of a large array is ~1000x slower on the card than along rows
    result = scan(buf.movedim(axis, -1).contiguous(), dim=-1, dtype=buf.dtype) \
        .movedim(-1, axis).contiguous()
    comm = x.comm
    if x.split == axis and comm.size > 1:
        neutral = 0 if operation == "sum" else 1
        shape = list(result.shape)
        shape[axis] = 1
        last = result.narrow(axis, result.shape[axis] - 1, 1) if result.shape[axis] else \
            torch.full(shape, neutral, dtype=result.dtype, device=result.device)
        lasts = comm.allgather(last.contiguous(), axis, comm.size)
        carry = torch.full(shape, neutral, dtype=result.dtype, device=result.device)
        for r in range(comm.rank):
            piece = lasts.narrow(axis, r, 1)
            carry = carry + piece if operation == "sum" else carry * piece
        result = result + carry if operation == "sum" else result * carry
    if unsigned:
        result = result.view(x.larray.dtype)
    if dtype is not None:
        result = result.to(types.canonical_heat_type(dtype).torch_type())
    res = DNDarray(result, x.shape, types.canonical_heat_type(result.dtype), x.split,
                   x.device, comm, True)
    return into(res, out)
