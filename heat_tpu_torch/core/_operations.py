"""Generic operation machinery.

Counterpart of ``heat_tpu/core/_operations.py`` (``binary_op`` :50,
``local_op`` :145, ``reduce_op`` :178), dispatched eagerly with no fusion
engine. Each rank computes on its own chunk; a reduction across the split
dimension ends in one ``allreduce``, with the neutral element standing in
for an empty chunk (reference _operations.py:401-410).

Types follow the JAX package, which runs with 64-bit types on: integer
operands of a true division or of ``exp``/``sqrt``/``log`` give float64,
and a python float combined with an integer array gives float64 (torch
alone would give float32).
"""

from __future__ import annotations

import builtins
from typing import Any, Callable, Optional, Tuple, Type, Union

import numpy as np
import torch

from . import sanitation, types
from .dndarray import DNDarray
from .stride_tricks import broadcast_shape, sanitize_axis

__all__ = ["binary_op", "local_op", "reduce_op"]

_SCALARS = (builtins.int, builtins.float, builtins.bool, np.generic)


def _is_exact(t: torch.Tensor) -> bool:
    return not (t.is_floating_point() or t.is_complex())


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
    true_divide: bool = False,
) -> DNDarray:
    """Elementwise binary operation with broadcasting and split
    reconciliation (reference _operations.py:25-181). A replicated operand
    that spans the output's split dimension is cut to this rank's chunk."""
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
    for a, s in ((t1, s1), (t2, s2)):
        if s is not None and a.shape[a.split] != out_shape[s]:
            raise NotImplementedError("broadcasting along the split dimension is not supported")

    def local(a):
        if not isinstance(a, DNDarray):
            return a
        buf = a.larray
        if out_split is not None and a.split is None:
            own_dim = out_split - (ndim_out - a.ndim)
            if own_dim >= 0 and buf.shape[own_dim] == out_shape[out_split] and out_shape[out_split] != 1:
                _, _, slices = comm.chunk(out_shape, out_split)
                buf = buf.narrow(own_dim, slices[out_split].start,
                                 slices[out_split].stop - slices[out_split].start)
        return buf

    a, b = local(t1), local(t2)
    # the JAX package's 64-bit promotion where torch's default would differ
    tensors = [x for x in (a, b) if isinstance(x, torch.Tensor)]
    float_scalar = any(isinstance(x, (builtins.float, np.floating)) for x in (a, b))
    if all(_is_exact(x) for x in tensors) and (true_divide or float_scalar):
        a, b = (x.to(torch.float64) if isinstance(x, torch.Tensor) else x for x in (a, b))
    result = operation(a, b)

    res = DNDarray(result, out_shape, types.canonical_heat_type(result.dtype), out_split,
                   device, comm, True)
    if out is not None:
        sanitation.sanitize_out(out, out_shape, out_split, device)
        out.larray.copy_(result.to(out.dtype.torch_type()))
        return out
    return res


def local_op(
    operation: Callable,
    x: DNDarray,
    out: Optional[DNDarray] = None,
    promote_exact: bool = False,
) -> DNDarray:
    """Elementwise operation, independent on every rank (reference
    _operations.py:281-352). ``promote_exact`` casts integer input to
    float64 first, as the JAX package's transcendental functions do."""
    sanitation.sanitize_in(x)
    buf = x.larray
    if promote_exact and _is_exact(buf):
        buf = buf.to(torch.float64)
    result = operation(buf)
    res = DNDarray(result, x.shape, types.canonical_heat_type(result.dtype), x.split,
                   x.device, x.comm, True)
    if out is not None:
        sanitation.sanitize_out(out, x.shape, x.split, x.device)
        out.larray.copy_(result.to(out.dtype.torch_type()))
        return out
    return res


def reduce_op(
    reduction: str,
    x: DNDarray,
    axis: Union[int, Tuple[int, ...], None],
    neutral: Any,
    out: Optional[DNDarray] = None,
    keepdims: bool = False,
    dtype: Optional[Type[types.datatype]] = None,
) -> DNDarray:
    """Reduction ``reduction`` in ``{"sum", "max", "min"}`` (reference
    _operations.py:355-478): local reduce, then one allreduce when the
    reduction crosses the split dimension. An empty chunk contributes the
    neutral element."""
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

    buf = x.larray
    if reduction == "sum":
        if buf.dtype == torch.bool or (_is_exact(buf) and buf.dtype != torch.int64):
            buf = buf.to(torch.int64)  # numpy/JAX x64 sums small ints as int64
        result = torch.sum(buf, dim=red_axes, keepdim=keepdims) if red_axes else buf.clone()
    else:
        fn = torch.amax if reduction == "max" else torch.amin
        if buf.numel() == 0:
            shape = tuple(1 if d in red_axes else s for d, s in enumerate(buf.shape)) if keepdims \
                else tuple(s for d, s in enumerate(buf.shape) if d not in red_axes)
            result = torch.full(shape, neutral, dtype=buf.dtype, device=buf.device)
        else:
            result = fn(buf, dim=red_axes, keepdim=keepdims) if red_axes else buf.clone()
    if crosses_split:
        result = x.comm.allreduce(result.contiguous(), reduction)
    if dtype is not None:
        result = result.to(types.canonical_heat_type(dtype).torch_type())

    res = DNDarray(result, out_gshape, types.canonical_heat_type(result.dtype), out_split,
                   x.device, x.comm, True)
    if out is not None:
        sanitation.sanitize_out(out, out_gshape, out_split, x.device)
        out.larray.copy_(result.to(out.dtype.torch_type()))
        return out
    return res
