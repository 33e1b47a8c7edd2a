"""Shape/axis helpers (counterpart of ``heat_tpu/core/stride_tricks.py``)."""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np

__all__ = ["broadcast_shape", "sanitize_axis", "sanitize_shape", "sanitize_slice"]


def broadcast_shape(shape_a: Sequence[int], shape_b: Sequence[int]) -> Tuple[int, ...]:
    """Broadcast two shapes per numpy rules, raising ValueError on mismatch."""
    try:
        return tuple(np.broadcast_shapes(tuple(shape_a), tuple(shape_b)))
    except ValueError:
        raise ValueError(
            f"operands could not be broadcast, input shapes {tuple(shape_a)} {tuple(shape_b)}"
        ) from None


def sanitize_axis(
    shape: Sequence[int], axis: Union[int, Sequence[int], None]
) -> Union[int, Tuple[int, ...], None]:
    """Validate and wrap an axis (or tuple of axes) into [0, ndim)."""
    ndim = len(shape)
    if axis is None:
        return None
    if isinstance(axis, (list, tuple, np.ndarray)):
        out = []
        for a in axis:
            if not isinstance(a, (int, np.integer)):
                raise TypeError(f"axis must be None or int or tuple of ints, got {axis!r}")
            a = int(a)
            if a < -ndim or a >= max(ndim, 1):
                raise ValueError(f"axis {a} is out of bounds for {ndim}-dimensional array")
            out.append(a % max(ndim, 1))
        if len(set(out)) != len(out):
            raise ValueError("duplicate axes given")
        return tuple(out)
    if isinstance(axis, (int, np.integer)):
        axis = int(axis)
        if ndim == 0 and axis in (-1, 0):
            return 0
        if axis < -ndim or axis >= max(ndim, 1):
            raise ValueError(f"axis {axis} is out of bounds for {ndim}-dimensional array")
        return axis % max(ndim, 1)
    raise TypeError(f"axis must be None or int or tuple of ints, got {type(axis)}")


def sanitize_shape(shape: Union[int, Sequence[int]], lval: int = 0) -> Tuple[int, ...]:
    """Validate a shape specifier into a tuple of ints >= lval."""
    if isinstance(shape, (int, np.integer)):
        shape = (int(shape),)
    elif np.isscalar(shape):
        raise TypeError("expected sequence object with length >= 0 or a single integer")
    shape = tuple(shape)
    for dim in shape:
        if not isinstance(dim, (int, np.integer)):
            raise TypeError(f"expected integer dimensions, got {type(dim)}")
        if int(dim) < lval:
            raise ValueError(f"negative dimensions are not allowed, got {dim}")
    return tuple(int(d) for d in shape)


def sanitize_slice(sl: slice, max_dim: int) -> slice:
    """``sl`` with explicit start, stop and step for a dimension of length
    ``max_dim``."""
    if not isinstance(sl, slice):
        raise TypeError("can only be used for slices")
    return slice(*sl.indices(max_dim))
