"""Memory layout helpers (counterpart of ``heat_tpu/core/memory.py``).

``copy`` is a deep copy of this rank's chunk. ``sanitize_memory_layout``
checks the order and returns its input, as the JAX package does: the
port's operations take any strides, so no re-striding is needed.
"""

from __future__ import annotations

from .dndarray import DNDarray

__all__ = ["copy", "sanitize_memory_layout"]


def copy(x: DNDarray) -> DNDarray:
    """Deep copy (reference memory.py:13)."""
    if not isinstance(x, DNDarray):
        raise TypeError(f"input needs to be a DNDarray, but was {type(x)}")
    return DNDarray(x.larray.clone(), x.shape, x.dtype, x.split, x.device, x.comm, True)


def sanitize_memory_layout(x, order: str = "C"):
    """Accepted for API parity (reference memory.py:42 re-strides torch
    tensors)."""
    if order not in ("C", "F"):
        raise ValueError(f"invalid memory layout {order!r}, expected 'C' or 'F'")
    return x
