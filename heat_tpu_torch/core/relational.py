"""Elementwise comparisons (counterpart of ``heat_tpu/core/relational.py``).
Both operands are cast to their joined type (``_operations.result_type``)
and the result is bool."""

from __future__ import annotations

import torch

from ._operations import binary_op
from .dndarray import DNDarray

__all__ = [
    "eq",
    "equal",
    "ge",
    "greater",
    "greater_equal",
    "gt",
    "le",
    "less",
    "less_equal",
    "lt",
    "ne",
    "not_equal",
]


def eq(t1, t2) -> DNDarray:
    """Elementwise == (reference relational.py `eq`)."""
    return binary_op(torch.eq, t1, t2)


def equal(t1, t2) -> bool:
    """True if both arrays have the same global shape and all elements are
    equal (reference relational.py `equal`: resplit, local compare and one
    allreduce)."""
    from . import factories, logical

    if not isinstance(t1, DNDarray):
        t1 = factories.array(t1)
    if not isinstance(t2, DNDarray):
        t2 = factories.array(t2, device=t1.device, comm=t1.comm)
    if t1.shape != t2.shape:
        return False
    if t1.split != t2.split:
        t2 = t2.resplit(t1.split)
    return bool(logical.all(eq(t1, t2)).larray.item())


def ge(t1, t2) -> DNDarray:
    return binary_op(torch.ge, t1, t2, unsigned="order")


greater_equal = ge


def gt(t1, t2) -> DNDarray:
    return binary_op(torch.gt, t1, t2, unsigned="order")


greater = gt


def le(t1, t2) -> DNDarray:
    return binary_op(torch.le, t1, t2, unsigned="order")


less_equal = le


def lt(t1, t2) -> DNDarray:
    return binary_op(torch.lt, t1, t2, unsigned="order")


less = lt


def ne(t1, t2) -> DNDarray:
    return binary_op(torch.ne, t1, t2)


not_equal = ne


DNDarray.__eq__ = lambda self, other: eq(self, other)
DNDarray.__ne__ = lambda self, other: ne(self, other)
DNDarray.__lt__ = lambda self, other: lt(self, other)
DNDarray.__le__ = lambda self, other: le(self, other)
DNDarray.__gt__ = lambda self, other: gt(self, other)
DNDarray.__ge__ = lambda self, other: ge(self, other)
DNDarray.__hash__ = None
