"""Ragged ownership over the canonical layout (counterpart of
``heat_tpu/core/ragged.py``).

The data stays on the ceil-rule chunks; the ragged intent ("rank ``i``
owns ``counts[i]`` positions along ``axis``") is metadata: an ``owner`` map
plus per-rank masks and blocks split as the data. :meth:`Ragged.redistribute`
rewrites ``counts`` and moves no data; :meth:`Ragged.resplit` changes the
physical split axis through :meth:`DNDarray.resplit`.
"""

from __future__ import annotations

import builtins
from typing import Optional, Sequence

import numpy as np

from .dndarray import DNDarray

__all__ = ["Ragged", "ragged"]


class Ragged:
    """A canonical-layout array carrying a ragged ownership intent:
    ``counts[i]`` positions along ``axis`` belong to rank ``i``."""

    def __init__(self, array: DNDarray, counts: Sequence[int], axis: int = 0):
        if not isinstance(array, DNDarray):
            raise TypeError(f"array must be a DNDarray, got {type(array)}")
        counts = np.asarray(counts, dtype=np.int64).reshape(-1)
        p = array.comm.size
        if counts.shape[0] != p:
            raise ValueError(f"counts must have one entry per mesh position ({p}), "
                             f"got {counts.shape[0]}")
        if (counts < 0).any():
            raise ValueError(f"counts must be non-negative, got {counts.tolist()}")
        axis = int(axis)
        if not 0 <= axis < array.ndim:
            raise ValueError(f"axis {axis} out of range for {array.ndim}-d array")
        if int(counts.sum()) != array.shape[axis]:
            raise ValueError(f"counts sum to {int(counts.sum())} but the array has "
                             f"{array.shape[axis]} positions along axis {axis}")
        self.__array = array
        self.__counts = counts
        self.__axis = axis
        self.__owner = None

    @property
    def array(self) -> DNDarray:
        """The canonical-layout data."""
        return self.__array

    @property
    def axis(self) -> int:
        return self.__axis

    @property
    def counts(self) -> np.ndarray:
        """Per-rank logical extents (a copy)."""
        return self.__counts.copy()

    @property
    def displs(self) -> np.ndarray:
        """Per-rank logical start offsets along ``axis``."""
        return np.concatenate([[0], np.cumsum(self.__counts)[:-1]])

    @property
    def owner(self) -> DNDarray:
        """``owner[j]``: the rank that logically owns index ``j`` along
        ``axis``, an int64 DNDarray split as the data's ``axis`` (built
        once)."""
        if self.__owner is None:
            from . import factories

            arr = self.__array
            vec = np.repeat(np.arange(self.__counts.shape[0], dtype=np.int64), self.__counts)
            split = 0 if arr.split == self.__axis else None
            self.__owner = factories.array(vec, split=split, device=arr.device, comm=arr.comm)
        return self.__owner

    def __repr__(self) -> str:
        return (f"Ragged(counts={self.__counts.tolist()}, axis={self.__axis}, "
                f"array=<{self.__array.shape} split={self.__array.split}>)")

    def __check(self, position) -> int:
        p = self.__counts.shape[0]
        position = builtins.int(position)
        if not 0 <= position < p:
            raise ValueError(f"position {position} out of range for {p}")
        return position

    def mask(self, position: int) -> DNDarray:
        """Boolean mask of rank ``position``'s logical indices along
        ``axis``, split as the data."""
        from . import relational

        return relational.eq(self.owner, self.__check(position))

    def block(self, position: int) -> DNDarray:
        """Rank ``position``'s logical slice along ``axis``."""
        position = self.__check(position)
        lo = builtins.int(self.displs[position])
        hi = lo + builtins.int(self.__counts[position])
        key = tuple(slice(lo, hi) if d == self.__axis else slice(None)
                    for d in range(self.__array.ndim))
        return self.__array[key]

    def redistribute(self, counts: Sequence[int]) -> "Ragged":
        """The same data with the intent rewritten to ``counts``: no data
        moves."""
        return Ragged(self.__array, counts, self.__axis)

    def resplit(self, axis: Optional[int] = None) -> "Ragged":
        """Change the physical split axis of the data (the intent is
        unchanged)."""
        return Ragged(self.__array.resplit(axis), self.__counts, self.__axis)


def ragged(blocks_or_data, counts: Optional[Sequence[int]] = None, *, axis: int = 0,
           split: Optional[int] = 0, dtype=None, device=None, comm=None) -> Ragged:
    """A :class:`Ragged` from one block per rank (concatenated along
    ``axis``; ``counts`` are their extents) or from data and an explicit
    ``counts``. The data lands on the canonical layout with ``split``
    (a DNDarray keeps its own)."""
    from . import factories
    from .communication import sanitize_comm

    comm = sanitize_comm(comm if comm is not None else (
        blocks_or_data.comm if isinstance(blocks_or_data, DNDarray) else None))
    if counts is None:
        blocks = list(blocks_or_data)
        if len(blocks) != comm.size:
            raise ValueError(f"ragged(blocks) needs one block per mesh position "
                             f"({comm.size}), got {len(blocks)}")
        blocks = [np.asarray(b) for b in blocks]
        counts = [b.shape[axis] for b in blocks]
        data = np.concatenate(blocks, axis=axis) if blocks else np.empty((0,))
        arr = factories.array(data, dtype=dtype, split=split, device=device, comm=comm)
        return Ragged(arr, counts, axis)
    if isinstance(blocks_or_data, DNDarray):
        arr = blocks_or_data if dtype is None else blocks_or_data.astype(dtype)
    else:
        arr = factories.array(np.asarray(blocks_or_data), dtype=dtype, split=split,
                              device=device, comm=comm)
    return Ragged(arr, counts, axis)
