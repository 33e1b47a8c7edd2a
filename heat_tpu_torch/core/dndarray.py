"""The DNDarray: a distributed n-dimensional array over ranks.

Counterpart of ``heat_tpu/core/dndarray.py`` (the subset this slice needs).
The JAX package wraps one sharded, tail-padded global buffer under a single
controller. Here, as in the original Heat, a DNDarray is a per-rank object:
the global metadata, identical on every rank, plus ``larray``, the
rank-local ``torch.Tensor``. For ``split=s`` rank ``r`` holds exactly its
ceil-rule chunk of dimension ``s`` (``communication.chunk``), so there is
no pad to mask; for ``split=None`` every rank holds the whole array.
"""

from __future__ import annotations

from typing import Optional, Tuple, Type

import numpy as np
import torch

from . import types
from .communication import TorchCommunication
from .devices import Device
from .stride_tricks import sanitize_axis

__all__ = ["DNDarray"]


class DNDarray:
    """Distributed N-Dimensional array (reference dndarray.py:38).

    Parameters
    ----------
    array : torch.Tensor
        This rank's chunk (the whole array when ``split`` is None).
    gshape : tuple of int
        Global shape.
    dtype : heat type
    split : int or None
        The distributed dimension; None = every rank holds all of it.
    device : Device
    comm : TorchCommunication
    balanced : bool
        Kept for API parity; the ceil-rule layout is always balanced.
    """

    def __init__(
        self,
        array: torch.Tensor,
        gshape: Tuple[int, ...],
        dtype: Type[types.datatype],
        split: Optional[int],
        device: Device,
        comm: TorchCommunication,
        balanced: Optional[bool] = True,
    ):
        self.__array = array
        self.__gshape = tuple(int(s) for s in gshape)
        self.__dtype = dtype
        self.__split = split
        self.__device = device
        self.__comm = comm
        self.__balanced = True if balanced is None else balanced

    # ------------------------------------------------------------------ meta

    @property
    def larray(self) -> torch.Tensor:
        """The rank-local torch tensor (reference dndarray.py:106)."""
        return self.__array

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.__gshape

    gshape = shape

    @property
    def dtype(self) -> Type[types.datatype]:
        return self.__dtype

    @property
    def split(self) -> Optional[int]:
        return self.__split

    @property
    def device(self) -> Device:
        return self.__device

    @property
    def comm(self) -> TorchCommunication:
        return self.__comm

    @property
    def balanced(self) -> bool:
        return self.__balanced

    @property
    def ndim(self) -> int:
        return len(self.__gshape)

    @property
    def size(self) -> int:
        return int(np.prod(self.__gshape, dtype=np.int64)) if self.__gshape else 1

    @property
    def lshape(self) -> Tuple[int, ...]:
        """Shape of this rank's chunk (reference dndarray.py:170)."""
        return tuple(self.__array.shape)

    @property
    def lshape_map(self) -> np.ndarray:
        """(world size, ndim) map of every rank's chunk shape (reference
        dndarray.py:222)."""
        return self.__comm.lshape_map(self.__gshape, self.__split)

    def counts_displs(self) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
        """Per-rank counts/displacements along the split dimension."""
        if self.__split is None:
            raise ValueError("Non-distributed DNDarray has no counts and displacements")
        return self.__comm.counts_displs(self.__gshape[self.__split])

    def __len__(self) -> int:
        if not self.__gshape:
            raise TypeError("len() of unsized DNDarray")
        return self.__gshape[0]

    def __repr__(self) -> str:
        """The values, type, device and split, as the JAX package prints
        them (``printing.__str__``); a collective across ranks, which
        gathers only the edge items of an array above the threshold."""
        from . import printing

        return printing.__str__(self)

    __str__ = __repr__

    # ---------------------------------------------------------- conversions

    def _global(self) -> torch.Tensor:
        """The whole global array on this rank's device (gathered along the
        split dimension when distributed)."""
        if self.__split is None or self.__comm.size == 1:
            return self.__array
        return self.__comm.allgather(self.__array, self.__split, self.__gshape[self.__split])

    def numpy(self) -> np.ndarray:
        """Gather the global array to host numpy (reference `numpy`)."""
        return self._global().detach().cpu().numpy()

    # -------------------------------------------------------------- methods

    def astype(self, dtype, copy: bool = True) -> "DNDarray":
        """Cast to the given heat type (reference dndarray.py:424)."""
        dtype = types.canonical_heat_type(dtype)
        casted = self.__array.to(dtype.torch_type(), copy=copy)
        if copy:
            return DNDarray(casted, self.__gshape, dtype, self.__split, self.__device, self.__comm, True)
        self.__array = casted
        self.__dtype = dtype
        return self

    def resplit(self, axis: Optional[int] = None) -> "DNDarray":
        """A copy distributed along ``axis`` (reference dndarray.py:1213).
        Between two split axes it is one ``all_to_all``: each rank sends
        every other rank the block that rank will own, and no rank holds
        the whole array. ``None`` replicates: every rank gathers the whole
        array (``cdist`` uses this to replicate ``y``). Any split axis from
        a replicated array slices this rank's chunk."""
        axis = sanitize_axis(self.__gshape, axis)
        if axis == self.__split:
            return DNDarray(self.__array.clone(), self.__gshape, self.__dtype, axis,
                            self.__device, self.__comm, True)
        if axis is not None and self.__split is not None and self.__comm.size > 1:
            moved = self.__comm.all_to_all(self.__array, axis, self.__split, self.__gshape[axis],
                                           self.__gshape[self.__split])
            return DNDarray(moved.contiguous(), self.__gshape, self.__dtype, axis,
                            self.__device, self.__comm, True)
        whole = self._global()
        if whole is self.__array:
            whole = whole.clone()
        if axis is not None:
            _, _, slices = self.__comm.chunk(self.__gshape, axis)
            whole = whole[slices]
        return DNDarray(whole.contiguous(), self.__gshape, self.__dtype, axis,
                        self.__device, self.__comm, True)

    @property
    def T(self) -> "DNDarray":
        """The transpose (reference dndarray.py:302)."""
        from .linalg import transpose

        return transpose(self)
