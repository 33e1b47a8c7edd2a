"""The DNDarray: a distributed n-dimensional array over ranks.

Counterpart of ``heat_tpu/core/dndarray.py``.
The JAX package wraps one sharded, tail-padded global buffer under a single
controller. Here, as in the original Heat, a DNDarray is a per-rank object:
the global metadata, identical on every rank, plus ``larray``, the
rank-local ``torch.Tensor``. For ``split=s`` rank ``r`` holds exactly its
ceil-rule chunk of dimension ``s`` (``communication.chunk``), so there is
no pad to mask; for ``split=None`` every rank holds the whole array.
``padded_shape`` and ``pad_count`` report the JAX package's numbers (the
chunk rule's ``ceil(n/p)*p``) for layout parity; nothing is stored there.
Indexing (``x[key]``, ``x[key] = v``) goes through ``indexing``; ``lloc``
indexes this rank's chunk alone, and the halos are this rank's
neighbours' edge rows.

A DNDarray may hold a pending fused chain (:mod:`.fusion`) instead of its
tensor: every read of the tensor, ``larray`` and the class's own, flushes
it first; the shape queries (``shape``, ``lshape``, ``dtype``, ``split``,
``ndim``, ``size``, ``nbytes``, ``lnbytes``) do not.
"""

from __future__ import annotations

from typing import Optional, Tuple, Type

import numpy as np
import torch

from . import types
from .communication import TorchCommunication
from .devices import Device
from .stride_tricks import sanitize_axis

__all__ = ["DNDarray", "perf_stats", "reset_perf_stats"]

# Relayout counters (diagnostic): every resplit that changes the split axis
# is one of ``local_slices`` (replicated to split: each rank slices its
# chunk), ``gathers`` (split to replicated) or ``all_to_alls`` (between two
# split axes), and ``relayouts`` counts them all; a world of one rank moves
# nothing but still counts. The JAX package's counters (``logical_slices``,
# ``repads``, ``device_puts``) count the tail pad it stores and its
# resharding ``device_put``s; the port stores no pad, so it counts its own
# relayouts under its own names.
_PERF_STATS = {"relayouts": 0, "local_slices": 0, "gathers": 0, "all_to_alls": 0}


def _relayout_program(x: "DNDarray", axis: Optional[int]) -> torch.Tensor:
    """This rank's chunk of ``x`` distributed along ``axis`` (the registry
    program of site ``relayout``): one ``all_to_all`` between two split
    axes, else the whole array gathered and, for a split target, this
    rank's chunk of it."""
    comm, split, gshape = x.comm, x.split, x.shape
    if axis is not None and split is not None and comm.size > 1:
        return comm.all_to_all(x.larray, axis, split, gshape[axis], gshape[split]).contiguous()
    whole = x._global()
    if whole is x.larray:
        whole = whole.clone()
    if axis is not None:
        _, _, slices = comm.chunk(gshape, axis)
        whole = whole[slices]
    return whole.contiguous()


def perf_stats() -> dict:
    """A snapshot of the relayout counters (module comment)."""
    return dict(_PERF_STATS)


def reset_perf_stats() -> None:
    for k in _PERF_STATS:
        _PERF_STATS[k] = 0


class LocalIndex:
    """Indexing of this rank's chunk alone (reference dndarray.py:65): the
    result of a read is the torch tensor, and a write changes the chunk in
    place (copied first when another array shares it)."""

    def __init__(self, obj: "DNDarray"):
        self.obj = obj

    def __getitem__(self, key):
        return self.obj.larray[key]

    def __setitem__(self, key, value):
        from .indexing import _writable

        _writable(self.obj)[key] = value


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
        self.__pending = None  # a fusion.FusedNode while the chain is deferred
        self.__gshape = tuple(int(s) for s in gshape)
        self.__dtype = dtype
        self.__split = split
        self.__device = device
        self.__comm = comm
        self.__balanced = True if balanced is None else balanced
        self.__halo_prev = self.__halo_next = None

    @classmethod
    def _from_fused(cls, node, gshape, dtype, split, device, comm) -> "DNDarray":
        """A DNDarray whose tensor is ``node``'s pending chain (fusion)."""
        out = cls(None, gshape, dtype, split, device, comm, True)
        out.__pending = node
        return out

    def _fused_node(self):
        """The pending fused chain, or None."""
        return self.__pending

    def __flush(self) -> torch.Tensor:
        node, self.__pending = self.__pending, None
        self.__array = node.materialize()
        return self.__array

    # ------------------------------------------------------------------ meta

    @property
    def larray(self) -> torch.Tensor:
        """The rank-local torch tensor (reference dndarray.py:106); a pending
        fused chain is flushed first."""
        if self.__pending is not None:
            return self.__flush()
        return self.__array

    @larray.setter
    def larray(self, array: torch.Tensor) -> None:
        """Replace this rank's chunk (same local shape; internal). A pending
        chain is dropped unflushed: nothing reads it any more."""
        self.__pending = None
        self.__array = array
        self.__halo_prev = self.__halo_next = None

    @property
    def lloc(self) -> LocalIndex:
        """Indexing of this rank's chunk (reference dndarray.py:199)."""
        return LocalIndex(self)

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

    gnumel = size

    @property
    def lnumel(self) -> int:
        return int(np.prod(self.lshape, dtype=np.int64))

    def __itemsize(self) -> int:
        if self.__pending is not None:
            return self.__pending.dtype.itemsize
        return self.__array.element_size()

    @property
    def nbytes(self) -> int:
        return self.size * self.__itemsize()

    gnbytes = nbytes

    @property
    def lnbytes(self) -> int:
        return self.lnumel * self.__itemsize()

    @property
    def padded_shape(self) -> Tuple[int, ...]:
        """The JAX package's stored shape: the split dimension rounded up to
        ``ceil(n/p)*p`` (this package stores no pad)."""
        if self.__split is None:
            return self.__gshape
        s = self.__split
        return self.__gshape[:s] + (self.__comm.padded_size(self.__gshape[s]),) + \
            self.__gshape[s + 1:]

    @property
    def pad_count(self) -> int:
        """``padded_shape`` less the shape along the split dimension."""
        if self.__split is None:
            return 0
        return self.padded_shape[self.__split] - self.__gshape[self.__split]

    @property
    def real(self) -> "DNDarray":
        from . import complex_math

        return complex_math.real(self)

    @property
    def imag(self) -> "DNDarray":
        from . import complex_math

        return complex_math.imag(self)

    def stride(self) -> Tuple[int, ...]:
        """Element strides of this rank's chunk, C order."""
        return self.strides

    @property
    def strides(self) -> Tuple[int, ...]:
        """Element strides of this rank's chunk, C order (reference
        dndarray.py:933)."""
        out, acc = [], 1
        for dim in reversed(self.lshape):
            out.append(acc)
            acc *= max(dim, 1)
        return tuple(reversed(out))

    @property
    def lshape(self) -> Tuple[int, ...]:
        """Shape of this rank's chunk (reference dndarray.py:170)."""
        if self.__pending is not None:
            return self.__pending.pshape
        return tuple(self.larray.shape)

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

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __getitem__(self, key) -> "DNDarray":
        from . import indexing

        return indexing.getitem(self, key)

    def __setitem__(self, key, value) -> None:
        from . import indexing

        indexing.setitem(self, key, value)

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
            return self.larray
        return self.__comm.allgather(self.larray, self.__split, self.__gshape[self.__split])

    def numpy(self) -> np.ndarray:
        """Gather the global array to host numpy (reference `numpy`)."""
        return self._global().detach().cpu().numpy()

    def __array__(self, dtype=None, copy=None) -> np.ndarray:
        a = self.numpy()
        return a.astype(dtype) if dtype is not None else a

    def tolist(self) -> list:
        return self.numpy().tolist()

    def item(self):
        """The one element of a size-1 array as a python scalar (reference
        dndarray.py:683)."""
        if self.size != 1:
            raise ValueError("only one-element DNDarrays can be converted to python scalars")
        return self._global().reshape(()).item()

    def __cast(self, cast_function):
        if self.size == 1:
            return cast_function(self.item())
        raise TypeError("only size-1 arrays can be converted to Python scalars")

    def __bool__(self) -> bool:
        return bool(self.__cast(bool))

    def __float__(self) -> float:
        return self.__cast(float)

    def __int__(self) -> int:
        return self.__cast(int)

    __index__ = __int__

    def __complex__(self) -> complex:
        return self.__cast(complex)

    def cpu(self) -> "DNDarray":
        """A copy on the CPU (reference dndarray.py:730)."""
        from .devices import cpu

        return DNDarray(self.larray.cpu().clone(), self.__gshape, self.__dtype, self.__split,
                        cpu, self.__comm, True)

    # -------------------------------------------------------------- methods

    def astype(self, dtype, copy: bool = True) -> "DNDarray":
        """Cast to the given heat type (reference dndarray.py:424)."""
        dtype = types.canonical_heat_type(dtype)
        casted = self.larray.to(dtype.torch_type(), copy=copy)
        if copy:
            return DNDarray(casted, self.__gshape, dtype, self.__split, self.__device, self.__comm, True)
        self.__array = casted
        self.__dtype = dtype
        return self

    def resplit(self, axis: Optional[int] = None, audit: bool = False) -> "DNDarray":
        """A copy distributed along ``axis`` (reference dndarray.py:1213).
        Between two split axes it is one ``all_to_all``: each rank sends
        every other rank the block that rank will own, and no rank holds
        the whole array. ``None`` replicates: every rank gathers the whole
        array (``cdist`` uses this to replicate ``y``). Any split axis from
        a replicated array slices this rank's chunk.

        With the relayout planner armed (``HEAT_TPU_RELAYOUT_PLAN`` other
        than ``auto``, or ``HEAT_TPU_HBM_BUDGET`` set) a split-to-split
        relayout follows its plan (:mod:`.relayout_planner`): the one
        ``all_to_all`` when it fits, else bounded-memory chunk stages; every
        plan gives the same bits.

        It is a ``resplit`` span whenever a span is wanted
        (``telemetry.spanning()``), with the analytic collective kind and
        wire bytes (``telemetry.collectives.relayout_cost``) while telemetry
        records; ``audit=True`` (or ``HEAT_TPU_HLO_AUDIT=1``) also
        records the collectives it issues and compares them with the cost
        of the chunks as padded for the collective (``telemetry.hlo``); a
        decomposed plan is audited once a stage (``relayout_stage``)
        instead."""
        from .. import telemetry

        axis = sanitize_axis(self.__gshape, axis)
        comm = self.__comm
        plan = self.__plan(axis)
        cost, fields, do_audit = telemetry.op_cost(
            telemetry.collectives.relayout_cost, self.__gshape, self.__dtype.byte_size(),
            self.__split, axis, comm.size, audit=audit)
        if cost is None and not telemetry.spanning():
            return self.__relayout(axis, plan)
        with telemetry.span("resplit", old_split=self.__split, new_split=axis,
                            gshape=list(self.__gshape),
                            plan=plan.kind if plan is not None else "monolithic", **fields):
            if plan is not None:
                out = self.__relayout(axis, plan, audit=do_audit)
            elif do_audit and comm.size > 1 and axis != self.__split:
                # the collectives move the chunks padded to ceil(n/p) along
                # both split axes: predict on those shapes, as the JAX
                # package predicts on its padded physical buffer
                phys = list(self.__gshape)
                for ax in (self.__split, axis):
                    if ax is not None:
                        phys[ax] = comm.padded_size(phys[ax])
                predicted = telemetry.collectives.relayout_cost(
                    phys, self.__dtype.byte_size(), self.__split, axis, comm.size)
                out, _ = telemetry.hlo.audit_call(
                    "resplit", lambda: self.__relayout(axis), predicted=predicted,
                    fields={"old_split": self.__split, "new_split": axis,
                            "gshape": list(self.__gshape)})
            else:
                out = self.__relayout(axis)
        return out

    def __plan(self, axis: Optional[int]):
        """The relayout planner's decomposed plan for a resplit to ``axis``,
        or None for the one ``all_to_all`` (the fast path: two knob reads)."""
        from . import relayout_planner

        if not relayout_planner.active():
            return None
        plan = relayout_planner.maybe_plan(self.__gshape, self.__dtype.byte_size(),
                                           self.__split, axis, self.__comm)
        return None if plan is None or plan.kind == "monolithic" else plan

    def __relayout(self, axis: Optional[int], plan=None, audit: bool = False) -> "DNDarray":
        if axis == self.__split:
            return DNDarray(self.larray.clone(), self.__gshape, self.__dtype, axis,
                            self.__device, self.__comm, True)
        _PERF_STATS["relayouts"] += 1
        if self.__split is None:
            _PERF_STATS["local_slices"] += 1
        elif axis is None:
            _PERF_STATS["gathers"] += 1
        else:
            _PERF_STATS["all_to_alls"] += 1
        if plan is not None:
            from . import relayout_planner

            moved = relayout_planner.run(plan, self.larray, self.__comm, audit=audit)
            return DNDarray(moved, self.__gshape, self.__dtype, axis, self.__device, self.__comm,
                            True)
        from . import program_cache

        moved = program_cache.cached_program(
            "relayout", (self.__gshape, self.__dtype, self.__split, axis),
            lambda: _relayout_program, comm=self.__comm, inline=True)(self, axis)
        return DNDarray(moved, self.__gshape, self.__dtype, axis, self.__device, self.__comm,
                        True)

    def resplit_(self, axis: Optional[int] = None) -> "DNDarray":
        """Redistribute in place along ``axis`` (reference dndarray.py:764)."""
        axis = sanitize_axis(self.__gshape, axis)
        if axis != self.__split:
            moved = self.resplit(axis)
            self.__array, self.__split = moved.larray, axis
            self.__halo_prev = self.__halo_next = None
        return self

    def is_distributed(self) -> bool:
        """True if the data lies on more than one rank."""
        return self.__split is not None and self.__comm.size > 1

    def is_balanced(self, force_check: bool = False) -> bool:
        """The ceil-rule layout is balanced by construction."""
        return True

    def balance_(self) -> None:
        """Nothing to do: every array lies on the ceil-rule chunks."""
        return None

    def create_lshape_map(self, force_check: bool = False) -> np.ndarray:
        return self.lshape_map

    def redistribute_(self, lshape_map=None, target_map=None) -> None:
        """Accepted for the canonical (ceil-rule) map, which every array
        already has; another map raises, as in the JAX package
        (dndarray.py:805)."""
        if target_map is None:
            return None
        want = np.asarray(target_map)
        have = self.lshape_map
        if want.shape == have.shape and (want == have).all():
            return None
        raise NotImplementedError(
            "redistribute_ to a non-canonical (ragged) lshape_map is not supported: every "
            "array lies on the ceil-rule chunks of its split dimension. Use resplit_() to "
            "change the distribution axis")

    def fill_diagonal(self, value) -> "DNDarray":
        """Fill the main diagonal in place (reference dndarray.py:846): each
        rank writes the diagonal entries of its chunk."""
        if self.ndim != 2:
            raise ValueError("DNDarray must be 2D")
        from .indexing import _bits, _writable

        k = min(self.__gshape)
        off = self.__comm.chunk(self.__gshape, self.__split)[0] if self.__split is not None else 0
        n_local = self.lshape[self.__split] if self.__split is not None else k
        i = torch.arange(max(0, min(off + n_local, k) - off), device=self.larray.device) + off
        rows, cols = (i - off, i) if self.__split == 0 else ((i, i - off) if self.__split == 1
                                                             else (i, i))
        buf = _writable(self)
        value = torch.as_tensor(value, device=buf.device).to(buf.dtype)
        _bits(buf)[rows, cols] = _bits(value)
        self.__halo_prev = self.__halo_next = None
        return self

    # ---------------------------------------------------------------- halos

    def __check_halo_size(self, halo_size: int) -> None:
        if not isinstance(halo_size, int) or halo_size <= 0:
            raise ValueError(f"halo_size needs to be a positive integer, got {halo_size}")
        if self.__split is not None and self.__comm.size > 1:
            min_chunk = int(self.lshape_map[:, self.__split].min())
            if halo_size > min_chunk:
                raise ValueError(f"halo_size {halo_size} exceeds the smallest local chunk "
                                 f"({min_chunk}) along split {self.__split}")

    def get_halo(self, halo_size: int) -> None:
        """Fetch the edge rows of the neighbouring ranks along the split
        dimension (reference dndarray.py:896): ``halo_prev`` holds the last
        ``halo_size`` rows of the previous rank, ``halo_next`` the first of
        the next, zeros at the global edges; one permute each way."""
        self.__check_halo_size(halo_size)
        if self.__split is None or self.__comm.size == 1:
            self.__halo_prev = self.__halo_next = None
            return
        from ..parallel.halo import _halo_parts

        self.__halo_prev, self.__halo_next = _halo_parts(
            self.larray, halo_size, self.__split, self.__comm, wrap=False)

    @property
    def halo_prev(self) -> Optional[torch.Tensor]:
        """The rows received from the previous rank by the last
        :meth:`get_halo` (None before one)."""
        return self.__halo_prev

    @property
    def halo_next(self) -> Optional[torch.Tensor]:
        """The rows received from the next rank by the last :meth:`get_halo`."""
        return self.__halo_next

    def array_with_halos(self, halo_size: int) -> torch.Tensor:
        """This rank's chunk extended by ``halo_size`` rows of both
        neighbours along the split dimension (zeros at the global edges)."""
        self.__check_halo_size(halo_size)
        if self.__split is None or self.__comm.size == 1:
            return self.larray
        prev, nxt = self.__halo_prev, self.__halo_next
        if prev is None or prev.shape[self.__split] != halo_size:
            self.get_halo(halo_size)
            prev, nxt = self.__halo_prev, self.__halo_next
        return torch.cat([prev, self.larray, nxt], dim=self.__split)

    @property
    def T(self) -> "DNDarray":
        """The transpose (reference dndarray.py:302)."""
        from .linalg import transpose

        return transpose(self)
