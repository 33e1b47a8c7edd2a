"""The row-split sparse array (counterpart of
``heat_tpu/sparse/container.py``).

A :class:`SparseDNDarray` is a CSR matrix split along its rows by the ceil
rule, ``r = comm.chunk_size(m)`` rows a rank, with the JAX package's shard
layout on each rank:

* ``indptr``: ``(r + 1,)`` int32 row pointers relative to the shard, also
  where the rank holds fewer than ``r`` rows or none (the pad rows hold no
  element);
* ``indices`` (int32 column ids) and ``values``: ``(cap,)`` each, with
  ``cap = max(1, max(counts))`` on every rank; the slots past
  ``counts[rank]`` are pad (column 0, value 0) that no row reaches;
* ``counts`` and ``displs``: one element tally a rank, replicated numpy.

Every operation reads the first ``counts[rank]`` slots of the live rows
only, so a pad slot never reaches a result. The local sum product runs on
``torch``'s CSR tensor (cuSPARSE on the card), built once per type and
kept; the other reductions gather and reduce by segment.
"""

from __future__ import annotations

import builtins
import warnings
from typing import Optional, Tuple, Type

import numpy as np
import torch

from ..core import types
from ..core._operations import _INEXACT, _UNSIGNED, _apply, result_type
from ..core.communication import TorchCommunication, sanitize_comm
from ..core.devices import Device, sanitize_device
from ..core.dndarray import DNDarray

__all__ = ["SparseDNDarray"]


class SparseDNDarray:
    """Distributed CSR matrix, row-split (module docstring for the layout).

    Build it with :func:`heat_tpu_torch.sparse.csr_from_dense` or
    :func:`~heat_tpu_torch.sparse.csr_from_coo`, or with
    :meth:`from_shard_arrays` from this rank's shard arrays.
    """

    def __init__(
        self,
        indptr: torch.Tensor,
        indices: torch.Tensor,
        values: torch.Tensor,
        gshape: Tuple[int, int],
        dtype: Type[types.datatype],
        counts: np.ndarray,
        device: Device,
        comm: TorchCommunication,
    ):
        m, n = (int(s) for s in gshape)
        if m <= 0 or n <= 0:
            raise ValueError(f"sparse shape must be positive, got {gshape}")
        p = comm.size
        r = comm.chunk_size(m)
        counts = np.asarray(counts, dtype=np.int64).reshape(-1)
        if counts.shape[0] != p:
            raise ValueError(f"counts must have one entry per mesh position ({p}), "
                             f"got {counts.shape[0]}")
        if (counts < 0).any():
            raise ValueError(f"counts must be non-negative: {counts.tolist()}")
        if tuple(indptr.shape) != (r + 1,):
            raise ValueError(f"indptr shape {tuple(indptr.shape)} != ({r + 1},) for gshape "
                             f"{gshape} on {p} ranks")
        if indices.shape != values.shape or indices.ndim != 1:
            raise ValueError(f"indices/values must be matching 1-D buffers, got "
                             f"{tuple(indices.shape)} vs {tuple(values.shape)}")
        cap = indices.shape[0]
        if int(counts.max(initial=0)) > cap:
            raise ValueError(f"counts {counts.tolist()} exceed the per-shard capacity {cap}")
        self.__indptr = indptr
        self.__indices = indices
        self.__values = values
        self.__gshape = (m, n)
        self.__dtype = dtype
        self.__counts = counts
        self.__device = device
        self.__comm = comm
        self.__owner = None
        self.__csr = {}

    # -- metadata -------------------------------------------------------------

    @property
    def shape(self) -> Tuple[int, int]:
        return self.__gshape

    @property
    def ndim(self) -> int:
        return 2

    @property
    def split(self) -> int:
        """Always 0: CSR's rows are its distribution axis."""
        return 0

    @property
    def dtype(self) -> Type[types.datatype]:
        return self.__dtype

    @property
    def device(self) -> Device:
        return self.__device

    @property
    def comm(self) -> TorchCommunication:
        return self.__comm

    @property
    def indptr(self) -> torch.Tensor:
        """This rank's ``(r + 1,)`` int32 row pointers."""
        return self.__indptr

    @property
    def indices(self) -> torch.Tensor:
        """This rank's ``(cap,)`` int32 column ids."""
        return self.__indices

    @property
    def values(self) -> torch.Tensor:
        """This rank's ``(cap,)`` element values."""
        return self.__values

    @property
    def counts(self) -> np.ndarray:
        """Per-rank element tallies (a copy)."""
        return self.__counts.copy()

    @property
    def displs(self) -> np.ndarray:
        """Per-rank element start offsets into the global element order."""
        return np.concatenate([[0], np.cumsum(self.__counts)[:-1]])

    @property
    def nnz(self) -> int:
        return int(self.__counts.sum())

    @property
    def capacity(self) -> int:
        """The per-rank element capacity, the same on every rank."""
        return int(self.__indices.shape[0])

    @property
    def row_chunk(self) -> int:
        """Rows a rank (ceil rule): ``indptr``'s length minus one."""
        return self.__comm.chunk_size(self.__gshape[0])

    @property
    def lrows(self) -> int:
        """The rows this rank holds (fewer than ``row_chunk`` on a tail
        rank)."""
        return self.__comm.counts_displs(self.__gshape[0])[0][self.__comm.rank]

    @property
    def lnnz(self) -> int:
        """The elements this rank holds: ``counts[rank]``."""
        return int(self.__counts[self.__comm.rank])

    @property
    def density(self) -> float:
        m, n = self.__gshape
        return self.nnz / float(m * n)

    @property
    def owner(self) -> DNDarray:
        """``owner[i]``: the rank holding row ``i``, an int64 DNDarray split
        along 0 (built once)."""
        if self.__owner is None:
            from ..core import factories

            vec = np.minimum(np.arange(self.__gshape[0], dtype=np.int64) // max(self.row_chunk, 1),
                             self.__comm.size - 1)
            self.__owner = factories.array(vec, split=0, device=self.__device, comm=self.__comm)
        return self.__owner

    def __repr__(self) -> str:
        m, n = self.__gshape
        return (f"SparseDNDarray(shape=({m}, {n}), nnz={self.nnz}, "
                f"density={self.density:.4g}, dtype={self.__dtype.__name__}, "
                f"split=0, mesh={self.__comm.size}, cap={self.capacity})")

    # -- construction helpers -------------------------------------------------

    @classmethod
    def from_shard_arrays(cls, indptr: torch.Tensor, indices: torch.Tensor, values: torch.Tensor,
                          gshape: Tuple[int, int], counts: np.ndarray, device=None, comm=None,
                          dtype=None) -> "SparseDNDarray":
        """Wrap this rank's shard arrays (``indptr`` ``(r + 1,)``,
        ``indices`` and ``values`` ``(cap,)``) with the replicated
        ``counts``."""
        comm = sanitize_comm(comm)
        device = sanitize_device(device)
        ht_dtype = dtype if dtype is not None else types.canonical_heat_type(values.dtype)
        return cls(indptr, indices, values, tuple(gshape), ht_dtype, counts, device, comm)

    @classmethod
    def _from_host_csr_shards(cls, indptr: np.ndarray, indices: np.ndarray, values: np.ndarray,
                              gshape: Tuple[int, int], counts: np.ndarray, device=None, comm=None,
                              dtype=None) -> "SparseDNDarray":
        """This rank's row of host per-shard blocks (``indptr`` ``(p, r +
        1)``, ``indices`` and ``values`` ``(p, cap)``) onto its device."""
        comm = sanitize_comm(comm)
        device = sanitize_device(device)
        tdev = device.torch_device
        s = comm.rank
        vals = np.ascontiguousarray(values[s])
        ht_dtype = dtype if dtype is not None else types.canonical_heat_type(vals.dtype)
        return cls(
            torch.from_numpy(np.ascontiguousarray(indptr[s], dtype=np.int32)).to(tdev),
            torch.from_numpy(np.ascontiguousarray(indices[s], dtype=np.int32)).to(tdev),
            torch.from_numpy(vals).to(tdev).to(ht_dtype.torch_type()),
            tuple(gshape), ht_dtype, counts, device, comm)

    # -- the local rows -------------------------------------------------------

    def _slot_rows(self) -> torch.Tensor:
        """The local row (int64) of each of this rank's live slots."""
        ip = self.__indptr[: self.lrows + 1].to(torch.int64)
        return torch.repeat_interleave(torch.arange(self.lrows, device=ip.device), ip.diff(),
                                       output_size=self.lnnz)

    def _csr(self, dt: torch.dtype) -> Optional[torch.Tensor]:
        """The live rows as a ``torch.sparse_csr_tensor`` with values in
        ``dt``, built once per type and kept (None on a rank with no
        rows)."""
        if dt not in self.__csr:
            live, c = self.lrows, self.lnnz
            if live == 0:
                self.__csr[dt] = None
            else:
                with warnings.catch_warnings():
                    warnings.filterwarnings("ignore", message="Sparse CSR tensor support")
                    warnings.filterwarnings("ignore", message="Sparse invariant checks")
                    self.__csr[dt] = torch.sparse_csr_tensor(
                        self.__indptr[: live + 1], self.__indices[:c], self.__values[:c].to(dt),
                        size=(live, self.__gshape[1]), check_invariants=False)
        return self.__csr[dt]

    # -- conversions ----------------------------------------------------------

    def to_dense(self) -> DNDarray:
        """The dense row-split DNDarray (:func:`heat_tpu_torch.sparse.to_dense`)."""
        from . import ops

        return ops.to_dense(self)

    def coo(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Host COO triplets ``(rows, cols, values)`` in global CSR order,
        gathered from every rank (an inspection path)."""
        c = self.lnnz
        offset = self.__comm.rank * self.row_chunk
        mine = ((self._slot_rows() + offset).cpu().numpy(),
                self.__indices[:c].to(torch.int64).cpu().numpy(),
                _host(self.__values[:c]))
        parts = self.__comm.allgather_object(mine)
        return tuple(np.concatenate([part[i] for part in parts]) for i in range(3))

    # -- structural ops -------------------------------------------------------

    def transpose(self) -> "SparseDNDarray":
        from . import ops

        return ops.transpose(self)

    @property
    def T(self) -> "SparseDNDarray":
        return self.transpose()

    # -- elementwise scalar ops on values -------------------------------------

    def _map_values(self, fn, dtype=None) -> "SparseDNDarray":
        """A container with the values mapped by ``fn``; the structure is
        shared."""
        new_vals = fn(self.__values)
        ht_dtype = dtype if dtype is not None else types.canonical_heat_type(new_vals.dtype)
        return SparseDNDarray(self.__indptr, self.__indices, new_vals, self.__gshape, ht_dtype,
                              self.__counts, self.__device, self.__comm)

    def astype(self, dtype) -> "SparseDNDarray":
        ht_dtype = types.canonical_heat_type(dtype)
        return self._map_values(lambda v: v.to(ht_dtype.torch_type()), ht_dtype)

    def __scalar(self, other, operation, inexact=False):
        dt = result_type(self.__values, other)
        if inexact:
            dt = _INEXACT.get(dt, dt)
        return self._map_values(lambda v: _apply(operation, v.to(dt), other))

    def __mul__(self, other) -> "SparseDNDarray":
        if not isinstance(other, (builtins.int, builtins.float)):
            return NotImplemented
        return self.__scalar(other, torch.mul)

    __rmul__ = __mul__

    def __truediv__(self, other) -> "SparseDNDarray":
        if not isinstance(other, (builtins.int, builtins.float)):
            return NotImplemented
        return self.__scalar(other, torch.true_divide, inexact=True)

    def __neg__(self) -> "SparseDNDarray":
        return self._map_values(lambda v: _apply(torch.neg, v))

    def __abs__(self) -> "SparseDNDarray":
        # an unsigned or bool value is its own absolute value
        return self._map_values(lambda v: v.clone() if v.dtype in _UNSIGNED + (torch.bool,)
                                else torch.abs(v))

    # -- linear algebra -------------------------------------------------------

    def __matmul__(self, other):
        from . import ops

        if isinstance(other, DNDarray):
            if other.ndim == 1:
                return ops.spmv(self, other)
            if other.ndim == 2:
                return ops.spmm(self, other)
        return NotImplemented

    def matvec(self, x: DNDarray, **kwargs) -> DNDarray:
        from . import ops

        return ops.spmv(self, x, **kwargs)

    # -- the solvers' operator hook (core/linalg/solver.py) -------------------

    def _matvec_spec(self, dt: Type[types.datatype]):
        """The matvec that ``linalg.cg`` and ``linalg.lanczos`` call:
        replicated ``(n,)`` in, replicated ``(m,)`` out, in ``dt``; the
        shard-local product and one allreduce."""
        from . import ops

        return ops.make_solver_matvec(self, dt)


def _host(t: torch.Tensor) -> np.ndarray:
    """A tensor as host numpy (bfloat16 through float32)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
