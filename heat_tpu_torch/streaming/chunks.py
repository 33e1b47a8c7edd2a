"""Out-of-core ingestion: array files walked in bounded row blocks.

Counterpart of ``heat_tpu/streaming/chunks.py``. :class:`ChunkStream`
iterates ``.npy`` and HDF5 files as DNDarray chunks without reading a whole
file: each block is an ``io.load_npy``/``io.load_hdf5`` read with
``chunks=(start, stop)``, each rank copying only its own slab of the block
out of the memory map (or the h5py range read) and onto its card. The rows
of a chunk fit ``memory_guard.temp_budget()`` (a quarter of
``HEAT_TPU_HBM_BUDGET``, at most 256 MiB, :139-150 there) unless
``HEAT_TPU_STREAM_CHUNK_ROWS`` or ``chunk_rows`` names them. The chunking
restarts at each file.

``resplit=`` loads each chunk row-split and redistributes it through
``DNDarray.resplit``. Telemetry: one ``stream_chunk`` event a block (rows,
bytes, the read's seconds) and the ``streaming.chunk_bytes`` watermark.
"""

from __future__ import annotations

import os
import time
from typing import Iterator, List, Optional, Sequence, Union

import numpy as np

from .. import _knobs as knobs
from ..core import io as core_io
from ..core import types
from ..core.dndarray import DNDarray
from ..resilience import memory_guard
from . import events

__all__ = ["ChunkStream"]


class ChunkStream:
    """Iterate array files as row-block DNDarray chunks.

    Parameters
    ----------
    paths : str | sequence of str
        ``.npy`` or HDF5 files, streamed in order; all share the trailing
        (feature) shape.
    dataset : str, optional
        The HDF5 dataset (needed for HDF5 files).
    chunk_rows : int, optional
        Rows a chunk. Default: ``HEAT_TPU_STREAM_CHUNK_ROWS``, or at 0 the
        most rows whose bytes fit ``memory_guard.temp_budget()``.
    dtype, split, device, comm :
        Placement of each chunk, as in ``io.load_*``; ``split=0`` (the
        default) splits a chunk's rows over the ranks.
    resplit : int | None, optional
        Load each chunk row-split and redistribute it to this split.
    skip_rows : int
        Skip this many leading rows (resuming where a carry left off); a
        chunk boundary of the same ``chunk_rows`` reproduces the original
        chunks exactly.
    """

    def __init__(
        self,
        paths: Union[str, Sequence[str]],
        dataset: Optional[str] = None,
        *,
        chunk_rows: Optional[int] = None,
        dtype=types.float32,
        split: Optional[int] = 0,
        device=None,
        comm=None,
        resplit: Optional[int] = None,
        skip_rows: int = 0,
    ):
        self.paths: List[str] = [paths] if isinstance(paths, str) else list(paths)
        if not self.paths:
            raise ValueError("ChunkStream needs at least one file")
        self.dataset = dataset
        self.dtype = dtype
        self.split = split
        self.device = device
        self.comm = comm
        self.resplit = resplit
        self.skip_rows = int(skip_rows)
        self.rows_read = 0
        self.chunks_read = 0
        self._shapes = []
        tail = None
        for p in self.paths:
            shape = core_io.dataset_shape(p, dataset if self._is_hdf5(p) else None)
            if len(shape) < 1:
                raise ValueError(f"ChunkStream: {p!r} is 0-d")
            if tail is None:
                tail = shape[1:]
            elif shape[1:] != tail:
                raise ValueError(f"ChunkStream: {p!r} has row shape {shape[1:]}, expected "
                                 f"{tail} (all files must share it)")
            self._shapes.append(shape)
        self._tail = tail
        if self.skip_rows < 0 or self.skip_rows > self.nrows():
            raise ValueError(f"skip_rows={skip_rows} outside [0, {self.nrows()}]")
        self.chunk_rows = self._resolve_chunk_rows(chunk_rows)

    @staticmethod
    def _is_hdf5(path: str) -> bool:
        return path.endswith((".h5", ".hdf5"))

    def _row_bytes(self) -> int:
        width = int(np.prod(self._tail)) if self._tail else 1
        item = types.canonical_heat_type(self.dtype).torch_type().itemsize
        return max(1, width * item)

    def _resolve_chunk_rows(self, chunk_rows: Optional[int]) -> int:
        if chunk_rows is None:
            chunk_rows = int(knobs.get("HEAT_TPU_STREAM_CHUNK_ROWS") or 0)
        if chunk_rows < 0:
            raise ValueError(f"chunk_rows must be >= 0, got {chunk_rows}")
        if chunk_rows == 0:
            chunk_rows = max(1, memory_guard.temp_budget() // self._row_bytes())
        return min(int(chunk_rows), max(1, self.nrows()))

    def nrows(self) -> int:
        """Rows of all files together."""
        return sum(s[0] for s in self._shapes)

    def load_all_bytes(self) -> int:
        """The bytes of every file read at once: what the out-of-core
        watermark must stay under."""
        return self.nrows() * self._row_bytes()

    def chunk_bytes(self) -> int:
        return self.chunk_rows * self._row_bytes()

    def __len__(self) -> int:
        # the chunking restarts at every file, so count per file
        total, to_skip = 0, self.skip_rows
        for shape in self._shapes:
            n = shape[0]
            if to_skip >= n:
                to_skip -= n
                continue
            total += -(-(n - to_skip) // self.chunk_rows)
            to_skip = 0
        return total

    def __iter__(self) -> Iterator[DNDarray]:
        from .. import telemetry

        to_skip = self.skip_rows
        load_split = 0 if self.resplit is not None else self.split
        for path, shape in zip(self.paths, self._shapes):
            n = shape[0]
            if to_skip >= n:
                to_skip -= n
                continue
            lo, to_skip = to_skip, 0
            while lo < n:
                hi = min(lo + self.chunk_rows, n)
                t0 = time.perf_counter()
                if self._is_hdf5(path):
                    chunk = core_io.load_hdf5(path, self.dataset, dtype=self.dtype,
                                              split=load_split, device=self.device,
                                              comm=self.comm, chunks=(lo, hi))
                else:
                    chunk = core_io.load_npy(path, dtype=self.dtype, split=load_split,
                                             device=self.device, comm=self.comm,
                                             chunks=(lo, hi))
                if self.resplit is not None:
                    chunk = chunk.resplit(self.resplit)
                seconds = time.perf_counter() - t0
                nbytes = (hi - lo) * self._row_bytes()
                self.rows_read += hi - lo
                self.chunks_read += 1
                events.emit(os.path.basename(path), "stream_chunk", rows=hi - lo, bytes=nbytes,
                            seconds=round(seconds, 6), start=lo, stop=hi)
                if telemetry.enabled():
                    telemetry.get_registry().high_water("streaming.chunk_bytes", float(nbytes))
                yield chunk
                lo = hi
