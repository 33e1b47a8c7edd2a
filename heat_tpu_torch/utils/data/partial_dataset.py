"""Out-of-core streaming datasets (counterpart of
``heat_tpu/utils/data/partial_dataset.py``; reference
heat/utils/data/partial_dataset.py).

The reference's :class:`PartialH5Dataset` streams windows of an HDF5 file
that does not fit in memory: a background **loader thread** reads the next
window while the current one is consumed. The JAX package and the port
keep that design: a ``threading.Thread`` fills a bounded queue of two
windows; the consumer re-raises the loader's errors; leaving the loop early
stops, drains and joins the thread, so abandoned epochs leave no thread
behind. It reads any mapping whose values slice like numpy arrays (an
h5py file, ``np.memmap``, arrays); the HDF5 class opens the file with h5py.

:class:`PartialDataLoaderIter` cuts the windows into global batches (the
tail of a window carries over into the next; the last tail is dropped, as
the reference forces ``drop_last`` for partial datasets) and, with
``shuffle``, permutes each window with ``numpy.random.default_rng(seed)``,
as the JAX package does. Every rank streams the same windows in the same
order and keeps its rows of each batch (rank ``r`` the ``r``-th of ``p``
equal parts): a batch is a tuple of DNDarrays of the global batch shape,
split along rows, the form :mod:`heat_tpu_torch.utils.data.datatools`'
loader yields. On the card a batch goes through one of two pinned staging
buffers a column and is copied asynchronously; a buffer is written again
only after its copy has finished (a CUDA event).

``stats`` (on the dataset) holds the loader thread's reading seconds and
the consumer's waiting seconds of the last pass, to tell a read-bound
stream from a device-bound one.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from ...core import types
from ...core.communication import sanitize_comm
from ...core.devices import sanitize_device
from ...core.dndarray import DNDarray

__all__ = ["PartialDataset", "PartialH5Dataset", "PartialDataLoaderIter",
           "PartialH5DataLoaderIter"]


def _read(column, lo: int, hi: int) -> np.ndarray:
    """Rows ``[lo, hi)`` of a column, read now: a memory map's slice is a
    view that would be read only when the batches copy it, in the consumer,
    so it is copied here, on the loader thread."""
    rows = column[lo:hi]
    return np.array(rows) if isinstance(rows, np.memmap) else np.asarray(rows)


class PartialDataset:
    """Windowed streaming dataset over sliceable columns.

    Parameters
    ----------
    columns : dict[str, sliceable]
        Named arrays of the same leading length, e.g. ``{"data":
        f["images"], "targets": f["labels"]}`` of an open h5py file.
    initial_load : int
        Rows of the first window (reference ``initial_load``).
    load_length : int
        Rows of every later window (reference ``load_length``).
    transform : callable, optional
        Applied to each window, a dict of numpy arrays, before batching.
    comm, device : optional
        The world the batches are split over and the device they land on.
    """

    def __init__(self, columns, initial_load: int = 4096, load_length: int = 1024,
                 transform: Optional[Callable] = None, comm=None, device=None):
        if not columns:
            raise ValueError("columns must be a non-empty mapping")
        self.columns = dict(columns)
        lengths = {k: v.shape[0] for k, v in self.columns.items()}
        if len(set(lengths.values())) != 1:
            raise ValueError(f"column lengths differ: {lengths}")
        self.total_size = next(iter(lengths.values()))
        self.initial_load = min(initial_load, self.total_size)
        self.load_length = max(1, load_length)
        self.transform = transform
        self.comm = sanitize_comm(comm)
        self.device = sanitize_device(device)
        self.ishuffle = False
        self.test_set = False
        self.partial_dataset = True  # reference duck-type marker
        self.stats = {"windows": 0, "rows": 0, "read_seconds": 0.0, "wait_seconds": 0.0}

    def windows(self) -> Iterator[dict]:
        """Yield dicts of numpy windows, prefetched by a background thread
        (the reference's loader thread, partial_dataset.py:20-30)."""
        q: queue.Queue = queue.Queue(maxsize=2)
        sentinel = object()
        stop = threading.Event()
        stats = self.stats
        stats.update(windows=0, rows=0, read_seconds=0.0, wait_seconds=0.0)

        def put(item) -> bool:
            # a bounded put that watches the stop flag, so that an abandoned
            # consumer cannot leave this thread blocked on a full queue
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def loader():
            # the sentinel reaches the queue on every exit path, and errors
            # travel through it so that the consumer re-raises them
            try:
                pos = 0
                length = self.initial_load
                while pos < self.total_size and not stop.is_set():
                    hi = min(pos + length, self.total_size)
                    t0 = time.perf_counter()
                    win = {k: _read(v, pos, hi) for k, v in self.columns.items()}
                    if self.transform is not None:
                        win = self.transform(win)
                    stats["read_seconds"] += time.perf_counter() - t0
                    stats["windows"] += 1
                    stats["rows"] += hi - pos
                    if not put(win):
                        return
                    pos = hi
                    length = self.load_length
            except BaseException as e:  # noqa: BLE001 - relayed to the consumer
                put(e)
            finally:
                put(sentinel)

        t = threading.Thread(target=loader, name="heat_tpu_torch.partial_dataset", daemon=True)
        t.start()
        try:
            while True:
                t0 = time.perf_counter()
                win = q.get()
                stats["wait_seconds"] += time.perf_counter() - t0
                if win is sentinel:
                    break
                if isinstance(win, BaseException):
                    raise win
                yield win
        finally:
            # exhaustion or early exit (GeneratorExit): wake the loader,
            # drain the queue and reap the thread
            stop.set()
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            t.join()

    def __len__(self) -> int:
        return self.total_size


class PartialH5Dataset(PartialDataset):
    """Stream datasets out of an HDF5 file (reference partial_dataset.py:32).

    Parameters
    ----------
    file : str
        Path of the HDF5 file.
    dataset_names : str or list of str
        The datasets to stream (reference default ``"data"``).
    """

    def __init__(self, file: str, comm=None, dataset_names="data",
                 transform: Optional[Callable] = None, initial_load: int = 4096,
                 load_length: int = 1024, device=None):
        try:
            import h5py
        except ImportError as e:
            raise ImportError("PartialH5Dataset requires h5py") from e
        self.file = file
        self._h5 = h5py.File(file, "r")
        names = [dataset_names] if isinstance(dataset_names, str) else list(dataset_names)
        columns = {name: self._h5[name] for name in names}
        super().__init__(columns, initial_load=initial_load, load_length=load_length,
                         transform=transform, comm=comm, device=device)

    def close(self) -> None:
        self._h5.close()


class _Staging:
    """Two pinned host buffers of one column's batch rows, used in turn; a
    buffer is refilled only after the copy out of it has finished."""

    def __init__(self, shape, dtype: torch.dtype):
        self.bufs = [torch.empty(shape, dtype=dtype).pin_memory() for _ in range(2)]
        self.done = [None, None]
        self.turn = 0

    def to_card(self, rows: np.ndarray, device: torch.device) -> torch.Tensor:
        k = self.turn
        self.turn ^= 1
        if self.done[k] is not None:
            self.done[k].synchronize()
        buf = self.bufs[k][:rows.shape[0]]
        buf.numpy()[...] = rows
        out = buf.to(device, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        self.done[k] = ev
        return out


class PartialDataLoaderIter:
    """Batch iterator over a :class:`PartialDataset` (reference
    PartialH5DataLoaderIter, partial_dataset.py:224; module docstring).

    ``batch_size`` is the global batch and must divide by the world size."""

    def __init__(self, dataset: PartialDataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0):
        p = dataset.comm.size
        if batch_size % p:
            raise ValueError(f"batch_size ({batch_size}) must be divisible by the world size ({p})")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self._rng = np.random.default_rng(seed)

    def __iter__(self):
        carry: Optional[dict] = None
        bs = self.batch_size
        comm = self.dataset.comm
        per = bs // comm.size
        device = self.dataset.device
        target = device.torch_device
        staging = {}
        for win in self.dataset.windows():
            if carry is not None:
                win = {k: np.concatenate([carry[k], win[k]], axis=0) for k in win}
            n = next(iter(win.values())).shape[0]
            if self.shuffle:
                prm = self._rng.permutation(n)
                win = {k: v[prm] for k, v in win.items()}
            nb = n // bs
            for i in range(nb):
                lo = i * bs + comm.rank * per
                batch = []
                for k, v in win.items():
                    rows = np.ascontiguousarray(v[lo:lo + per])
                    if target.type == "cuda":
                        if k not in staging:
                            dtype = torch.from_numpy(np.zeros(0, rows.dtype)).dtype
                            staging[k] = _Staging(rows.shape, dtype)
                        t = staging[k].to_card(rows, target)
                    else:
                        t = torch.from_numpy(rows)
                    batch.append(DNDarray(t, (bs,) + rows.shape[1:],
                                          types.canonical_heat_type(t.dtype), 0, device, comm,
                                          True))
                yield tuple(batch)
            rem = n - nb * bs
            carry = {k: v[n - rem:] for k, v in win.items()} if rem else None


# the reference's name (reference partial_dataset.py:224)
PartialH5DataLoaderIter = PartialDataLoaderIter
