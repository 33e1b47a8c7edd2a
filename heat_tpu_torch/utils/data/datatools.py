"""Datasets and loaders over split arrays (counterpart of
``heat_tpu/utils/data/datatools.py``; reference
heat/utils/data/datatools.py).

A :class:`Dataset` holds DNDarrays split along their rows (or
replicated); :class:`DataLoader` yields the batches of a data-parallel
training step. Between epochs the dataset is shuffled exactly and globally,
as in the JAX package: the key is ``jax.random.key(0)``, split once an
epoch, and the permutation is ``jax.random.permutation`` of the subkey,
reproduced bit for bit by the port's threefry (``core/_threefry.py``) and
applied with the distributed take (``core/indexing``: each rank fetches its
rows from their owners in one exchange). ``dataset_ishuffle`` keeps the
asynchronous contract: the shuffle is issued at the end of an epoch and
applied at the start of the next (``_harvest_pending``).

**Batches.** The port is SPMD, one process a rank, and every rank batches
its own rows, as the JAX package's multi-host branch does; no batch moves
data between ranks. The global batches are the JAX package's: the batch
size is rounded down to a multiple of the world size, batch ``i`` is rows
``[i*bs, i*bs + cur)`` of the dataset's (shuffled) order, and a ragged tail
is emitted at its largest divisible size when ``rem >= p``. So that each
rank holds its rows of every global batch, the loader lays the rows out
batch by batch once an epoch (one distributed take, like a shuffle): rank
``r`` holds rows ``[i*bs + r*cur/p, i*bs + (r+1)*cur/p)`` of batch ``i``.
The concatenation of the ranks' rows of a batch is the JAX package's global
batch. (The JAX multi-host branch batches each process's canonical slab
instead, whose global batches differ from its single-controller ones.)

A batch is a tuple of DNDarrays of the global batch shape split along
rows, each rank's ``larray`` its rows: the form
:meth:`heat_tpu_torch.nn.DataParallel.make_train_step`'s step takes. They
lie on the dataset's device; with ``device=`` a host dataset's batches
are copied to the card from pinned memory.
"""

from __future__ import annotations

from typing import Callable, Iterator, List, Optional

import torch

from ...core import _threefry, cuda_random
from ...core.devices import sanitize_device
from ...core.dndarray import DNDarray

__all__ = ["DataLoader", "Dataset", "dataset_shuffle", "dataset_ishuffle"]


class Dataset:
    """A dataset over one or two aligned DNDarrays (reference
    datatools.py:143-244): ``data`` and optionally ``targets``, split along
    their rows or replicated.

    Parameters
    ----------
    array : DNDarray
        The samples, split=0 (or replicated).
    targets : DNDarray, optional
        Aligned labels.
    ishuffle : bool
        Issue the shuffle between epochs early and apply it at the next
        epoch's start.
    test_set : bool
        Never shuffle when True.
    """

    def __init__(self, array: DNDarray, targets: Optional[DNDarray] = None,
                 ishuffle: bool = False, test_set: bool = False):
        if not isinstance(array, DNDarray):
            raise TypeError(f"array must be a DNDarray, got {type(array)}")
        if array.split not in (None, 0):
            raise ValueError(f"Dataset arrays must be split=0 or None, got {array.split}")
        if targets is not None and not isinstance(targets, DNDarray):
            raise TypeError(f"targets must be a DNDarray, got {type(targets)}")
        self.htdata = array
        self.httargets = targets
        self.comm = array.comm
        self.ishuffle = ishuffle
        self.test_set = test_set
        self._pending: Optional[List[DNDarray]] = None
        self._rng_key = _threefry.prng_key(0)  # jax.random.key(0)

    @property
    def data(self) -> torch.Tensor:
        """This rank's rows of the samples (the whole array when
        replicated): the reference's local-shard semantics."""
        return self.htdata.larray

    @property
    def targets(self) -> Optional[torch.Tensor]:
        return None if self.httargets is None else self.httargets.larray

    def __len__(self) -> int:
        return self.htdata.shape[0]

    def __getitem__(self, index):
        items = [self.data[index]]
        if self.httargets is not None:
            items.append(self.targets[index])
        return tuple(items) if len(items) > 1 else items[0]

    def _arrays(self) -> List[DNDarray]:
        out = [self.htdata]
        if self.httargets is not None:
            out.append(self.httargets)
        return out

    def Shuffle(self) -> None:
        """Blocking global shuffle of data (and targets) along the rows
        (reference Dataset.Shuffle -> dataset_shuffle)."""
        dataset_shuffle(self, [["data", "htdata"], ["targets", "httargets"]])

    def Ishuffle(self) -> None:
        """Issue the shuffle without applying it (reference
        Dataset.Ishuffle -> dataset_ishuffle); the next epoch applies it."""
        dataset_ishuffle(self, [["data", "htdata"], ["targets", "httargets"]])


def _shuffle_arrays(dataset: Dataset, blocking: bool) -> None:
    """One permutation applied to every attached array."""
    from ...core.indexing import _take_rows

    if dataset.test_set:
        return
    n = len(dataset)
    dataset._rng_key, sub = _threefry.split(dataset._rng_key)
    device = dataset.htdata.larray.device
    perm = _threefry.permutation(sub, n, device, cuda_random.draw)
    shuffled = [_take_rows(arr, perm) for arr in dataset._arrays()]
    if blocking:
        _apply_shuffled(dataset, shuffled)
        dataset._pending = None
    else:
        dataset._pending = shuffled


def _apply_shuffled(dataset: Dataset, shuffled: List[DNDarray]) -> None:
    for arr, out in zip(dataset._arrays(), shuffled):
        arr.larray = out.larray


def _harvest_pending(dataset: Dataset) -> None:
    """Apply a shuffle issued by :func:`dataset_ishuffle` (reference
    dataset_irecv, datatools.py:343-375)."""
    if dataset._pending is None:
        return
    _apply_shuffled(dataset, dataset._pending)
    dataset._pending = None


def dataset_shuffle(dataset: Dataset, attrs: List[list]) -> None:
    """Blocking global shuffle (reference datatools.py:246-299). ``attrs``
    is accepted for the signature; the permutation always applies to every
    array of the dataset."""
    _shuffle_arrays(dataset, blocking=True)


def dataset_ishuffle(dataset: Dataset, attrs: List[list]) -> None:
    """Global shuffle issued now and applied by the next iterator
    (reference datatools.py:301-341)."""
    _shuffle_arrays(dataset, blocking=False)


class DataLoader:
    """Iterable over the global batches of a :class:`Dataset`, reshuffled
    between epochs (reference datatools.py:16-141; module docstring).

    Parameters
    ----------
    dataset : Dataset or DNDarray
        A DNDarray is wrapped in a :class:`Dataset`.
    batch_size : int
        Global batch size, rounded down to a multiple of the world size.
    shuffle : bool
        Reshuffle between epochs (the first epoch in storage order, as the
        reference).
    drop_last : bool
        Drop the ragged tail batch.
    collate_fn : callable, optional
        Applied to each batch tuple.
    device : optional
        The device of the batches: the dataset's by default. A host
        dataset's batches go to a card from pinned memory.
    """

    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = True,
                 drop_last: bool = False, collate_fn: Optional[Callable] = None, device=None):
        if isinstance(dataset, DNDarray):
            dataset = Dataset(dataset)
        if not isinstance(dataset, Dataset):
            raise TypeError(
                f"dataset must be a heat_tpu_torch Dataset or DNDarray, got {type(dataset)}")
        self.dataset = dataset
        self.ishuffle = dataset.ishuffle
        self.shuffle = shuffle
        p = dataset.comm.size
        if batch_size < p:
            raise ValueError(f"batch_size ({batch_size}) must be >= the world size ({p})")
        self.batch_size = (batch_size // p) * p
        self.drop_last = drop_last
        self.collate_fn = collate_fn
        self.device = dataset.htdata.device if device is None else sanitize_device(device)
        self._first_iter = True
        self.last_epoch = False

    def __len__(self) -> int:
        n = len(self.dataset)
        p = self.dataset.comm.size
        full, rem = divmod(n, self.batch_size)
        # the tail batch at its largest divisible size: only rem % p rows are
        # lost an epoch, the reference's per-rank slice-off bound
        if rem >= p and not self.drop_last:
            return full + 1
        return full

    def _batch_sizes(self) -> List[int]:
        n, bs, p = len(self.dataset), self.batch_size, self.dataset.comm.size
        out = []
        for i in range(len(self)):
            cur = min(bs, n - i * bs)
            out.append(cur - cur % p)
        return out

    def _epoch_turnover(self) -> None:
        """Shuffle between epochs (reference _full_dataset_shuffle_iter,
        datatools.py:124-141)."""
        if not self.shuffle or self.dataset.test_set:
            return
        if not self.ishuffle:
            if self._first_iter:
                self._first_iter = False
            else:
                self.dataset.Shuffle()
        else:
            # apply the shuffle issued at the previous turnover first, then
            # issue the next one
            if self._first_iter:
                self._first_iter = False
            else:
                _harvest_pending(self.dataset)
            if not self.last_epoch:
                self.dataset.Ishuffle()

    def _batch_major(self, arr: DNDarray, sizes: List[int]) -> torch.Tensor:
        """This rank's rows of every batch, batch after batch: one
        distributed take of the rows each rank holds of each batch
        (module docstring); nothing moves on a world of one."""
        from ...core.indexing import _take_rows

        comm = arr.comm
        p = comm.size
        total = sum(sizes)
        if p == 1:
            return arr.larray[:total]
        starts = [i * self.batch_size for i in range(len(sizes))]
        order = torch.cat([
            torch.arange(lo + r * (cur // p), lo + (r + 1) * (cur // p), dtype=torch.int64)
            for r in range(p) for lo, cur in zip(starts, sizes)
        ]) if total else torch.zeros(0, dtype=torch.int64)
        taken = _take_rows(arr, order).larray
        if arr.split is None:  # a replicated array: this rank's share of the order
            per = total // p
            taken = taken[comm.rank * per:(comm.rank + 1) * per]
        return taken

    def __iter__(self) -> Iterator:
        self._epoch_turnover()
        comm = self.dataset.comm
        p = comm.size
        sizes = self._batch_sizes()
        target = self.device.torch_device
        locals_ = []
        for arr in self.dataset._arrays():
            t = self._batch_major(arr, sizes)
            if t.device != target:
                if t.device.type == "cpu" and target.type == "cuda":
                    t = t.pin_memory()
                t = t.to(target, non_blocking=True)
            locals_.append((arr, t))
        offset = 0
        for cur in sizes:
            per = cur // p
            batch = tuple(
                DNDarray(t[offset:offset + per], (cur,) + tuple(arr.shape[1:]), arr.dtype, 0,
                         self.device, comm, True)
                for arr, t in locals_)
            offset += per
            yield self.collate_fn(*batch) if self.collate_fn else batch
