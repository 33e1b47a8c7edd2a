"""SPMD communication over ``torch.distributed``.

Counterpart of ``heat_tpu/core/communication.py``. The JAX package is one
controller over a device mesh; this package follows the original Heat
instead: one process per GPU, each holding only its own chunk of a split
array, with collectives over ``torch.distributed`` (NCCL on the card, gloo
in the CPU tests). With no process group initialised the world has size 1.

The chunk arithmetic is the JAX package's ceil rule, copied in logic as
functions of an explicit world size ``size`` (``communication.py:158-220``
there): rank ``r`` owns global indices ``[r*c, min((r+1)*c, n))`` with
``c = ceil(n/size)``; tail ranks may own empty ranges. Because every rank
holds only its own rows, no physical tail padding exists here.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    "TorchCommunication",
    "chunk",
    "chunk_size",
    "counts_displs",
    "get_comm",
    "lshape_map",
    "padded_size",
    "sanitize_comm",
    "use_comm",
]


def chunk_size(n: int, size: int) -> int:
    """Per-rank chunk length ``ceil(n/size)`` for a split dimension of
    length ``n``."""
    if size == 0:
        return n
    return -(-n // size)


def padded_size(n: int, size: int) -> int:
    """``chunk_size * size``: the length the JAX package stores (this
    package stores no pad, but keeps the number for layout parity)."""
    return chunk_size(n, size) * size


def chunk(
    shape: Sequence[int], split: Optional[int], rank: int, size: int
) -> Tuple[int, Tuple[int, ...], Tuple[slice, ...]]:
    """``(offset, local_shape, slices)`` of rank ``rank``'s chunk of a
    global ``shape`` split along ``split``."""
    shape = tuple(int(s) for s in shape)
    if split is None:
        return 0, shape, tuple(slice(0, end) for end in shape)
    n = shape[split]
    c = chunk_size(n, size)
    start = min(rank * c, n)
    end = min((rank + 1) * c, n)
    lshape = shape[:split] + (end - start,) + shape[split + 1:]
    slices = tuple(
        slice(start, end) if d == split else slice(0, shape[d]) for d in range(len(shape))
    )
    return start, lshape, slices


def lshape_map(gshape: Sequence[int], split: Optional[int], size: int) -> np.ndarray:
    """(size, ndim) int64 array of every rank's chunk shape."""
    out = np.empty((size, len(gshape)), dtype=np.int64)
    for r in range(size):
        out[r] = chunk(gshape, split, r, size)[1]
    return out


def counts_displs(n: int, size: int) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """Per-rank counts and displacements along a split dimension of
    length ``n``."""
    c = chunk_size(n, size)
    counts = tuple(max(0, min((r + 1) * c, n) - min(r * c, n)) for r in range(size))
    displs = tuple(min(r * c, n) for r in range(size))
    return counts, displs


# the signed type of the same width, which carries an unsigned type's bits
# through a collective
_BITS_AS = {torch.uint16: torch.int16, torch.uint32: torch.int32, torch.uint64: torch.int64}


class TorchCommunication:
    """The world of ranks of one ``torch.distributed`` process group (the
    default group when ``group`` is None). Without an initialised process
    group it is a world of size 1 and every collective is the identity."""

    def __init__(self, group=None):
        self.group = group
        if dist.is_available() and dist.is_initialized():
            self.size = dist.get_world_size(group)
            self.rank = dist.get_rank(group)
        else:
            self.size = 1
            self.rank = 0

    def __repr__(self) -> str:
        return f"TorchCommunication(rank={self.rank}, size={self.size})"

    def is_distributed(self) -> bool:
        return self.size > 1

    # -- the layout contract (JAX package communication.py:158-220) ----------

    def chunk_size(self, n: int) -> int:
        return chunk_size(n, self.size)

    def padded_size(self, n: int) -> int:
        return padded_size(n, self.size)

    def chunk(self, shape, split, rank: Optional[int] = None):
        return chunk(shape, split, self.rank if rank is None else rank, self.size)

    def lshape_map(self, gshape, split) -> np.ndarray:
        return lshape_map(gshape, split, self.size)

    def counts_displs(self, n: int):
        return counts_displs(n, self.size)

    # -- collectives ----------------------------------------------------------

    def allreduce(self, tensor: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """In-place all-reduce (the counterpart of the JAX package's
        ``psum`` :336, and of ``pmax``/``pmin``); returns ``tensor``."""
        if self.size > 1:
            red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}[op]
            dist.all_reduce(tensor, op=red, group=self.group)
        return tensor

    def allgather(self, local: torch.Tensor, dim: int, n: int) -> torch.Tensor:
        """Concatenate every rank's chunk of a dimension of global length
        ``n`` along ``dim`` (the counterpart of ``all_gather`` :412). The
        chunks follow the ceil rule; each is padded to the chunk size for
        the collective and the pad is dropped again."""
        if self.size == 1:
            return local
        if local.dtype in _BITS_AS:  # gloo and NCCL carry no uint16/32/64: move the bits
            return self.allgather(local.view(_BITS_AS[local.dtype]), dim, n).view(local.dtype)
        c = self.chunk_size(n)
        counts, _ = self.counts_displs(n)
        pad_shape = list(local.shape)
        pad_shape[dim] = c
        buf = local.new_zeros(pad_shape)
        buf.narrow(dim, 0, local.shape[dim]).copy_(local)
        parts: List[torch.Tensor] = [torch.empty_like(buf) for _ in range(self.size)]
        dist.all_gather(parts, buf.contiguous(), group=self.group)
        return torch.cat([p.narrow(dim, 0, cnt) for p, cnt in zip(parts, counts)], dim=dim)

    def allgather_object(self, obj) -> list:
        if self.size == 1:
            return [obj]
        out = [None] * self.size
        dist.all_gather_object(out, obj, group=self.group)
        return out


_default_comm: Optional[TorchCommunication] = None


def get_comm() -> TorchCommunication:
    """The default communicator: the default process group, built on first
    use (reference communication.py:1874)."""
    global _default_comm
    if _default_comm is None:
        _default_comm = TorchCommunication()
    return _default_comm


def use_comm(comm: Optional[TorchCommunication] = None) -> None:
    """Set the default communicator; ``None`` rebuilds it from the current
    process group (reference communication.py:1904)."""
    global _default_comm
    if comm is not None and not isinstance(comm, TorchCommunication):
        raise TypeError(f"Unknown communication, must be TorchCommunication, got {comm!r}")
    _default_comm = comm if comm is not None else TorchCommunication()


def sanitize_comm(comm: Optional[TorchCommunication]) -> TorchCommunication:
    if comm is None:
        return get_comm()
    if isinstance(comm, TorchCommunication):
        return comm
    raise TypeError(f"Unknown communication, must be TorchCommunication, got {comm!r}")
