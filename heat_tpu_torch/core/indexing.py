"""Indexing (counterpart of ``heat_tpu/core/indexing.py``): for now only
the row gather that ``random.permutation`` and ``diff`` need.

:func:`_take_rows` is the JAX package's ``_advanced_take`` along axis 0
(``indexing.py:194`` there): the rows of ``x`` at a vector of global
indices that every rank holds, keeping ``x``'s split. When the rows are
split, each rank fetches the rows of its own chunk of the result from their
owners in one exchange (:meth:`TorchCommunication.alltoallv`), and no rank
holds a replicated copy of ``x``. The getitem/setitem engine, ``nonzero``
and ``where`` come with the manipulations (ROADMAP §1 item 6).
"""

from __future__ import annotations

from typing import Callable

import torch

from .communication import TorchCommunication
from .dndarray import DNDarray

__all__ = []


def _fetch_rows(local: torch.Tensor, n: int, comm: TorchCommunication,
                wanted: Callable[[int], torch.Tensor]) -> torch.Tensor:
    """The rows ``wanted(comm.rank)`` (global indices into the ``n`` rows)
    of an array split along dimension 0 whose chunk on this rank is
    ``local``, fetched from their owners in one exchange. ``wanted(q)`` must
    give rank ``q``'s request on every rank."""
    c = comm.chunk_size(n)
    off = min(comm.rank * c, n)
    sends, send_counts = [], []
    for q in range(comm.size):
        w = wanted(q)
        mine = (w >= off) & (w < off + local.shape[0])
        sends.append(local[w[mine] - off])
        send_counts.append(int(mine.sum()))
    want = wanted(comm.rank)
    owner = torch.div(want, max(c, 1), rounding_mode="floor")
    recv_counts = [int((owner == p).sum()) for p in range(comm.size)]
    recv = comm.alltoallv(torch.cat(sends), send_counts, recv_counts)
    # recv holds the rows by owner, each owner's in request order
    out = torch.empty((want.shape[0],) + tuple(local.shape[1:]), dtype=local.dtype,
                      device=local.device)
    out[torch.argsort(owner, stable=True)] = recv
    return out


def _take_rows(x: DNDarray, idx: torch.Tensor) -> DNDarray:
    """``x[idx]`` along axis 0 for a 1-D index vector that every rank
    holds, with ``x``'s split kept. Negative indices count from the end;
    an index out of range raises ``IndexError``."""
    n = x.shape[0]
    idx = idx.to(device=x.larray.device, dtype=torch.int64)
    if idx.numel():
        lo, hi = int(idx.min()), int(idx.max())
        if lo < -n or hi >= n:
            raise IndexError(f"index {lo if lo < -n else hi} is out of bounds for axis 0 "
                             f"with size {n}")
    idx = torch.where(idx < 0, idx + n, idx)
    gshape = (idx.shape[0],) + x.shape[1:]
    comm = x.comm
    if x.split == 0 and comm.size > 1:
        def wanted(q):
            _, lshape, sl = comm.chunk(gshape, 0, rank=q)
            return idx[sl[0]]

        data = _fetch_rows(x.larray, n, comm, wanted)
    else:
        data = x.larray.index_select(0, idx)
    return DNDarray(data.contiguous(), gshape, x.dtype, x.split, x.device, comm, True)
