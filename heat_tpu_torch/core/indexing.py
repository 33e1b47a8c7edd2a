"""Global indexing: the getitem/setitem engine, ``nonzero`` and ``where``
(counterpart of ``heat_tpu/core/indexing.py``).

Every rank holds only its ceil-rule chunk, so a key is applied where the
data lives and the selected rows then move to the result's chunks:

* a **basic key** (ints, slices with any step, ``None``, ``Ellipsis``) that
  leaves the split dimension whole applies to each chunk alone; a slice of
  the split dimension cuts each rank's part of it, and the parts move to
  the result's chunks in one exchange of row ranges (a negative step
  reverses each part and the ranks' order); an int on the split dimension
  gives a replicated result, sent by its owner;
* a **1-D integer array** along the split dimension is the row gather
  :func:`_take_rows` (``_advanced_take`` there); along another dimension it
  applies to each chunk; two adjacent ones pair as ``_paired_take`` does;
* a **full-shape boolean mask** compacts each rank's selection, and an
  exclusive scan of the ranks' counts (one collective of counts, one host
  read of the total) places it in the 1-D split=0 result; a **1-D row
  mask** over axis 0 keeps the array's split;
* the keys the JAX package applies to its global view (several or n-D
  integer arrays, masks mixed with other entries) apply to the gathered
  array here too, with torch's indexing on the device.

``setitem`` writes each rank's own targets in place: the positions a key
selects are those it selects in a grid of global indices, so any key numpy
takes is applied on the device (no host copy, no warning), and a value
held split across ranks is fetched only where its targets live. A chunk
that another array shares (a view) is copied before the first write, so
results never alias one another, as in the JAX package.

The split of every result is the JAX package's (``_result_split`` and the
routes of its ``getitem``), and each result lies on the ceil-rule chunks
of its own shape.
"""

from __future__ import annotations

import builtins
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import types
from .communication import TorchCommunication
from .dndarray import DNDarray

__all__ = ["nonzero", "where"]

# the signed type of the same width: torch moves the bits of these
# unsigned types where it has no kernel for them (flip, gather, index_select)
_BITS_AS = {torch.uint16: torch.int16, torch.uint32: torch.int32, torch.uint64: torch.int64}


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(_BITS_AS[t.dtype]) if t.dtype in _BITS_AS else t


def _unbits(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return t.view(dtype) if dtype in _BITS_AS else t


def _shares(a: torch.Tensor, b: torch.Tensor) -> bool:
    """True when ``a`` and ``b`` lie in one storage."""
    return a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()


def _index_select(t: torch.Tensor, dim: int, idx: torch.Tensor) -> torch.Tensor:
    return _unbits(_bits(t).index_select(dim, idx), t.dtype)


def _flip(t: torch.Tensor, dims) -> torch.Tensor:
    return _unbits(_bits(t).flip(dims), t.dtype)


# ------------------------------------------------------------ row exchanges


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
        sends.append(_index_select(local, 0, w[mine] - off))
        send_counts.append(int(mine.sum()))
    want = wanted(comm.rank)
    owner = torch.div(want, max(c, 1), rounding_mode="floor")
    recv_counts = [int((owner == p).sum()) for p in range(comm.size)]
    recv = comm.alltoallv(torch.cat(sends), send_counts, recv_counts)
    # recv holds the rows by owner, each owner's in request order
    out = torch.empty((want.shape[0],) + tuple(local.shape[1:]), dtype=local.dtype,
                      device=local.device)
    _bits(out)[torch.argsort(owner, stable=True)] = _bits(recv)
    return out


def _request(local: torch.Tensor, bounds: Sequence[int], comm: TorchCommunication,
             want: torch.Tensor) -> torch.Tensor:
    """Rows ``want`` (global indices) of an array whose rank ``q`` holds the
    global rows ``[bounds[q], bounds[q+1])`` as ``local``: the requests go
    to their owners and the rows come back, two exchanges. Unlike
    :func:`_fetch_rows`, each rank needs to know only its own request."""
    if comm.size == 1:
        return local[want]
    edges = torch.tensor(list(bounds[1:-1]), dtype=torch.int64, device=want.device)
    owner = torch.bucketize(want, edges, right=True)
    order = torch.argsort(owner, stable=True)
    counts = torch.bincount(owner, minlength=comm.size).tolist()
    table = comm.allgather_object(counts)
    asked = [table[q][comm.rank] for q in range(comm.size)]
    req = comm.alltoallv(want[order], counts, asked)
    answer = comm.alltoallv(local[req - bounds[comm.rank]], asked, counts)
    out = torch.empty((want.shape[0],) + tuple(local.shape[1:]), dtype=local.dtype,
                      device=local.device)
    _bits(out)[order] = _bits(answer)
    return out


def _owner_parts(start: int, length: int, bounds: Sequence[int]):
    """``(q, s, e)``: the global rows ``[start, start+length)`` cut by the
    ranks' target ranges ``[bounds[q], bounds[q+1])``."""
    out, s, end = [], start, start + length
    q = 0
    while s < end:
        while bounds[q + 1] <= s:
            q += 1
        e = min(end, bounds[q + 1])
        out.append((q, s, e))
        s = e
    return out


def _chunk_bounds(n: int, comm: TorchCommunication) -> List[int]:
    _, displs = comm.counts_displs(n)
    return list(displs) + [n]


def _assemble(pieces: Sequence[torch.Tensor], ranges: Sequence[Sequence[Tuple[int, int]]],
              n: int, comm: TorchCommunication, like: torch.Tensor,
              bounds: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Move rows (dimension 0) held in contiguous global ranges to their
    targets: rank ``q`` holds ``ranges[q]``, a list of ``(start, length)``
    ranges of the ``n`` result rows, and this rank's ``pieces`` are its
    ranges' rows, in order. Returns the rows ``[bounds[r], bounds[r+1])`` of
    this rank ``r``: by default its ceil-rule chunk. Every rank knows every
    range, so one exchange moves the rows and no index travels."""
    bounds = _chunk_bounds(n, comm) if bounds is None else list(bounds)
    me = comm.rank
    lo, hi = bounds[me], bounds[me + 1]
    rest = tuple(like.shape[1:])
    if comm.size == 1:
        order = sorted(range(len(pieces)), key=lambda j: ranges[0][j][0])
        if len(order) == 1:
            return pieces[0]
        got = [pieces[j] for j in order]
        return torch.cat(got) if got else like.new_empty((0,) + rest)
    send = []
    for t, (start, length) in zip(pieces, ranges[me]):
        for q, s, e in _owner_parts(start, length, bounds):
            send.append((q, t[s - start:e - start]))
    send.sort(key=lambda qt: qt[0])
    send_counts = [0] * comm.size
    for q, t in send:
        send_counts[q] += t.shape[0]
    recv_counts, placed = [0] * comm.size, []
    for q in range(comm.size):
        for start, length in ranges[q]:
            for o, s, e in _owner_parts(start, length, bounds):
                if o == me:
                    recv_counts[q] += e - s
                    placed.append((s, e))
    buf = torch.cat([t for _, t in send]) if send else like.new_empty((0,) + rest)
    recv = comm.alltoallv(buf, send_counts, recv_counts)
    if len(placed) == 1 and placed[0] == (lo, hi):
        return recv
    out = like.new_empty((hi - lo,) + rest)
    pos = 0
    for s, e in placed:
        out[s - lo:e - lo] = recv[pos:pos + e - s]
        pos += e - s
    return out


def _exchange_rows(rows: torch.Tensor, dest: torch.Tensor, n: int,
                   comm: TorchCommunication) -> torch.Tensor:
    """This rank's ceil-rule chunk of an ``n``-row result whose rows
    ``dest`` (global, each written once) this rank holds as ``rows``; the
    ranks' counts travel first (one host read), then the rows and their
    destinations."""
    bounds = _chunk_bounds(n, comm)
    lo, hi = bounds[comm.rank], bounds[comm.rank + 1]
    out = rows.new_empty((hi - lo,) + tuple(rows.shape[1:]))
    if comm.size == 1:
        _bits(out)[dest] = _bits(rows)
        return out
    c = max(comm.chunk_size(n), 1)
    owner = torch.div(dest, c, rounding_mode="floor")
    order = torch.argsort(owner, stable=True)
    counts = torch.bincount(owner, minlength=comm.size).tolist()
    table = comm.allgather_object(counts)
    recv_counts = [table[q][comm.rank] for q in range(comm.size)]
    got = comm.alltoallv(rows[order], counts, recv_counts)
    where_to = comm.alltoallv(dest[order], counts, recv_counts)
    _bits(out)[where_to - lo] = _bits(got)
    return out


def _slice_part(start: int, step: int, length: int, lo: int, hi: int) -> Tuple[int, int]:
    """``(k0, k1)``: the positions ``k`` of the slice ``start + k*step``
    (``length`` of them) that fall in the global rows ``[lo, hi)``."""
    if step > 0:
        k0 = max(0, -(-(lo - start) // step))
        k1 = min(length, -(-(hi - start) // step))
    else:
        s = -step
        k0 = max(0, (start - hi) // s + 1)
        k1 = min(length, (start - lo) // s + 1)
    return k0, max(k0, k1)


# ------------------------------------------------------------- key helpers


def _is_int_array(k) -> bool:
    return isinstance(k, torch.Tensor) and k.ndim >= 1 and not k.is_floating_point() \
        and not k.is_complex() and k.dtype != torch.bool


def _is_bool_array(k, min_ndim: int = 1) -> bool:
    return isinstance(k, torch.Tensor) and k.dtype == torch.bool and k.ndim >= min_ndim


def _is_mask(k) -> bool:
    """A boolean array, given as a tensor or as a DNDarray."""
    if isinstance(k, DNDarray):
        return k.dtype == types.bool and k.ndim >= 1
    return _is_bool_array(k)


def _is_int(k) -> bool:
    return isinstance(k, (builtins.int, np.integer)) and not isinstance(k, (builtins.bool,
                                                                            np.bool_))


def _key_entry(k, x: DNDarray):
    """One key entry with arrays as tensors on ``x``'s device (a split
    DNDarray key is gathered: keys are small next to the data, and the JAX
    package replicates them too). An entry that is no index (a float, a
    string) raises ``TypeError``, as in the JAX package."""
    dev = x.larray.device
    if isinstance(k, DNDarray):
        k = k._global()
    elif isinstance(k, (list, np.ndarray)):
        arr = np.asarray(k)
        if arr.dtype.kind not in "iubfc":
            raise TypeError(f"invalid index {k!r}")
        k = torch.as_tensor(arr.astype(np.int64) if arr.dtype.kind == "u" else arr)
    elif isinstance(k, (np.bool_, np.integer)):
        k = k.item()
    if isinstance(k, torch.Tensor):
        if k.is_floating_point() or k.is_complex():
            raise TypeError("indices must be integer or boolean arrays, not float arrays")
        return k.to(dev)
    if not (isinstance(k, (builtins.int, slice)) or k is None or k is Ellipsis):
        raise TypeError(f"indices must be integers, slices, ellipsis, None or integer or "
                        f"boolean arrays, not {type(k).__name__}")
    return k


def _normalize_key(key, x: DNDarray):
    if isinstance(key, tuple):
        return tuple(_key_entry(k, x) for k in key)
    return _key_entry(key, x)


def _expand_key(key, ndim: int) -> list:
    """Ellipsis and missing dimensions expanded to one entry each (``None``
    entries stay; as the JAX package counts, every other entry is one
    dimension)."""
    if not isinstance(key, tuple):
        key = (key,)
    n_specified = builtins.sum(1 for k in key if k is not None and k is not Ellipsis)
    expanded, seen = [], False
    for k in key:
        if k is Ellipsis:
            if seen:
                raise IndexError("an index can only have a single ellipsis ('...')")
            seen = True
            expanded.extend([slice(None)] * (ndim - n_specified))
        else:
            expanded.append(k)
    while builtins.sum(1 for k in expanded if k is not None) < ndim:
        expanded.append(slice(None))
    return expanded


def _full_slice(k) -> bool:
    return isinstance(k, slice) and k == slice(None)


def _result_split(x: DNDarray, key) -> Optional[int]:
    """The JAX package's split of an indexing result (its ``_result_split``)."""
    if x.split is None:
        return None
    if not isinstance(key, tuple):
        key = (key,)
    if len(key) == 1 and _is_bool_array(key[0]) and key[0].ndim == x.ndim:
        return 0
    if len(key) == 1 and _is_bool_array(key[0]) and key[0].ndim == 1 and x.ndim >= 1 \
            and tuple(key[0].shape) == (x.shape[0],):
        return x.split
    in_dim = out_dim = 0
    for k in _expand_key(key, x.ndim):
        if k is None:
            out_dim += 1
            continue
        if isinstance(k, slice):
            if in_dim == x.split:
                return out_dim
            in_dim += 1
            out_dim += 1
        elif _is_int(k):
            if in_dim == x.split:
                return None
            in_dim += 1
        else:
            return None
    return None


def _bound(i: int, n: int, axis: int) -> int:
    if i < -n or i >= n:
        raise IndexError(f"index {i} is out of bounds for axis {axis} with size {n}")
    return i + n if i < 0 else i


def _check_bounds(idx: torch.Tensor, n: int, axis: int) -> torch.Tensor:
    """``idx`` with negatives counted from the end; an index out of range
    raises ``IndexError`` (one host read of both extremes)."""
    idx = idx.to(torch.int64)
    if idx.numel():
        lo, hi = (builtins.int(v) for v in torch.stack([idx.min(), idx.max()]).tolist())
        if lo < -n or hi >= n:
            raise IndexError(f"index {lo if lo < -n else hi} is out of bounds for axis {axis} "
                             f"with size {n}")
    return torch.where(idx < 0, idx + n, idx)


def _slice_len(start: int, stop: int, step: int) -> int:
    return len(range(start, stop, step))


def _walk(key, ndim: int):
    """``(entry, dim)`` for each entry of a numpy key: the first input
    dimension the entry indexes (a boolean array consumes as many dimensions
    as it has, ``None`` none)."""
    entries = list(key) if isinstance(key, tuple) else [key]
    used = builtins.sum(e.ndim if _is_bool_array(e, 0) else (0 if e is None or e is Ellipsis
                                                               else 1) for e in entries)
    out, d = [], 0
    for e in entries:
        out.append((e, d))
        if e is Ellipsis:
            d += ndim - used
        elif _is_bool_array(e, 0):
            d += e.ndim
        elif e is not None:
            d += 1
    return out


def _torch_key(key, shape):
    """``key`` as torch indexes it, with each negative-step slice made a
    positive-step slice over its dimension reversed; returns the key and the
    dimensions to reverse before indexing."""
    flips, out = [], []
    for e, d in _walk(key, len(shape)):
        if isinstance(e, slice) and e.step is not None and e.step < 0:
            if d >= len(shape):
                raise IndexError("too many indices for array")
            n = shape[d]
            start, stop, step = e.indices(n)
            length = _slice_len(start, stop, step)
            s0 = n - 1 - start
            e = slice(s0, s0 + (length - 1) * (-step) + 1, -step) if length else slice(0, 0)
            flips.append(d)
        out.append(e)
    return (tuple(out) if isinstance(key, tuple) else out[0]), flips


def _wrap(t: torch.Tensor, split: Optional[int], like: DNDarray, dtype=None) -> DNDarray:
    """A global result present on every rank, cut to this rank's chunk."""
    from .factories import _from_global

    if t.ndim == 0 or (split is not None and split >= t.ndim):
        split = None
    return _from_global(t, split, like.device, like.comm,
                        dtype if dtype is not None else like.dtype)


# ----------------------------------------------------------------- getitem


def _advanced_take(x: DNDarray, axis: int, idx: torch.Tensor) -> DNDarray:
    """``x`` indexed by a 1-D integer array along ``axis``, keeping ``x``'s
    split (the JAX package's ``_advanced_take``)."""
    n = x.shape[axis]
    idx = _check_bounds(idx, n, axis)
    gshape = x.shape[:axis] + (idx.shape[0],) + x.shape[axis + 1:]
    from . import program_cache

    data = program_cache.cached_program(
        "sharded_take", (axis, x.split, x.ndim), lambda: _take_program, comm=x.comm,
        inline=True)(x.larray, idx, axis, x.split, n, gshape, x.comm)
    return DNDarray(data, gshape, x.dtype, x.split, x.device, x.comm, True)


def _take_program(local: torch.Tensor, idx: torch.Tensor, axis: int, split: Optional[int],
                  n: int, gshape: tuple, comm: TorchCommunication) -> torch.Tensor:
    """This rank's chunk of ``x[..., idx, ...]`` along ``axis`` (the
    registry program of site ``sharded_take``): along a distributed split
    axis each rank fetches its result rows from their owners in one
    exchange, else a local select."""
    if axis == split and comm.size > 1:
        def wanted(q):
            return idx[comm.chunk(gshape, axis, rank=q)[2][axis]]

        data = _fetch_rows(local.movedim(axis, 0), n, comm, wanted).movedim(0, axis)
    else:
        data = _index_select(local, axis, idx)
    return data.contiguous()


def _take_rows(x: DNDarray, idx: torch.Tensor) -> DNDarray:
    """``x[idx]`` along axis 0 for a 1-D index vector that every rank
    holds, with ``x``'s split kept. Negative indices count from the end;
    an index out of range raises ``IndexError``."""
    return _advanced_take(x, 0, idx.to(device=x.larray.device))


def _paired_take(x: DNDarray, pos0: int, rows: torch.Tensor, cols: torch.Tensor) -> DNDarray:
    """``x[..., rows, cols, ...]``: two adjacent 1-D integer arrays at
    ``(pos0, pos0+1)``, every other entry a full slice (``_paired_take``)."""
    rows = _check_bounds(rows, x.shape[pos0], pos0)
    cols = _check_bounds(cols, x.shape[pos0 + 1], pos0 + 1)
    rows, cols = torch.broadcast_tensors(rows, cols)
    k = rows.shape[0]
    gshape = x.shape[:pos0] + (k,) + x.shape[pos0 + 2:]
    lead = (slice(None),) * pos0
    s = x.split
    if s is None or s < pos0 or s > pos0 + 1 or x.comm.size == 1:
        data = _unbits(_bits(x.larray)[lead + (rows, cols)], x.larray.dtype)
        out_split = None if s is None else (s if s < pos0 else (pos0 if s <= pos0 + 1 else s - 1))
        return DNDarray(data.contiguous(), gshape, x.dtype, out_split, x.device, x.comm, True)
    # the split dimension is one of the pair: gather along it first (the
    # result's chunks of k), then pick the partner index of each local row
    sl = x.comm.chunk((k,), 0)[2][0]
    lo, hi = sl.start, sl.stop
    local = torch.arange(hi - lo, device=rows.device)
    if s == pos0:
        y = _advanced_take(x, pos0, rows).larray
        data = _bits(y)[lead + (local, cols[lo:hi])]
    else:
        y = _advanced_take(x, pos0 + 1, cols).larray
        data = _bits(y)[lead + (rows[lo:hi], local)]
    data = _unbits(data, x.larray.dtype)
    return DNDarray(data.contiguous(), gshape, x.dtype, pos0, x.device, x.comm, True)


def _mask_local(mask, x: DNDarray) -> torch.Tensor:
    """This rank's chunk of a full-shape mask given as an array or a
    DNDarray (a split mask on ``x``'s chunks stays local)."""
    if isinstance(mask, DNDarray):
        if mask.split == x.split or x.comm.size == 1:
            return mask.larray.to(x.larray.device)
        if mask.split is not None and x.split is not None:
            return mask.resplit(x.split).larray.to(x.larray.device)
        mask = mask._global()
    mask = mask.to(x.larray.device)
    if x.split is None:
        return mask
    return mask[x.comm.chunk(x.shape, x.split)[2]]


def _mask_ranks(mask: torch.Tensor, gshape, split: Optional[int], comm: TorchCommunication):
    """For this rank's chunk ``mask`` of a full-shape mask split along
    ``split``: the global rank among the True positions (in row-major
    order) of each of its True positions, in its own row-major order, and
    the total count. The ranks' counts (per leading index) travel in one
    collective; the total is read on the host."""
    if split is None or comm.size == 1:
        n = builtins.int(mask.sum())
        return torch.arange(n, device=mask.device), n
    a = builtins.int(np.prod(gshape[:split], dtype=np.int64))
    cnt = mask.reshape(a, -1).sum(1, dtype=torch.int64)
    table = comm.allgather(cnt[None].contiguous(), 0, comm.size)  # (p, a)
    total = builtins.int(table.sum())
    base = torch.cumsum(table.sum(0), 0) - table.sum(0) + table[:comm.rank].sum(0)
    k = builtins.int(cnt.sum())
    a_of = torch.repeat_interleave(torch.arange(a, device=mask.device), cnt)
    within = torch.arange(k, device=mask.device) - (torch.cumsum(cnt, 0) - cnt)[a_of]
    return base[a_of] + within, total


def _compact(selected: torch.Tensor, mask: torch.Tensor, gshape, split, comm):
    """This rank's chunk of the 1-D (split=0) compaction whose rows for its
    True positions are ``selected`` (in its row-major order), and the
    total. A split=0 mask selects one contiguous range per rank, which moves
    as a range; another split sends each row with its destination."""
    if split is None or comm.size == 1:
        return selected, selected.shape[0]
    if split == 0:
        counts = comm.allgather(torch.tensor([selected.shape[0]], device=mask.device), 0,
                                comm.size).tolist()
        starts = np.concatenate([[0], np.cumsum(counts)])
        total = builtins.int(starts[-1])
        ranges = [[(builtins.int(starts[q]), builtins.int(counts[q]))] for q in range(comm.size)]
        return _assemble([selected], ranges, total, comm, selected), total
    dest, total = _mask_ranks(mask, gshape, split, comm)
    return _exchange_rows(selected, dest, total, comm), total


def _masked_select(x: DNDarray, mask: torch.Tensor) -> DNDarray:
    """``x[mask]`` for a full-shape mask: 1-D, split=0 when ``x`` is split."""
    sel = _unbits(_bits(x.larray)[mask], x.larray.dtype)
    data, total = _compact(sel, mask, x.shape, x.split, x.comm)
    split = 0 if x.split is not None else None
    return DNDarray(data.contiguous(), (total,), x.dtype, split, x.device, x.comm, True)


def _row_mask_select(x: DNDarray, mask: torch.Tensor) -> DNDarray:
    """``x[mask]`` for a 1-D mask over axis 0 of an n-D array; ``x``'s
    split is kept."""
    dev = x.larray.device
    local = False
    if isinstance(mask, DNDarray):
        local = x.split == 0 and mask.split == 0
        mask = mask.larray if local else mask._global()
    mask = mask.to(dev)
    if x.split == 0 and not local:
        mask = mask[x.comm.chunk((x.shape[0],), 0)[2][0]]
    rows = _unbits(_bits(x.larray)[mask], x.larray.dtype)
    if x.split != 0 or x.comm.size == 1:
        gshape = (rows.shape[0],) + x.shape[1:]
        return DNDarray(rows.contiguous(), gshape, x.dtype, x.split, x.device, x.comm, True)
    data, total = _compact(rows, mask, (x.shape[0],), 0, x.comm)
    return DNDarray(data.contiguous(), (total,) + x.shape[1:], x.dtype, 0, x.device, x.comm,
                    True)


def _basic(x: DNDarray, key) -> DNDarray:
    """A basic key (ints, slices, ``None``, ``Ellipsis``)."""
    expanded = _expand_key(key, x.ndim)
    norm, gshape, d, split_at = [], [], 0, None
    for k in expanded:
        if k is None:
            norm.append(None)
            gshape.append(1)
            continue
        if d >= x.ndim:
            raise IndexError(f"too many indices for array: array is {x.ndim}-dimensional")
        n = x.shape[d]
        if isinstance(k, slice):
            start, stop, step = k.indices(n)
            if d == x.split:
                split_at = len(gshape)
            norm.append((start, stop, step))
            gshape.append(_slice_len(start, stop, step))
        else:
            norm.append(_bound(builtins.int(k), n, d))
        d += 1
    out_split = _result_split(x, key)
    comm, s = x.comm, x.split

    def local_key(split_entry):
        out, dd = [], 0
        for k in norm:
            if k is None:
                out.append(None)
                continue
            if dd == s and split_entry is not None:
                out.append(split_entry)
            elif isinstance(k, tuple):
                start, stop, step = k
                out.append(slice(start, stop if stop >= 0 else None, step) if step > 0 else k)
            else:
                out.append(k)
            dd += 1
        return out

    def apply(t, entries):
        """``t[entries]``, with negative-step slices applied as a reversal."""
        flips, key_ = [], []
        dd = out_d = 0
        for e in entries:
            if e is None:
                key_.append(None)
                out_d += 1
                continue
            if isinstance(e, tuple):  # a negative step
                start, stop, step = e
                length = _slice_len(start, stop, step)
                first = start + (length - 1) * step if length else 0
                key_.append(slice(first, first + (length - 1) * (-step) + 1 if length else 0,
                                  -step))
                flips.append(out_d)
                out_d += 1
            else:
                key_.append(e)
                out_d += 0 if _is_int(e) else 1
            dd += 1
        res = _bits(t)[tuple(key_)]
        return _unbits(_flip(res, flips) if flips else res, t.dtype)

    if s is None or comm.size == 1:
        data = apply(x.larray, local_key(None))
    else:
        k_s = [k for k in norm if k is not None][s]
        sl = comm.chunk(x.shape, s)[2][s]
        lo, hi = sl.start, sl.stop
        if _is_int(k_s):
            row = _fetch_rows(x.larray.movedim(s, 0), x.shape[s], comm,
                              lambda q: torch.tensor([k_s], device=x.larray.device))
            data = apply(row.movedim(0, s), local_key(0))
        elif k_s == (0, x.shape[s], 1):
            data = apply(x.larray, local_key(slice(None)))
        else:
            start, _, step = k_s
            length = gshape[split_at]
            k0, k1 = _slice_part(start, step, length, lo, hi)
            if k1 > k0:
                first, last = start + k0 * step - lo, start + (k1 - 1) * step - lo
                entry = slice(first, last + 1, step) if step > 0 else slice(last, first + 1, -step)
            else:
                entry = slice(0, 0)
            piece = apply(x.larray, local_key(entry))
            if step < 0:
                piece = _flip(piece, [split_at])
            ranges = []
            for q in range(comm.size):
                _, _, sl = comm.chunk(x.shape, s, rank=q)
                q0, q1 = _slice_part(start, step, length, sl[s].start, sl[s].stop)
                ranges.append([(q0, q1 - q0)])
            moved = piece.movedim(split_at, 0)
            data = _assemble([moved], ranges, length, comm, moved).movedim(0, split_at)
    gshape = tuple(gshape)
    if data.ndim == 0 or not gshape:
        return DNDarray(data.clone().reshape(()), (), x.dtype, None, x.device, comm, True)
    if out_split is not None and out_split >= len(gshape):
        out_split = None
    if _shares(data, x.larray):
        data = data.clone()
    return DNDarray(data.contiguous(), gshape, x.dtype, out_split, x.device, comm, True)


def _logical(x: DNDarray, key) -> DNDarray:
    """A key the JAX package applies to its global view: torch's indexing
    of the gathered array, the result cut to its chunks."""
    tkey, flips = _torch_key(key, x.shape)
    whole = x._global()
    whole = _flip(whole, flips) if flips else whole
    res = _unbits(_bits(whole)[tkey], whole.dtype)
    out_split = _result_split(x, key)
    if _shares(res, x.larray):
        res = res.clone()
    return _wrap(res.contiguous(), out_split, x)


def getitem(x: DNDarray, key) -> DNDarray:
    """``x[key]`` (reference ``indexing.getitem``, dndarray.py:993)."""
    if not isinstance(key, DNDarray):
        key = _normalize_key(key, x)
    if _is_mask(key) and tuple(key.shape) == x.shape and x.ndim:
        return _masked_select(x, _mask_local(key, x))
    if _is_mask(key) and key.ndim == 1 and x.ndim > 1 and tuple(key.shape) == (x.shape[0],):
        return _row_mask_select(x, key)
    if isinstance(key, DNDarray):
        key = _key_entry(key, x)

    # a single 1-D integer array, alone or among full slices
    if _is_int_array(key) and key.ndim == 1 and x.ndim >= 1:
        return _advanced_take(x, 0, key)
    if isinstance(key, tuple) and builtins.sum(1 for k in key if _is_int_array(k)) == 1:
        pos = next(i for i, k in enumerate(key) if _is_int_array(k))
        if key[pos].ndim == 1 and len(key) <= x.ndim and builtins.all(
                _full_slice(k) for i, k in enumerate(key) if i != pos):
            return _advanced_take(x, pos, key[pos])

    # ints and slices with one 1-D integer array (the advanced entries
    # consecutive), or two adjacent 1-D integer arrays among full slices
    if isinstance(key, tuple) and len(key) <= x.ndim and not builtins.any(
            k is Ellipsis or k is None for k in key):
        arr_pos = [i for i, k in enumerate(key) if _is_int_array(k)]
        others_basic = builtins.all(_is_int_array(k) or isinstance(k, slice) or _is_int(k)
                                    for k in key)
        adv = [i for i, k in enumerate(key) if _is_int_array(k) or _is_int(k)]
        consecutive = len(adv) <= 1 or adv[-1] - adv[0] + 1 == len(adv)
        if others_basic and consecutive and len(arr_pos) == 1 and key[arr_pos[0]].ndim == 1:
            i = arr_pos[0]
            base = tuple(slice(None) if j == i else k for j, k in enumerate(key))
            y = getitem(x, base) if not builtins.all(_full_slice(k) for k in base) else x
            new_axis = i - builtins.sum(1 for j, k in enumerate(key) if j < i and _is_int(k))
            return _advanced_take(y, new_axis, key[i])
        if others_basic and len(arr_pos) == 2 and arr_pos[1] == arr_pos[0] + 1 \
                and builtins.all(_full_slice(k) for j, k in enumerate(key) if j not in arr_pos) \
                and key[arr_pos[0]].ndim == 1 and key[arr_pos[1]].ndim == 1:
            return _paired_take(x, arr_pos[0], key[arr_pos[0]], key[arr_pos[1]])

    entries = key if isinstance(key, tuple) else (key,)
    if builtins.all(_is_int(k) or isinstance(k, slice) or k is None or k is Ellipsis
                    for k in entries):
        return _basic(x, key)
    return _logical(x, key)


# ----------------------------------------------------------------- setitem


def _exclusive(t: torch.Tensor) -> bool:
    """True when no other tensor shares ``t``'s storage (torch's use count
    of the storage; where torch lacks it, False, and the chunk is copied)."""
    try:
        return torch._C._storage_Use_Count(t.untyped_storage()._cdata) <= 2 and t._base is None
    except (AttributeError, RuntimeError):
        return False


def _writable(x: DNDarray) -> torch.Tensor:
    """``x``'s chunk, made contiguous and its own (copied first when another
    array shares it), ready for writes in place."""
    from . import fusion

    t = x.larray
    if not t.is_contiguous() or not _exclusive(t):
        t = t.contiguous() if not t.is_contiguous() else t.clone()
        x.larray = t
    fusion.before_write(t)  # a pending chain that holds t computes first
    return t


def _value_tensor(value, x: DNDarray) -> torch.Tensor:
    dt, dev = x.larray.dtype, x.larray.device
    if isinstance(value, DNDarray):
        value = value._global()
    if isinstance(value, torch.Tensor):
        return value.to(device=dev, dtype=dt)
    return torch.as_tensor(np.asarray(value), device=dev).to(dt)


def _broadcast_value(v: torch.Tensor, shape) -> torch.Tensor:
    """``v`` broadcast to ``shape`` as numpy broadcasts an assigned value
    (leading dimensions of size 1 may be dropped)."""
    while v.ndim > len(shape) and v.shape[0] == 1:
        v = v[0]
    try:
        return torch.broadcast_to(v, tuple(shape))
    except RuntimeError:
        raise ValueError(f"could not broadcast input array from shape {tuple(v.shape)} into "
                         f"shape {tuple(shape)}") from None


def _setitem_mask(x: DNDarray, mask: torch.Tensor, value) -> None:
    """``x[mask] = value`` for a full-shape mask: a scalar, a value of
    ``x``'s shape, or one value for each True position (in row-major order:
    each rank's positions take the value entries at their global ranks)."""
    if isinstance(value, DNDarray) and value.shape == x.shape:
        if value.split == x.split or x.comm.size == 1:
            vloc = value.larray
        elif value.split is not None and x.split is not None:
            vloc = value.resplit(x.split).larray
        else:
            vloc = value._global()
            if x.split is not None:
                vloc = vloc[x.comm.chunk(x.shape, x.split)[2]]
        buf = _writable(x)
        _bits(buf)[mask] = _bits(vloc.to(device=buf.device, dtype=buf.dtype))[mask]
        return
    if isinstance(value, DNDarray) and value.ndim == 1 and value.split is not None \
            and value.size > 1 and x.comm.size > 1:
        dest, total = _mask_ranks(mask, x.shape, x.split, x.comm)
        if value.shape[0] != total:
            raise ValueError(f"cannot assign {value.shape[0]} input values to the {total} "
                             f"output values where the mask is true")
        vals = _request(value.larray, _chunk_bounds(value.shape[0], x.comm), x.comm, dest)
        buf = _writable(x)
        _bits(buf)[mask] = _bits(vals.to(buf.dtype))
        return
    val = _value_tensor(value, x)
    buf = _writable(x)
    if val.numel() == 1:
        _bits(buf).masked_fill_(mask, _bits(val.reshape(())))
    elif tuple(val.shape) == x.shape:
        if x.split is not None:
            val = val[x.comm.chunk(x.shape, x.split)[2]]
        _bits(buf)[mask] = _bits(val)[mask]
    else:
        dest, total = _mask_ranks(mask, x.shape, x.split, x.comm)
        val = val.reshape(-1)
        if val.shape[0] != total:
            raise ValueError(f"cannot assign {val.shape[0]} input values to the {total} "
                             f"output values where the mask is true")
        _bits(buf)[mask] = _bits(val)[dest]


def _targets(shape, key, device) -> torch.Tensor:
    """The global flat positions that ``key`` selects, in the shape numpy
    gives ``x[key]``: the key applied to a grid of global indices (one
    zero-stride view per dimension, so only the selection is built)."""
    tkey, flips = _torch_key(key, shape)
    strides = np.cumprod((1,) + tuple(shape[::-1]))[:-1][::-1] if shape else []
    total = None
    for d, n in enumerate(shape):
        j = torch.arange(n, device=device)
        if d in flips:
            j = j.flip(0)
        view = j.view((1,) * d + (n,) + (1,) * (len(shape) - d - 1)).expand(shape)
        part = view[tkey] * builtins.int(strides[d])
        total = part if total is None else total + part
    if total is None:  # a 0-d array
        total = torch.zeros((), dtype=torch.int64, device=device)[tkey]
    return total


def _setitem_general(x: DNDarray, key, value) -> None:
    """``x[key] = value`` for any key numpy takes: each rank writes the
    selected positions of its own chunk, taking the value entries there."""
    dev = x.larray.device
    g = _targets(x.shape, key, dev)
    shape = tuple(g.shape)
    g = g.reshape(-1)
    comm, s = x.comm, x.split
    if s is None or comm.size == 1:
        mine, local = None, g
    else:
        inner = builtins.int(np.prod(x.shape[s + 1:], dtype=np.int64))
        n_s = x.shape[s]
        sl = comm.chunk(x.shape, s)[2][s]
        lo, hi = sl.start, sl.stop
        coord = torch.div(g, inner, rounding_mode="floor") % n_s
        outer = torch.div(g, inner * n_s, rounding_mode="floor")
        mine = (coord >= lo) & (coord < hi)
        local = (outer * ((hi - lo) * inner) + (coord - lo) * inner + g % inner)[mine]
    if isinstance(value, DNDarray) and value.split is not None and comm.size > 1 \
            and value.ndim == len(shape) and value.shape == shape:
        # fetch only the value entries of this rank's targets from their owners
        v0 = value if value.split == 0 else value.resplit(0)
        inner_v = builtins.int(np.prod(shape[1:], dtype=np.int64))
        bounds = [b * inner_v for b in _chunk_bounds(shape[0], comm)]
        pos = torch.arange(g.shape[0], device=dev)
        pos = pos if mine is None else pos[mine]
        vals = _request(v0.larray.reshape(-1).to(dev), bounds, comm, pos)
    else:
        v = _broadcast_value(_value_tensor(value, x), shape).reshape(-1)
        vals = v if mine is None else v[mine]
    buf = _writable(x)
    _bits(buf.view(-1))[local] = _bits(vals.to(buf.dtype))


def setitem(x: DNDarray, key, value) -> None:
    """``x[key] = value`` (reference ``indexing.setitem``, dndarray.py:998),
    in place on each rank's chunk."""
    if not isinstance(key, DNDarray):
        key = _normalize_key(key, x)
    if _is_mask(key) and tuple(key.shape) == x.shape and x.ndim:
        return _setitem_mask(x, _mask_local(key, x), value)
    if isinstance(key, DNDarray):
        key = _key_entry(key, x)
    _setitem_general(x, key, value)


# --------------------------------------------------------- nonzero, where


def nonzero(x: DNDarray) -> DNDarray:
    """The indices of the nonzero elements as an ``(nnz, ndim)`` int64
    array, split=0 when ``x`` is split (reference indexing.py ``nonzero``):
    each rank's local indices, offset to global ones, compacted as a
    full-shape mask selection is."""
    buf = x.larray
    mask = buf != 0 if buf.dtype != torch.bool else buf
    coords = torch.nonzero(mask)
    if x.split is not None and coords.shape[0]:
        coords[:, x.split] += x.comm.chunk(x.shape, x.split)[0]
    data, total = _compact(coords, mask, x.shape, x.split, x.comm)
    split = 0 if x.split is not None else None
    return DNDarray(data.contiguous(), (total, x.ndim), types.int64, split, x.device, x.comm,
                    True)


def where(cond: DNDarray, x=None, y=None) -> DNDarray:
    """Three-argument elementwise select, or one-argument ``nonzero``
    (reference indexing.py ``where``): operands split along different
    dimensions raise; a replicated operand spanning the result's split
    dimension is cut to this rank's chunk."""
    from . import factories
    from ._operations import _apply, _cast, result_type
    from .stride_tricks import broadcast_shape

    if x is None and y is None:
        return nonzero(cond)
    if x is None or y is None:
        raise TypeError("either both or neither of x and y must be given")
    if not isinstance(cond, DNDarray):
        cond = factories.array(cond)
    operands = [cond, x, y]
    dnd = [o for o in operands if isinstance(o, DNDarray)]
    comm, device = dnd[0].comm, dnd[0].device
    out_shape = ()
    for o in operands:
        out_shape = broadcast_shape(out_shape, o.shape if isinstance(o, DNDarray) else ())
    ndim = len(out_shape)
    splits = [o.split + (ndim - o.ndim) for o in dnd if o.split is not None]
    out_split = splits[0] if splits else None
    if builtins.any(s != out_split for s in splits):
        raise ValueError("operands are distributed along different axes")

    def local(o):
        if not isinstance(o, DNDarray):
            return o
        buf = o.larray
        if out_split is not None and o.split is None:
            own = out_split - (ndim - o.ndim)
            if own >= 0 and o.shape[own] == out_shape[out_split] and out_shape[out_split] != 1:
                sl = comm.chunk(out_shape, out_split)[2][out_split]
                buf = buf.narrow(own, sl.start, sl.stop - sl.start)
        return buf

    c, a, b = (local(o) for o in operands)
    dtype = result_type(a, b) if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor) \
        else result_type(torch.as_tensor(a), b)
    a, b = _cast(a, dtype), _cast(b, dtype)
    dev = c.device
    a = a if isinstance(a, torch.Tensor) else torch.tensor(a, dtype=dtype, device=dev)
    b = b if isinstance(b, torch.Tensor) else torch.tensor(b, dtype=dtype, device=dev)
    res = _apply(lambda u, v: torch.where(c.to(torch.bool), u, v), a, b)
    return DNDarray(res, out_shape, types.canonical_heat_type(res.dtype), out_split, device,
                    comm, True)
