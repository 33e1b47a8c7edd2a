"""Shape and layout manipulations (counterpart of
``heat_tpu/core/manipulations.py``), with the distributed ``sort``,
``topk`` and ``unique``.

Every result lies on the ceil-rule chunks of its own shape. Rows that a
rank holds but another owns move in one exchange of contiguous ranges
(``indexing._assemble``: every rank knows every range, so no index
travels): ``concatenate`` along the split axis, ``reshape`` across it (the
chunks of a split=0 array are contiguous ranges of the flat array),
``flip`` and ``roll`` along it (a rank's chunk lands as one or two ranges).
``pad``, ``tile``, ``repeat``, ``diag``/``diagonal`` and the ``stack``
family gather where the JAX package computes on its global view.

**sort** along the split axis is the JAX package's odd-even merge-split
network: each rank sorts its chunk, padded to ``c = ceil(n/p)`` with
sentinel entries, then ``p`` rounds of partner exchange (``ppermute``) keep
the ``c`` smallest on the lower rank and the ``c`` largest on the higher,
ordered by (sentinel flag, value, global index). With equal blocks ``p``
rounds sort; the sentinels, which a flag (not ``+inf``) puts after every
value, NaN included, end at the global tail, which is exactly where the
chunks' shortfall is, and are dropped. Ties break by global index, NaN
sorts last ascending (first descending), and descending keeps ties in
ascending index order. ``torch.sort`` takes one key, so the order of
several keys is built by stable sorts from the last key to the first.
Off the split axis, and on one rank, it is one stable ``torch.sort``.

**topk** along the split axis takes each rank's ``k`` candidates with
their global indices, gathers them and selects again (ties to the lowest
index); the result is replicated. **unique** sorts (the network), marks
the first of each run against the left neighbour's last element, numbers
the runs by an exclusive scan and compacts; rows (``axis=k``) sort
lexicographically by the same network.
"""

from __future__ import annotations

import builtins
import operator
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import program_cache, types
from ._operations import from_order_key, order_key
from .dndarray import DNDarray
from .indexing import (_BITS_AS, _assemble, _bits, _exchange_rows, _fetch_rows, _flip,
                       _index_select, _unbits, _wrap, getitem)
from .stride_tricks import sanitize_axis, sanitize_shape

__all__ = [
    "balance",
    "column_stack",
    "concatenate",
    "diag",
    "diagonal",
    "dsplit",
    "expand_dims",
    "flatten",
    "flip",
    "fliplr",
    "flipud",
    "hsplit",
    "hstack",
    "moveaxis",
    "pad",
    "ravel",
    "redistribute",
    "repeat",
    "reshape",
    "resplit",
    "roll",
    "rot90",
    "row_stack",
    "shape",
    "sort",
    "split",
    "squeeze",
    "stack",
    "swapaxes",
    "tile",
    "topk",
    "unique",
    "vsplit",
    "vstack",
]


def _new(t: torch.Tensor, gshape, dtype, split, like: DNDarray) -> DNDarray:
    return DNDarray(t, tuple(gshape), dtype, split, like.device, like.comm, True)


def _as_dnd(a, like: Optional[DNDarray] = None) -> DNDarray:
    if isinstance(a, DNDarray):
        return a
    from . import factories

    if like is None:
        return factories.array(a)
    return factories.array(a, device=like.device, comm=like.comm)


def _chunk_range(n: int, comm, rank: int) -> Tuple[int, int]:
    sl = comm.chunk((n,), 0, rank=rank)[2][0]
    return sl.start, sl.stop


def _local_chunk(t: torch.Tensor, dim: int, comm) -> torch.Tensor:
    """This rank's ceil-rule chunk of a tensor every rank holds whole."""
    lo, hi = _chunk_range(t.shape[dim], comm, comm.rank)
    return t.narrow(dim, lo, hi - lo)


def _move_along(pieces, ranges, n: int, dim: int, comm, like: torch.Tensor) -> torch.Tensor:
    """``indexing._assemble`` along dimension ``dim``."""
    moved = [p.movedim(dim, 0) for p in pieces]
    return _assemble(moved, ranges, n, comm, like.movedim(dim, 0)).movedim(0, dim)


def _permute_split_axis(pieces, ranges, n: int, dim: int, comm, like: torch.Tensor):
    """A permutation along the split dimension ``dim`` (flip, roll): the
    ranges each rank's pieces land at are the data of one registry program
    (site ``permute_split_axis``), as the index map is the JAX package's."""
    return program_cache.cached_program(
        "permute_split_axis", (dim, n, like.ndim), lambda: _move_along, comm=comm,
        inline=True)(pieces, ranges, n, dim, comm, like)


# ------------------------------------------------------------- the layout


def balance(array: DNDarray, copy: bool = False) -> DNDarray:
    """A balanced array (reference manipulations.py:87): every array lies on
    the ceil-rule chunks already, so this is the input or its copy."""
    from .memory import copy as _copy

    return _copy(array) if copy else array


def resplit(arr: DNDarray, axis: Optional[int] = None, *, audit: bool = False,
            precision: Optional[str] = None) -> DNDarray:
    """Out-of-place redistribution to a new split axis (reference
    manipulations.py:536): one ``all_to_all`` between two split axes. A
    ``resplit`` telemetry span; ``audit=True`` audits its collectives
    (:meth:`DNDarray.resplit`).

    ``precision`` (``off | bf16 | int8 | blockwise``, default the
    ``HEAT_TPU_COLLECTIVE_PREC`` knob) moves a float payload compressed
    (:func:`.collective_prec.reshard`, the JAX package's scales); ``off``
    is the exact relayout. A compressed move audits against
    ``relayout_cost(..., precision=)``."""
    from . import collective_prec
    from .. import telemetry

    axis = sanitize_axis(arr.shape, axis)
    wire = collective_prec.effective(arr.larray.dtype, precision)
    if wire == "off" or arr.split is None or axis == arr.split or arr.comm.size == 1:
        return arr.resplit(axis, audit=audit)

    def run() -> DNDarray:
        moved = program_cache.cached_program(
            "relayout", (arr.shape, arr.dtype, arr.split, axis, wire),
            lambda: collective_prec.reshard, comm=arr.comm, inline=True)(arr, axis, wire)
        return DNDarray(moved, arr.shape, arr.dtype, axis, arr.device, arr.comm, True)

    if not (audit or telemetry.hlo.audit_enabled()):
        return run()
    phys = list(arr.shape)
    for ax in (arr.split, axis):
        if ax is not None:
            phys[ax] = arr.comm.padded_size(phys[ax])
    predicted = telemetry.collectives.relayout_cost(
        phys, arr.dtype.byte_size(), arr.split, axis, arr.comm.size, precision=wire,
        block=collective_prec.block_size())
    out, _ = telemetry.hlo.audit_call(
        "resplit", run, predicted=predicted,
        fields={"old_split": arr.split, "new_split": axis, "gshape": list(arr.shape),
                "wire": wire})
    return out


def redistribute(arr: DNDarray, lshape_map=None, target_map=None) -> DNDarray:
    """``DNDarray.redistribute_`` on a copy."""
    from .memory import copy as _copy

    out = _copy(arr)
    out.redistribute_(lshape_map, target_map)
    return out


def shape(a: DNDarray) -> Tuple[int, ...]:
    """The global shape."""
    return a.shape


# --------------------------------------------------------- joining arrays


def concatenate(arrays: Sequence[DNDarray], axis: int = 0) -> DNDarray:
    """Join arrays along an existing axis (reference manipulations.py:149).
    All replicated: a replicated result. Otherwise the inputs' one split:
    off the joined axis each rank joins its chunks (a replicated input
    contributes its chunk); along it each input's chunks become ranges of
    the result and move to its chunks in one exchange. Inputs split along
    different axes raise ``RuntimeError``."""
    arrays = list(arrays)
    if len(arrays) < 1:
        raise ValueError("need at least one array to concatenate")
    like = next((a for a in arrays if isinstance(a, DNDarray)), None)
    arrays = [_as_dnd(a, like) for a in arrays]
    axis = sanitize_axis(arrays[0].shape, axis)
    splits = {a.split for a in arrays if a.split is not None}
    if len(splits) > 1:
        raise RuntimeError(f"concatenate inputs are distributed along different axes "
                           f"{sorted(splits)}; resplit first")
    for a in arrays[1:]:
        if a.ndim != arrays[0].ndim or builtins.any(
                a.shape[d] != arrays[0].shape[d] for d in range(a.ndim) if d != axis):
            raise ValueError(f"all the input array dimensions except for the concatenation axis "
                             f"must match exactly, got {arrays[0].shape} and {a.shape}")
    out_split = next(iter(splits), None)
    out_dtype = arrays[0].dtype
    for a in arrays[1:]:
        out_dtype = types.promote_types(out_dtype, a.dtype)
    tdt = out_dtype.torch_type()
    comm = arrays[0].comm
    gshape = list(arrays[0].shape)
    gshape[axis] = builtins.sum(a.shape[axis] for a in arrays)

    def chunk_of(a: DNDarray) -> torch.Tensor:
        buf = a.larray
        if out_split is not None and a.split is None and comm.size > 1:
            buf = _local_chunk(buf, out_split, comm)
        return buf.to(tdt)

    if out_split is None or axis != out_split or comm.size == 1:
        res = torch.cat([a.larray.to(tdt) if out_split is None else chunk_of(a) for a in arrays],
                        dim=axis)
        return _new(res, gshape, out_dtype, out_split, arrays[0])
    ranges, pieces, off = [[] for _ in range(comm.size)], [], 0
    for a in arrays:
        n = a.shape[axis]
        for q in range(comm.size):
            lo, hi = _chunk_range(n, comm, q)
            ranges[q].append((off + lo, hi - lo))
        pieces.append(chunk_of(a))
        off += n
    key = (axis, out_split, tuple(a.shape for a in arrays), tuple(gshape), str(tdt))
    res = program_cache.cached_program("concat_split", key, lambda: _move_along, comm=comm,
                                       inline=True)(pieces, ranges, gshape[axis], axis, comm,
                                                    pieces[0])
    return _new(res.contiguous(), gshape, out_dtype, out_split, arrays[0])


def column_stack(arrays: Sequence[DNDarray]) -> DNDarray:
    """Stack 1-D and 2-D arrays as columns of a 2-D array."""
    return concatenate([expand_dims(a, 1) if a.ndim == 1 else a for a in arrays], axis=1)


def hstack(arrays: Sequence[DNDarray]) -> DNDarray:
    arrays = list(arrays)
    if builtins.all(a.ndim == 1 for a in arrays):
        return concatenate(arrays, axis=0)
    return concatenate(arrays, axis=1)


def row_stack(arrays: Sequence[DNDarray]) -> DNDarray:
    """Stack arrays as rows (reference manipulations.py:643): 1-D inputs
    become rows; among 2-D inputs a 1-D one is a replicated row."""
    arrays = list(arrays)
    if builtins.all(a.ndim == 1 for a in arrays):
        prepared = [expand_dims(a, 0) for a in arrays]
    else:
        prepared = [_new(a._global()[None, :], (1,) + a.shape, a.dtype, None, a)
                    if a.ndim == 1 else a for a in arrays]
    return concatenate(prepared, axis=0)


vstack = row_stack


def stack(arrays: Sequence[DNDarray], axis: int = 0, out=None) -> DNDarray:
    """Join along a new axis (reference manipulations.py:868): arrays of one
    split and shape stack their chunks; otherwise the gathered arrays."""
    arrays = list(arrays)
    if len(arrays) < 1:
        raise ValueError("need at least one array to stack")
    like = next((a for a in arrays if isinstance(a, DNDarray)), None)
    arrays = [_as_dnd(a, like) for a in arrays]
    splits = {a.split for a in arrays if a.split is not None}
    if len(splits) > 1:
        raise RuntimeError(f"stack inputs are distributed along different axes "
                           f"{sorted(splits)}; resplit first")
    proto = arrays[0]
    if builtins.any(a.shape != proto.shape for a in arrays):
        raise ValueError("all input arrays must have the same shape")
    ndim_out = proto.ndim + 1
    ax = sanitize_axis((1,) * ndim_out, axis)
    in_split = next(iter(splits), None)
    out_split = in_split + 1 if in_split is not None and ax <= in_split else in_split
    dtype = proto.dtype
    for a in arrays[1:]:
        dtype = types.promote_types(dtype, a.dtype)
    tdt = dtype.torch_type()
    gshape = proto.shape[:ax] + (len(arrays),) + proto.shape[ax:]
    if builtins.all(a.split == in_split for a in arrays):
        res = torch.stack([a.larray.to(tdt) for a in arrays], dim=ax)
        result = _new(res, gshape, dtype, out_split, proto)
    else:
        res = torch.stack([a._global().to(tdt) for a in arrays], dim=ax)
        result = _wrap(res, out_split, proto, dtype)
    if out is not None:
        out.larray = result.larray.to(out.larray.dtype)
        return out
    return result


# ------------------------------------------------------- splitting arrays


def split(x: DNDarray, indices_or_sections, axis: int = 0) -> List[DNDarray]:
    """Split into sub-arrays along ``axis`` (reference manipulations.py:807).
    Off the split axis the pieces cut each chunk; along it each piece is a
    slice of the split axis (``getitem``'s range exchange)."""
    axis = sanitize_axis(x.shape, axis)
    n = x.shape[axis]
    if isinstance(indices_or_sections, (builtins.int, np.integer)):
        sections = builtins.int(indices_or_sections)
        if sections <= 0:
            raise ValueError("number sections must be larger than 0.")
        if n % sections:
            raise ValueError("array split does not result in an equal division")
        bounds = [i * (n // sections) for i in range(sections + 1)]
    else:
        if isinstance(indices_or_sections, DNDarray):
            indices_or_sections = indices_or_sections.tolist()
        idx = [builtins.int(i) for i in indices_or_sections]
        bounds = [0] + idx + [n]
    pieces = []
    for a, b in zip(bounds[:-1], bounds[1:]):
        a, b = slice(a, b).indices(n)[:2]
        key = (slice(None),) * axis + (slice(a, builtins.max(a, b)),)
        pieces.append(getitem(x, key))
    return pieces


def hsplit(x: DNDarray, indices_or_sections) -> List[DNDarray]:
    return split(x, indices_or_sections, axis=0 if x.ndim < 2 else 1)


def vsplit(x: DNDarray, indices_or_sections) -> List[DNDarray]:
    return split(x, indices_or_sections, axis=0)


def dsplit(x: DNDarray, indices_or_sections) -> List[DNDarray]:
    return split(x, indices_or_sections, axis=2)


# ------------------------------------------------------------ dimensions


def expand_dims(a: DNDarray, axis: int) -> DNDarray:
    """Insert a dimension of size 1 (a view of each chunk)."""
    axis = sanitize_axis(tuple(a.shape) + (1,), axis)
    split = a.split + 1 if a.split is not None and axis <= a.split else a.split
    return _new(a.larray.unsqueeze(axis), a.shape[:axis] + (1,) + a.shape[axis:], a.dtype,
                split, a)


def squeeze(x: DNDarray, axis=None) -> DNDarray:
    """Remove dimensions of size 1 (reference manipulations.py:837); when
    the split dimension goes, its one row is sent by its owner and the
    result is replicated."""
    if axis is not None:
        ax = sanitize_axis(x.shape, axis)
        axes = (ax,) if isinstance(ax, builtins.int) else tuple(ax)
        for a in axes:
            if x.shape[a] != 1:
                raise ValueError(f"cannot select an axis to squeeze out which has size not equal "
                                 f"to one, got axis {a}")
    else:
        axes = tuple(d for d, s in enumerate(x.shape) if s == 1)
    gshape = tuple(s for d, s in enumerate(x.shape) if d not in axes)
    buf, split = x.larray, x.split
    if split is not None and split in axes:
        if x.comm.size > 1:
            buf = _fetch_rows(buf.movedim(split, 0), 1, x.comm,
                              lambda q: torch.zeros(1, dtype=torch.int64,
                                                    device=buf.device)).movedim(0, split)
        split = None
    elif split is not None:
        split -= builtins.sum(1 for a in axes if a < split)
    res = buf.squeeze(axes) if axes else buf
    return _new(res, gshape, x.dtype, split, x)


def flatten(a: DNDarray) -> DNDarray:
    """A 1-D copy (``reshape`` to ``(-1,)``, split=0 when ``a`` is split)."""
    return reshape(a, (-1,), new_split=0 if a.split is not None else None)


def ravel(a: DNDarray) -> DNDarray:
    return flatten(a)


def reshape(a: DNDarray, *shape, new_split: Optional[int] = None) -> DNDarray:
    """A new global shape (reference manipulations.py:458). A reshape that
    keeps the split dimension and everything before it (or everything from
    it on) reshapes each chunk alone; one that crosses it moves contiguous
    ranges of the flat array: the chunks of a split=0 array are such
    ranges, so an array split elsewhere goes to split 0 first, and a result
    split elsewhere comes from split 0 by one ``all_to_all``."""
    if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
        shape = tuple(shape[0])
    shape = list(shape)
    neg = [i for i, s in enumerate(shape) if s == -1]
    if len(neg) > 1:
        raise ValueError("can only specify one unknown dimension")
    if neg:
        known = builtins.int(np.prod([s for i, s in enumerate(shape) if i != neg[0]],
                                     dtype=np.int64))
        if known == 0:
            raise ValueError(f"cannot reshape array of size {a.size} into shape {tuple(shape)}")
        shape[neg[0]] = a.size // known
    shape = sanitize_shape(tuple(shape))
    if builtins.int(np.prod(shape, dtype=np.int64)) != a.size:
        raise ValueError(f"cannot reshape array of size {a.size} into shape {tuple(shape)}")
    if new_split is None:
        if a.split is None:
            new_split = None
        elif a.split < len(shape):
            new_split = a.split
        else:
            cand = len(shape) - (a.ndim - a.split)
            lead = builtins.int(np.prod(shape[:cand], dtype=np.int64)) if cand >= 0 else -1
            if cand >= 0 and tuple(shape[cand:]) == tuple(a.shape[a.split:]) and \
                    lead == builtins.int(np.prod(a.shape[:a.split], dtype=np.int64)):
                new_split = cand
            else:
                new_split = 0
    new_split = sanitize_axis(shape, new_split)
    comm, s = a.comm, a.split
    if s is None or comm.size == 1:
        res = a.larray.reshape(shape)
        if new_split is not None and comm.size > 1:
            res = _local_chunk(res, new_split, comm)
        return _new(res, shape, a.dtype, new_split, a)
    if new_split is not None:
        prod = lambda t: builtins.int(np.prod(t, dtype=np.int64))  # noqa: E731
        if new_split == s and shape[:s + 1] == tuple(a.shape[:s + 1]):
            res = a.larray.reshape(a.lshape[:s + 1] + shape[s + 1:])
            return _new(res, shape, a.dtype, s, a)
        if shape[new_split:] == tuple(a.shape[s:]) and \
                prod(shape[:new_split]) == prod(a.shape[:s]):
            res = a.larray.reshape(shape[:new_split] + a.lshape[s:])
            return _new(res, shape, a.dtype, new_split, a)
    return program_cache.cached_program(
        "reshape_split", (tuple(a.shape), tuple(shape), new_split), lambda: _reshape_crossing,
        comm=comm, inline=True)(a, shape, new_split)


def _reshape_crossing(a: DNDarray, shape: tuple, new_split: Optional[int]) -> DNDarray:
    """A reshape of a distributed ``a`` that crosses its split dimension
    (the registry program of site ``reshape_split``): contiguous ranges of
    the flat array move from the split=0 chunks to the result's."""
    comm, s = a.comm, a.split
    src = a if s == 0 else a.resplit(0)
    inner_in = builtins.int(np.prod(a.shape[1:], dtype=np.int64))
    ranges = []
    for q in range(comm.size):
        lo, hi = _chunk_range(a.shape[0], comm, q)
        ranges.append([(lo * inner_in, (hi - lo) * inner_in)])
    inner_out = builtins.int(np.prod(shape[1:], dtype=np.int64))
    bounds = [lo * inner_out for lo in (list(comm.counts_displs(shape[0])[1]) + [shape[0]])]
    flat = src.larray.reshape(-1)
    moved = _assemble([flat], ranges, a.size, comm, flat, bounds=bounds)
    out = _new(moved.reshape((-1,) + shape[1:]), shape, a.dtype, 0, a)
    if new_split is None:
        return out.resplit(None)
    return out if new_split == 0 else out.resplit(new_split)


def moveaxis(x: DNDarray, source, destination) -> DNDarray:
    """Move axes to new positions (a transpose)."""
    from .linalg import transpose

    source = (source,) if isinstance(source, builtins.int) else source
    destination = (destination,) if isinstance(destination, builtins.int) else destination
    source = [sanitize_axis(x.shape, s) for s in source]
    destination = [sanitize_axis(x.shape, d) for d in destination]
    if len(source) != len(destination):
        raise ValueError("source and destination arguments must have the same number of "
                         "elements")
    order = [n for n in range(x.ndim) if n not in source]
    for dest, src in sorted(zip(destination, source)):
        order.insert(dest, src)
    return transpose(x, order)


def swapaxes(x: DNDarray, axis1: int, axis2: int) -> DNDarray:
    """Interchange two axes (a transpose)."""
    from .linalg import transpose

    axis1, axis2 = sanitize_axis(x.shape, axis1), sanitize_axis(x.shape, axis2)
    order = list(range(x.ndim))
    order[axis1], order[axis2] = order[axis2], order[axis1]
    return transpose(x, order)


# ------------------------------------------------------ reordering arrays


def flip(a: DNDarray, axis=None) -> DNDarray:
    """Reverse the order along ``axis`` (all axes when None; reference
    manipulations.py:335): each chunk reverses, and along the split axis
    rank ``q``'s chunk ``[lo, hi)`` lands at ``[n-hi, n-lo)``."""
    if axis is None:
        axes = tuple(range(a.ndim))
    else:
        ax = sanitize_axis(a.shape, axis)
        axes = (ax,) if isinstance(ax, builtins.int) else tuple(ax)
    res = _flip(a.larray, axes) if axes else a.larray.clone()
    s, comm = a.split, a.comm
    if s is not None and s in axes and comm.size > 1:
        n = a.shape[s]
        ranges = []
        for q in range(comm.size):
            lo, hi = _chunk_range(n, comm, q)
            ranges.append([(n - hi, hi - lo)])
        res = _permute_split_axis([res], ranges, n, s, comm, res)
    return _new(res.contiguous(), a.shape, a.dtype, s, a)


def fliplr(a: DNDarray) -> DNDarray:
    if a.ndim < 2:
        raise IndexError("expected at least a 2-D array")
    return flip(a, 1)


def flipud(a: DNDarray) -> DNDarray:
    return flip(a, 0)


def roll(x: DNDarray, shift, axis=None) -> DNDarray:
    """Circular shift (reference manipulations.py:583): off the split axis
    each chunk rolls; along it rank ``q``'s chunk lands as at most two
    ranges of the result. ``axis=None`` rolls the flattened array."""
    if axis is None:
        if x.ndim == 1:
            return roll(x, shift, 0)
        return reshape(roll(flatten(x), shift, 0), x.shape, new_split=x.split)
    ax = sanitize_axis(x.shape, axis)
    axes = (ax,) if isinstance(ax, builtins.int) else tuple(ax)
    shifts = tuple(shift) if isinstance(shift, (tuple, list)) else (shift,) * len(axes)
    if len(shifts) != len(axes):
        raise ValueError(f"shift and axis must match in length, got {len(shifts)} and "
                         f"{len(axes)}")
    shifts = tuple(builtins.int(sh) for sh in shifts)
    s, comm = x.split, x.comm
    if s is None or s not in axes or comm.size == 1:
        res = torch.roll(_bits(x.larray), shifts, axes) if axes else x.larray.clone()
        return _new(_unbits(res, x.larray.dtype), x.shape, x.dtype, s, x)
    rest = [(sh, a) for sh, a in zip(shifts, axes) if a != s]
    res = x.larray
    if rest:
        res = _unbits(torch.roll(_bits(res), tuple(r[0] for r in rest),
                                 tuple(r[1] for r in rest)), res.dtype)
    n = x.shape[s]
    k = builtins.sum(sh for sh, a in zip(shifts, axes) if a == s) % builtins.max(n, 1)
    ranges, pieces = [], None
    for q in range(comm.size):
        lo, hi = _chunk_range(n, comm, q)
        first = builtins.min(hi, builtins.max(lo, n - k))  # rows [lo, first) move by +k
        parts = [(lo + k, first - lo), ((first + k) % builtins.max(n, 1), hi - first)]
        ranges.append(parts)
        if q == comm.rank:
            pieces = [res.narrow(s, 0, first - lo), res.narrow(s, first - lo, hi - first)]
    res = _permute_split_axis(pieces, ranges, n, s, comm, res)
    return _new(res.contiguous(), x.shape, x.dtype, s, x)


def rot90(m: DNDarray, k: int = 1, axes=(0, 1)) -> DNDarray:
    """Rotate by 90 degrees in the plane of ``axes`` (``flip`` and
    ``swapaxes``, numpy's construction)."""
    a0, a1 = (sanitize_axis(m.shape, a) for a in axes)
    if a0 == a1:
        raise ValueError("rot90 axes must be different")
    k = k % 4
    if k == 0:
        return _new(m.larray.clone(), m.shape, m.dtype, m.split, m)
    if k == 2:
        return flip(flip(m, a0), a1)
    if k == 1:
        return swapaxes(flip(m, a1), a0, a1)
    return flip(swapaxes(m, a0, a1), a1)


# --------------------------------------------------- gathered constructions


def _pad_index(n: int, before: int, after: int, mode: str, device) -> torch.Tensor:
    i = torch.arange(-before, n + after, device=device)
    if mode == "edge":
        return i.clamp(0, n - 1)
    if mode == "wrap":
        return i % n
    if mode == "reflect":
        if n == 1:
            return torch.zeros_like(i)
        j = i % (2 * n - 2)
        return torch.where(j < n, j, 2 * n - 2 - j)
    j = i % (2 * n)  # symmetric
    return torch.where(j < n, j, 2 * n - 1 - j)


def pad(array: DNDarray, pad_width, mode: str = "constant", constant_values=0) -> DNDarray:
    """Pad the array (reference manipulations.py:401, on the gathered array):
    ``constant``, ``edge``, ``reflect``, ``symmetric`` and ``wrap``, each
    dimension padded by an index map on the device."""
    whole = array._global()
    widths = np.broadcast_to(np.asarray(pad_width, dtype=np.int64), (array.ndim, 2))
    if (widths < 0).any():
        raise ValueError("index can't contain negative values")
    if mode == "constant":
        shape = tuple(builtins.int(n + b + e) for n, (b, e) in zip(array.shape, widths))
        res = torch.full(shape, 0, dtype=whole.dtype, device=whole.device)
        cv = np.broadcast_to(np.asarray(constant_values), (array.ndim, 2))
        for d, (b, e) in enumerate(widths):  # numpy fills axis by axis
            idx = [slice(None)] * array.ndim
            if b:
                idx[d] = slice(0, builtins.int(b))
                res[tuple(idx)] = torch.as_tensor(cv[d][0]).to(whole.dtype)
            if e:
                idx[d] = slice(res.shape[d] - builtins.int(e), None)
                res[tuple(idx)] = torch.as_tensor(cv[d][1]).to(whole.dtype)
        inner = tuple(slice(builtins.int(b), builtins.int(b) + n)
                      for n, (b, _) in zip(array.shape, widths))
        res[inner] = whole
    elif mode in ("edge", "wrap", "reflect", "symmetric"):
        res = whole
        for d, (b, e) in enumerate(widths):
            if b or e:
                if array.shape[d] == 0:
                    raise ValueError(f"can't extend empty axis {d} using modes other than "
                                     f"'constant' or 'empty'")
                res = _index_select(res, d, _pad_index(array.shape[d], builtins.int(b),
                                                       builtins.int(e), mode, res.device))
    else:
        raise NotImplementedError(f"pad mode {mode!r}: the port pads with 'constant', 'edge', "
                                  f"'reflect', 'symmetric' and 'wrap'")
    return _wrap(res, array.split, array)


def repeat(a: DNDarray, repeats, axis: Optional[int] = None) -> DNDarray:
    """Repeat elements (reference manipulations.py:426): a scalar count off
    the split axis repeats within each chunk; otherwise the gathered array."""
    a = _as_dnd(a)
    dev = a.larray.device
    if isinstance(repeats, DNDarray):
        repeats = repeats._global()
    if isinstance(repeats, (list, tuple, np.ndarray)):
        repeats = torch.as_tensor(np.asarray(repeats), device=dev)
    if isinstance(repeats, torch.Tensor) and repeats.ndim == 0:
        repeats = builtins.int(repeats)
    if axis is not None and a.split is not None and not isinstance(repeats, torch.Tensor):
        ax = sanitize_axis(a.shape, axis)
        if ax != a.split:
            res = torch.repeat_interleave(a.larray, builtins.int(repeats), dim=ax)
            gshape = tuple(s * builtins.int(repeats) if d == ax else s
                           for d, s in enumerate(a.shape))
            return _new(res, gshape, a.dtype, a.split, a)
    if isinstance(repeats, torch.Tensor):
        repeats = repeats.to(device=dev, dtype=torch.int64)
    whole = a._global()
    ax = None if axis is None else sanitize_axis(a.shape, axis)
    res = torch.repeat_interleave(whole, repeats, dim=ax)
    out_split = (0 if a.split is not None else None) if axis is None else a.split
    return _wrap(res, out_split, a)


def tile(x: DNDarray, reps) -> DNDarray:
    """Tile the array (reference manipulations.py:918): when the split axis
    is not repeated each chunk tiles; otherwise the gathered array."""
    if isinstance(reps, DNDarray):
        reps = reps.tolist()
    try:
        reps_t = tuple(operator.index(r) for r in reps)
    except TypeError:
        reps_t = (operator.index(reps),)
    if x.split is not None:
        ndim_out = builtins.max(x.ndim, len(reps_t))
        new_split = x.split + (ndim_out - x.ndim)
        reps_full = (1,) * (ndim_out - len(reps_t)) + reps_t
        if reps_full[new_split] == 1:
            res = x.larray.tile(reps_t)
            base = (1,) * (ndim_out - x.ndim) + tuple(x.shape)
            return _new(res, tuple(r * s for r, s in zip(reps_full, base)), x.dtype, new_split, x)
    res = x._global().tile(reps_t)
    out_split = x.split + (res.ndim - x.ndim) if x.split is not None else None
    return _wrap(res, out_split, x)


def diag(a: DNDarray, offset: int = 0) -> DNDarray:
    """The diagonal of a 2-D array, or the 2-D array with a 1-D array on
    its diagonal (split as the input)."""
    if a.ndim == 1:
        return _wrap(torch.diag(a._global(), offset), a.split, a)
    return diagonal(a, offset=offset)


def diagonal(a: DNDarray, offset: int = 0, dim1: int = 0, dim2: int = 1) -> DNDarray:
    """The diagonal (reference manipulations.py:243): of a split 2-D array
    as the paired gather ``a[rows, cols]`` (split 0); otherwise from the
    gathered array, the split following the JAX package."""
    dim1, dim2 = sanitize_axis(a.shape, dim1), sanitize_axis(a.shape, dim2)
    if dim1 == dim2:
        raise ValueError("dim1 and dim2 need to be different")
    if a.ndim == 2 and a.split is not None:
        if (dim1, dim2) == (1, 0):
            return diagonal(swapaxes(a, 0, 1), offset=offset)
        n0, n1 = a.shape
        klen = builtins.min(n0, n1 - offset) if offset >= 0 else builtins.min(n0 + offset, n1)
        r0, c0 = (0, offset) if offset >= 0 else (-offset, 0)
        k = torch.arange(builtins.max(klen, 0), device=a.larray.device)
        return getitem(a, (k + r0, k + c0))
    res = torch.diagonal(a._global(), offset, dim1, dim2)
    out_split = None
    if a.split is not None and a.split not in (dim1, dim2):
        out_split = a.split - builtins.sum(1 for d in (dim1, dim2) if d < a.split)
    elif a.split is not None:
        out_split = res.ndim - 1
    return _wrap(res.contiguous(), out_split, a)


# ----------------------------------------------------------------- sorting


def _carry(t: torch.Tensor) -> torch.Tensor:
    """``t`` in a type every collective and gather takes: bool as uint8, the
    wide unsigned types as the bits of the signed type of their width."""
    if t.dtype == torch.bool:
        return t.to(torch.uint8)
    return _bits(t)


def _uncarry(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if dtype == torch.bool:
        return t.to(torch.bool)
    return _unbits(t, dtype)


def _keys(t: torch.Tensor, dtype: torch.dtype) -> List[torch.Tensor]:
    """The sort keys of carried values, primary first: torch sorts the
    unsigned types (from their bits) and complex values by (real, imag)."""
    if dtype in _BITS_AS:
        return [order_key(t.view(dtype))]
    if t.is_complex():
        return [t.real, t.imag]
    return [t]


def _gather(t: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """``t`` permuted along its last dimension by ``perm`` (broadcast over
    leading dimensions of size 1)."""
    if perm.shape[0] != t.shape[0]:
        perm = perm.expand(t.shape[0], -1)
    return _unbits(_bits(t).gather(-1, perm), t.dtype)


def _lexsort(keys: Sequence[Tuple[torch.Tensor, bool]]) -> torch.Tensor:
    """The permutation (along the last dimension) that orders by ``keys``
    ``(key, descending)``, the first primary: stable sorts from the last key
    to the first."""
    perm = None
    for key, descending in reversed(list(keys)):
        k = key if perm is None else _gather(key, perm)
        order = torch.sort(k, dim=-1, stable=True, descending=descending)[1]
        perm = order if perm is None else _gather(perm, order)
    return perm


def _oddeven_partners(p: int, r: int):
    """The ``(source, destination)`` pairs of round ``r`` of the odd-even
    transposition network."""
    perm = []
    for lo in range(r % 2, p - 1, 2):
        perm += [(lo, lo + 1), (lo + 1, lo)]
    return perm


def _merge_pair(blocks, got, order, c: int, low: bool) -> List[torch.Tensor]:
    """One merge-split: this rank's and its partner's sorted blocks, ordered
    together; the lower rank keeps the ``c`` smallest, the higher the rest."""
    merged = [torch.cat([t, o], dim=-1) for t, o in zip(blocks, got)]
    perm = order(merged)
    return [_gather(t, perm)[..., :c] if low else _gather(t, perm)[..., c:] for t in merged]


def _merge_split(blocks: List[torch.Tensor], order, comm, c: int) -> List[torch.Tensor]:
    """``p`` rounds of the odd-even merge-split network on this rank's
    sorted ``blocks`` (each ``(rows, c)``, ordered along the last dimension
    by the permutation ``order(blocks)``): in each round the ranks of a pair
    swap blocks (``ppermute``) and merge-split them."""
    p, me = comm.size, comm.rank
    comm.allreduce(torch.zeros(1, device=blocks[0].device))  # every rank in the group first
    for r in range(p):
        pairs = _oddeven_partners(p, r)
        got = [comm.ppermute(t.contiguous(), pairs) for t in blocks]
        partner = [d for s, d in pairs if s == me]
        if partner:
            blocks = _merge_pair(blocks, got, order, c, partner[0] > me)
    return blocks


def _lane_blocks(v: torch.Tensor, off: int, c: int) -> List[torch.Tensor]:
    """A rank's ``(L, l)`` lanes as network blocks of length ``c``: the
    sentinel flag (1 on the ``c - l`` padding entries), the values (zeros
    there) and the global indices."""
    L, l = v.shape
    pad = torch.zeros((L, c), dtype=torch.int8, device=v.device)
    pad[:, l:] = 1
    vals = torch.cat([v, v.new_zeros((L, c - l))], dim=-1)
    idx = (off + torch.arange(c, device=v.device)).expand(L, c).contiguous()
    return [pad, vals, idx]


def _lane_order(descending: bool, dtype: torch.dtype):
    """The network's order of lane blocks: sentinels last, then by value
    (``descending`` or not), ties by global index."""
    def order(b):
        return _lexsort([(b[0], False)] + [(k, descending) for k in _keys(b[1], dtype)] +
                        [(b[2], False)])

    return order


def _sort_lanes(v: torch.Tensor, n: int, comm, descending: bool, dtype: torch.dtype):
    """Sort ``(L, l)`` lanes whose last dimension is this rank's chunk of
    ``n`` entries split across ranks: returns this rank's chunk of the
    sorted values and their global indices."""
    c = comm.chunk_size(n)
    off, _ = _chunk_range(n, comm, comm.rank)
    order = _lane_order(descending, dtype)
    blocks = _lane_blocks(v, off, c)
    perm = order(blocks)
    blocks = _merge_split([_gather(t, perm) for t in blocks], order, comm, c)
    cnt = comm.counts_displs(n)[0][comm.rank]
    return blocks[1][:, :cnt], blocks[2][:, :cnt]


def _sort_local(t: torch.Tensor, dim: int, descending: bool):
    """One stable sort of a whole dimension: ``(values, indices)``."""
    dtype = t.dtype
    c = _carry(t)
    keys = _keys(c, dtype)
    if len(keys) == 1:
        vals, perm = torch.sort(keys[0], dim=dim, stable=True, descending=descending)
        if dtype == torch.bool:
            vals = vals.to(torch.bool)
        return from_order_key(vals, dtype), perm
    moved = c.movedim(dim, -1)
    flat = moved.reshape(builtins.int(np.prod(moved.shape[:-1], dtype=np.int64)), moved.shape[-1])
    perm = _lexsort([(k.movedim(dim, -1).reshape(flat.shape), descending) for k in keys])
    vals = _gather(flat, perm).reshape(moved.shape).movedim(-1, dim)
    return _uncarry(vals, dtype), perm.reshape(moved.shape).movedim(-1, dim)


def _sort_split_axis(a: DNDarray, axis: int, descending: bool):
    """``(values, indices)`` chunks of the distributed sort along the split
    axis (the merge-split network over each lane)."""
    dtype = a.larray.dtype
    moved = _carry(a.larray).movedim(axis, -1)
    lanes = moved.shape[:-1]
    flat = moved.reshape(builtins.int(np.prod(lanes, dtype=np.int64)), moved.shape[-1])
    vals, idx = _sort_lanes(flat, a.shape[axis], a.comm, descending, dtype)
    vals = vals.reshape(lanes + (vals.shape[-1],)).movedim(-1, axis)
    idx = idx.reshape(lanes + (idx.shape[-1],)).movedim(-1, axis)
    return _uncarry(vals, dtype).contiguous(), idx.contiguous()


def sort(a: DNDarray, axis: int = -1, descending: bool = False, out=None):
    """``(values, indices)`` of the sort along ``axis`` (reference
    manipulations.py:669): stable, ties by global index, NaN last ascending
    and first descending, descending ties in ascending index order; the
    indices int64 and global; both split as ``a``."""
    axis = sanitize_axis(a.shape, axis)
    if a.split == axis and a.comm.size > 1:
        key = (axis, a.comm.chunk_size(a.shape[axis]), a.ndim)
        vals, idx = program_cache.cached_program(
            "oddeven_sort", key, lambda: _sort_split_axis, comm=a.comm, inline=True)(
            a, axis, descending)
    else:
        vals, idx = _sort_local(a.larray, axis, descending)
    values = _new(vals, a.shape, a.dtype, a.split, a)
    indices = _new(idx, a.shape, types.int64, a.split, a)
    if out is not None:
        out.larray = values.larray
    return values, indices


def topk(a: DNDarray, k: int, dim: int = -1, largest: bool = True, sorted: bool = True,
         out=None):
    """The ``k`` largest (or smallest) entries along ``dim`` and their
    indices (reference manipulations.py:1001), sorted, ties to the lowest
    index. Along the split axis each rank offers its ``k`` candidates with
    their global indices, one gather brings them to every rank and a second
    selection picks the result, which is replicated; off it each chunk
    selects and the split is kept."""
    dim = sanitize_axis(a.shape, dim)
    n = a.shape[dim]
    if k > n or k < 0:
        raise ValueError(f"k ({k}) out of range for dimension {dim} of size {n}")
    dtype = a.larray.dtype
    comm = a.comm
    vals, idx = _sort_local(a.larray, dim, largest)
    vals, idx = vals.narrow(dim, 0, builtins.min(k, vals.shape[dim])), \
        idx.narrow(dim, 0, builtins.min(k, idx.shape[dim]))
    gshape = tuple(k if d == dim else s for d, s in enumerate(a.shape))
    split = None if a.split == dim else a.split
    if a.split == dim and comm.size > 1:
        off, _ = _chunk_range(n, comm, comm.rank)
        counts = [builtins.min(k, cnt) for cnt in comm.counts_displs(n)[0]]
        cv = _carry(vals).movedim(dim, -1)
        ci = (idx + off).movedim(dim, -1)
        lanes = cv.shape[:-1]
        cv, ci = (torch.cat([t, t.new_zeros(lanes + (k - t.shape[-1],))], -1) for t in (cv, ci))
        allv = comm.allgather(cv.contiguous(), cv.ndim - 1, k * comm.size)
        alli = comm.allgather(ci.contiguous(), ci.ndim - 1, k * comm.size)
        keep = torch.cat([torch.arange(q * k, q * k + counts[q], device=cv.device)
                          for q in range(comm.size)])
        allv, alli = allv.index_select(-1, keep), alli.index_select(-1, keep)
        fv = allv.reshape(-1, allv.shape[-1])
        perm = _lexsort([(key, largest) for key in _keys(fv, dtype)])[:, :k]
        vals = _uncarry(_gather(fv, perm).reshape(lanes + (k,)), dtype).movedim(-1, dim)
        idx = _gather(alli.reshape(-1, alli.shape[-1]), perm).reshape(lanes + (k,)).movedim(-1, dim)
    values = _new(vals.contiguous(), gshape, a.dtype, split, a)
    indices = _new(idx.contiguous(), gshape, types.int64, split, a)
    if out is not None:
        out[0].larray = values.larray
        out[1].larray = indices.larray
    return values, indices


# ------------------------------------------------------------------ unique


def _left_neighbour_last(v: torch.Tensor, comm) -> torch.Tensor:
    """The previous rank's last entry (along dimension 0), one permute."""
    last = v[-1:] if v.shape[0] else v.new_zeros((1,) + tuple(v.shape[1:]))
    got = comm.ppermute(_carry(last).contiguous(), [(i, i + 1) for i in range(comm.size - 1)])
    return _uncarry(got, v.dtype)


def _firsts(v: torch.Tensor, comm, distributed: bool, equal_nan: bool) -> torch.Tensor:
    """Whether each sorted entry (or row) starts a run of equal ones; the
    first entry of a rank compares with the previous rank's last."""
    left_last = _left_neighbour_last(v, comm) if distributed else None
    if v.shape[0] == 0:
        return torch.zeros(0, dtype=torch.bool, device=v.device)
    if left_last is not None and comm.rank > 0:
        left, cur, head = torch.cat([left_last, v[:-1]]), v, []
    else:
        left, cur, head = v[:-1], v[1:], [torch.ones(1, dtype=torch.bool, device=v.device)]
    neq = cur != left
    if equal_nan and v.is_floating_point():
        neq = neq & ~(torch.isnan(cur) & torch.isnan(left))
    if neq.ndim > 1:
        neq = neq.reshape(neq.shape[0], -1).any(1)
    return torch.cat(head + [neq])


def _runs(v, idx, n, comm, distributed, equal_nan, return_inverse):
    """Compaction of the sorted entries (rows) ``v`` with their original
    indices ``idx``: the unique entries (split=0 when ``distributed``) and
    the inverse."""
    isf = _firsts(v, comm, distributed, equal_nan)
    cum = torch.cumsum(isf.to(torch.int64), 0)
    cnt = builtins.int(cum[-1]) if cum.numel() else 0
    if distributed:
        counts = comm.allgather_object(cnt)
        before = builtins.sum(counts[:comm.rank])
        u = builtins.sum(counts)
        starts = np.concatenate([[0], np.cumsum(counts)])
        ranges = [[(builtins.int(starts[q]), counts[q])] for q in range(comm.size)]
        uniq = _uncarry(_assemble([_carry(v[isf])], ranges, u, comm, _carry(v)), v.dtype)
    else:
        before, u, uniq = 0, cnt, _uncarry(_carry(v)[isf], v.dtype)
    if not return_inverse:
        return uniq, u, None
    gid = before + cum - 1
    if distributed:
        inv = _exchange_rows(gid, idx, n, comm)
    else:
        inv = torch.empty(n, dtype=torch.int64, device=v.device)
        inv[idx] = gid
    return uniq, u, inv


def _unique_flat(a: DNDarray, return_inverse: bool):
    """Unique of the flattened array, NaNs as one (numpy's ``equal_nan``):
    sorted by the network when split, numbered, compacted."""
    distributed = a.split is not None and a.comm.size > 1
    flat = a if a.ndim == 1 else reshape(a, (a.size,))
    if distributed:
        flat = flat if flat.split == 0 else flat.resplit(0)
        v, idx = _sort_split_axis(flat, 0, False)
    else:
        v, idx = _sort_local(flat.larray.reshape(-1), 0, False)
    uniq, u, inv = _runs(v, idx, a.size, a.comm, distributed, True, return_inverse)
    split = 0 if a.split is not None else None
    res = _new(uniq.contiguous(), (u,), a.dtype, split, a)
    if not return_inverse:
        return res
    inv = _new(inv, (a.size,), types.int64, split, a)
    return res, (reshape(inv, a.shape) if a.ndim > 1 else inv)


def _row_keys(t: torch.Tensor, dtype) -> List[torch.Tensor]:
    """The key columns of carried rows ``(R, n)`` (transposed): one per
    column, two for a complex column."""
    out = []
    for j in range(t.shape[0]):
        out.extend(_keys(t[j:j + 1], dtype))
    return out


def _unique_rows(b2: DNDarray, return_inverse: bool):
    """Unique rows of an ``(n, R)`` array split 0 or replicated: sorted
    lexicographically (the network, with the rows as key columns), rows with
    a NaN kept distinct as numpy's ``unique(axis=k)`` keeps them."""
    dtype = b2.larray.dtype
    comm = b2.comm
    n = b2.shape[0]
    distributed = b2.split is not None and comm.size > 1
    rows = _carry(b2.larray).t().contiguous()  # (R, l)
    l = rows.shape[1]
    dev = rows.device
    if distributed:
        c = comm.chunk_size(n)
        off, _ = _chunk_range(n, comm, comm.rank)
    else:
        c, off = l, 0
    pad = torch.zeros((1, c), dtype=torch.int8, device=dev)
    pad[:, l:] = 1
    rows = torch.cat([rows, rows.new_zeros((rows.shape[0], c - l))], dim=-1)
    idx = (off + torch.arange(c, device=dev))[None]

    def order(b):
        return _lexsort([(b[0], False)] + [(k, False) for k in _row_keys(b[1], dtype)] +
                        [(b[2], False)])

    blocks = [pad, rows, idx]
    perm = order(blocks)
    blocks = [_gather(t, perm) for t in blocks]
    if distributed:
        blocks = _merge_split(blocks, order, comm, c)
    cnt = comm.counts_displs(n)[0][comm.rank] if distributed else l
    v = _uncarry(blocks[1][:, :cnt].t().contiguous(), dtype)
    uniq, u, inv = _runs(v, blocks[2][0, :cnt], n, comm, distributed, False, return_inverse)
    res = _new(uniq.contiguous(), (u,) + b2.shape[1:], b2.dtype, b2.split, b2)
    if inv is not None:
        inv = _new(inv, (n,), types.int64, b2.split, b2)
    return res, inv


def _unique_axis(a: DNDarray, ax: int, return_inverse: bool):
    """``unique(a, axis=ax)``: the sub-arrays along ``ax`` as rows."""
    b = a if a.split == ax or a.split is None else a.resplit(ax)
    if ax != 0:
        b = moveaxis(b, ax, 0)
    n, rest = b.shape[0], b.shape[1:]
    width = builtins.int(np.prod(rest, dtype=np.int64))
    b2 = b if b.ndim == 2 else reshape(b, (n, width))
    res, inv = _unique_rows(b2, return_inverse)
    u = res.shape[0]
    res = res if len(rest) == 1 else reshape(res, (u,) + rest)
    if ax != 0:
        res = moveaxis(res, 0, ax)
    return res, inv


def unique(a: DNDarray, sorted: bool = False, return_inverse: bool = False,
           axis: Optional[int] = None):
    """The sorted unique entries (reference manipulations.py:1050), split=0
    when ``a`` is split. ``axis=None`` flattens, with NaNs as one; the
    inverse has ``a``'s shape. ``axis=k`` keeps the unique sub-arrays along
    ``k`` (NaN-bearing ones distinct), split along ``k`` when ``a`` is split
    (a 1-D array: split 0); its inverse is 1-D."""
    if axis is None:
        if a.ndim == 0:
            res = _new(a.larray.reshape(1).clone(), (1,), a.dtype, None, a)
            inv = _new(torch.zeros((), dtype=torch.int64, device=a.larray.device), (),
                       types.int64, None, a)
            return (res, inv) if return_inverse else res
        return _unique_flat(a, return_inverse)
    ax = sanitize_axis(a.shape, axis)
    if a.ndim == 1:
        res, inv = _unique_axis(reshape(a, (a.shape[0], 1)), 0, return_inverse)
        res = reshape(res, (res.shape[0],))
    else:
        res, inv = _unique_axis(a, ax, return_inverse)
    return (res, inv) if return_inverse else res


DNDarray.expand_dims = lambda self, axis: expand_dims(self, axis)
DNDarray.flatten = lambda self: flatten(self)
DNDarray.ravel = lambda self: ravel(self)
DNDarray.reshape = lambda self, *shape, new_split=None: reshape(self, *shape, new_split=new_split)
DNDarray.squeeze = lambda self, axis=None: squeeze(self, axis)
DNDarray.unique = lambda self, sorted=False, return_inverse=False, axis=None: unique(
    self, sorted, return_inverse, axis)
