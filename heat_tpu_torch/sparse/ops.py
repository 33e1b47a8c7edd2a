"""Sparse products, conversions and constructors (counterpart of
``heat_tpu/sparse/ops.py``).

``spmv``/``spmm``: each rank contracts its live rows with the dense
operand, a row-split operand first gathered whole; ``out_split=None`` adds
one allreduce of the ``m``-vector (sum, or min/max for those reductions),
each rank contributing its rows and the reduction's identity elsewhere, as
the JAX package's tail does. The sum over float32/float64 values is
``torch``'s CSR product (cuSPARSE on the card); every other case, the
integer and bool types, ``min``/``max`` and ``pattern=True``, gathers the
operand at the column ids and reduces by row (``index_add_``,
``scatter_reduce_``), since torch's CSR product covers floating types only.
Wide unsigned values reduce on their signed bits (sums) or order keys
(``min``/``max``).

``transpose`` sends every element to the rank that owns its destination
row through ``alltoallv`` (in ``ceil(cap / slab)`` stages of the capacity
axis) and orders each row by packed ``column·R + row`` keys, as the JAX
package does. Without a ``slab`` the stages are planned from
``HEAT_TPU_HBM_BUDGET`` (``relayout_planner.sparse_slab``: one stage
without a budget, else as many slots a stage as the temporary budget
holds).

``csr_from_dense`` compacts each rank's rows on its device (``torch.nonzero``
of the thresholded chunk) and gathers only the element counts;
``csr_from_coo`` orders DNDarray triplets with the distributed
``manipulations.sort`` of packed ``row·n + col`` keys and sends each element
to its row's rank, host triplets with a ``lexsort``.

The float sums' wire is ``HEAT_TPU_SPARSE_SPMV_PREC`` (or ``precision=``):
``off`` exact (the default), or ``bf16``: the gathered operand moves as its
bf16 bits and the replicated result's all-reduce sums a bf16 payload (the
JAX package's ``sparse/ops.py:82``). Extremes, patterns and indices move
exact.

Telemetry, as in the JAX package: every operation adds one to its
``sparse.<op>`` counter and emits one ``sparse`` event while telemetry
records (``EVENT_COUNTER`` in ``__init__`` keeps the names); ``spmv``/
``spmm`` and ``transpose`` are spans with the analytic wire bytes
(``telemetry.collectives.spmv_cost``/``spmm_cost``/
``sparse_transpose_cost``), and ``audit=True`` (or ``HEAT_TPU_HLO_AUDIT=1``)
records their collectives against those costs (``telemetry.hlo``). The
products' audit holds exactly when the row count divides by the world
size. The transpose's cannot: the JAX package exchanges worst-case slabs of
``slab`` slots a rank, which its cost counts, while the port's
``alltoallv`` moves only the stored elements (and the counts, and gathers
the new row counts), so its audit reports that difference as drift.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from .. import _knobs as knobs
from .. import telemetry
from ..core import program_cache, types
from ..core._operations import _SIGNED, _sign_bit
from ..core.communication import TorchCommunication, sanitize_comm
from ..core.devices import sanitize_device
from ..core.dndarray import DNDarray
from .container import SparseDNDarray

__all__ = [
    "spmv",
    "spmm",
    "to_dense",
    "transpose",
    "csr_from_dense",
    "csr_from_coo",
    "spmv_wire",
    "make_solver_matvec",
]

_REDUCES = ("sum", "min", "max")
# the value types whose sum product is torch's CSR product
_CSR_TYPES = (torch.float32, torch.float64)


def _record(op: str, **fields) -> None:
    """One ``sparse.<op>`` counter and one ``sparse`` event a sparse
    operation, while telemetry records (the live and the offline summaries
    agree)."""
    if telemetry.enabled():
        reg = telemetry.get_registry()
        reg.add(f"sparse.{op}", 1)
        reg.emit("sparse", op, event=op, **fields)


def spmv_wire(dtype, precision: Optional[str] = None) -> str:
    """The wire mode of the sparse float tails: ``precision``, else
    ``HEAT_TPU_SPARSE_SPMV_PREC`` (default ``off``); a non-float payload
    always moves exact (``off``)."""
    if precision is None:
        precision = knobs.raw("HEAT_TPU_SPARSE_SPMV_PREC") or "off"
    p = str(precision).strip().lower()
    if p not in ("off", "bf16"):
        raise ValueError(f"sparse wire precision must be 'off' or 'bf16', got {precision!r}")
    if p != "off" and not types.issubdtype(types.canonical_heat_type(dtype), types.floating):
        return "off"
    return p


# -- the local contraction -----------------------------------------------------


def _bits(t: torch.Tensor) -> torch.Tensor:
    """Values that torch adds, multiplies and gathers on every device: wide
    unsigned as their signed bits, bool as uint8."""
    if t.dtype in _SIGNED:
        return t.view(_SIGNED[t.dtype])
    return t.to(torch.uint8) if t.dtype == torch.bool else t


def _unbits(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if dtype in _SIGNED:
        return t.view(dtype)
    return t.bool() if dtype == torch.bool else t


def _identity(space: torch.dtype, reduce: str, tail: bool):
    """The reduction's identity in the computing type: 0 for a sum; for
    min/max the type's extreme, and for floats +-inf within a segment and
    +-finfo.max in the replicated tail (the JAX package's
    ``_reduce_identity``: so an empty row of a replicated min over several
    ranks is finfo.max, over one rank inf, as there)."""
    if reduce == "sum":
        return 0
    if space.is_floating_point:
        if not tail:
            return math.inf if reduce == "min" else -math.inf
        info = torch.finfo(space)
    else:
        info = torch.iinfo(space)
    return info.max if reduce == "min" else info.min


def _contract(A: SparseDNDarray, xg: torch.Tensor, dt: torch.dtype, reduce: str,
              pattern: bool) -> torch.Tensor:
    """This rank's live rows of ``A @ xg`` (``xg`` whole, in ``dt``), in the
    computing type of :func:`_bits` (min/max of wide unsigned: order keys)."""
    if reduce == "sum" and not pattern and dt in _CSR_TYPES:
        csr = A._csr(dt)
        return xg.new_zeros((0,) + tuple(xg.shape[1:])) if csr is None else csr @ xg
    c = A.lnnz
    rows = A._slot_rows()
    taken = _bits(xg)[A.indices[:c].to(torch.int64)]
    if pattern:
        contrib = taken
    else:
        vals = _bits(A.values[:c].to(dt))
        contrib = (vals[:, None] if taken.ndim == 2 else vals) * taken
    if dt in _SIGNED and reduce != "sum":
        contrib = contrib ^ _sign_bit(dt)  # the order key of the unsigned value
    out = torch.full((A.lrows,) + tuple(contrib.shape[1:]), _identity(contrib.dtype, reduce, False),
                     dtype=contrib.dtype, device=contrib.device)
    if reduce == "sum":
        return out.index_add_(0, rows, contrib)
    index = rows.view((-1,) + (1,) * (contrib.ndim - 1)).expand_as(contrib)
    return out.scatter_reduce_(0, index, contrib, "amin" if reduce == "min" else "amax")


def _finish(A: SparseDNDarray, y: torch.Tensor, dt: torch.dtype, reduce: str,
            replicated: bool, wire: str = "off") -> torch.Tensor:
    """The contraction's result in ``dt``: this rank's rows, or with
    ``replicated`` all ``m`` rows through one allreduce (a sum at
    ``wire``: ``bf16`` sums a bf16 payload)."""
    comm = A.comm
    if replicated and comm.size > 1:
        m = A.shape[0]
        full = torch.full((m,) + tuple(y.shape[1:]), _identity(y.dtype, reduce, True),
                          dtype=y.dtype, device=y.device)
        offset = comm.rank * A.row_chunk
        full[offset:offset + y.shape[0]] = y
        y = comm.allreduce(full, reduce, precision=wire if reduce == "sum" else None)
    if dt in _SIGNED and reduce != "sum":
        y = y ^ _sign_bit(dt)
    return _unbits(y, dt)


def _dispatch_sparse_dense(op: str, A: SparseDNDarray, x: DNDarray, out_split: Optional[int],
                           precision: Optional[str], reduce: str, pattern: bool,
                           audit: bool) -> DNDarray:
    """Shared spmv/spmm dispatch: validate, resolve the type and the wire,
    contract, combine."""
    if not isinstance(A, SparseDNDarray):
        raise TypeError(f"expected a SparseDNDarray, got {type(A)}")
    if not isinstance(x, DNDarray):
        raise TypeError(f"dense operand must be a DNDarray, got {type(x)}")
    want_ndim = 1 if op == "spmv" else 2
    if x.ndim != want_ndim:
        raise ValueError(f"{op} expects a {want_ndim}-D dense operand")
    if x.shape[0] != A.shape[1]:
        raise ValueError(f"{op}: operand leading dim {x.shape[0]} != sparse cols {A.shape[1]}")
    if x.split not in (None, 0):
        raise NotImplementedError(f"{op} requires x.split in (None, 0)")
    if out_split not in (None, 0):
        raise NotImplementedError(f"{op} supports out_split in (None, 0)")
    if reduce not in _REDUCES:
        raise ValueError(f"reduce must be one of {_REDUCES}, got {reduce!r}")
    if not _same_comm(x.comm, A.comm):
        raise ValueError(f"{op}: operands live on different communicators")
    dt = x.dtype if pattern else types.promote_types(A.dtype, x.dtype)
    # extremes and structure-only relays always move exact
    wire = spmv_wire(dt, precision) if reduce == "sum" and not pattern else "off"
    tdt = dt.torch_type()
    comm = A.comm
    m, n = A.shape
    k = 1 if op == "spmv" else x.shape[1]
    cost_fn, cost_args = ((telemetry.collectives.spmv_cost, (m, n)) if op == "spmv"
                          else (telemetry.collectives.spmm_cost, (m, n, k)))
    cost, fields, do_audit = telemetry.op_cost(cost_fn, *cost_args, dt.byte_size(), comm.size,
                                               x.split, out_split, wire, audit=audit)

    prog = program_cache.cached_program(
        f"sparse.{op}", (x.split, out_split, wire, reduce, pattern, str(tdt)),
        lambda: _sparse_dense_program, comm=comm, inline=True)
    gather_n = x.shape[0] if x.split == 0 and comm.size > 1 else None

    def run():
        return prog(A, x.larray, tdt, reduce, pattern, out_split is None, wire, gather_n)

    with telemetry.span(f"sparse.{op}", gshape=[m, n], nnz=A.nnz, mesh=comm.size,
                        **fields) as sp:
        if do_audit:
            y, _ = telemetry.hlo.audit_call(f"sparse.{op}", run, predicted=cost,
                                            fields={"mesh": comm.size, "nnz": A.nnz})
        else:
            y = run()
        sp.output(y)
    _record(op, nnz=A.nnz, rows=m, cols=n, out_split=out_split, wire=wire,
            **({"bytes": cost.bytes} if cost is not None else {}))
    gshape = (m,) if op == "spmv" else (m, k)
    return DNDarray(y, gshape, dt, out_split, A.device, comm, True)


def _sparse_dense_program(A: SparseDNDarray, xl: torch.Tensor, tdt: torch.dtype, reduce: str,
                          pattern: bool, replicate: bool, wire: str,
                          gather_n: Optional[int]) -> torch.Tensor:
    """This rank's rows of ``A @ x`` (the registry program of sites
    ``sparse.spmv`` and ``sparse.spmm``): the operand gathered whole when it
    is row-split (at the wire: bf16 moves its bits), the shard-local
    contraction, and the combine."""
    if gather_n is not None:
        xg = A.comm.allgather(xl.to(tdt), 0, gather_n, precision=wire)
    else:
        xg = xl.to(tdt)
    return _finish(A, _contract(A, xg, tdt, reduce, pattern), tdt, reduce, replicate, wire)


def _same_comm(a: TorchCommunication, b: TorchCommunication) -> bool:
    return a is b or (a.group is b.group and a.size == b.size and a.rank == b.rank)


def spmv(A: SparseDNDarray, x: DNDarray, *, out_split: Optional[int] = 0,
         precision: Optional[str] = None, reduce: str = "sum", pattern: bool = False,
         audit: bool = False) -> DNDarray:
    """Sparse matrix-vector product ``A @ x``.

    ``x`` is replicated or row-split (gathered whole). ``out_split=0``
    (default) returns the row-split result with no collective;
    ``out_split=None`` the replicated one, through one allreduce.
    ``reduce`` is the per-row combiner (``'sum'``, ``'min'``, ``'max'``) and
    ``pattern=True`` ignores the stored values (structure-only propagation,
    :func:`heat_tpu_torch.graph.connected_components`); the result type is
    then ``x``'s. A row with no stored element gives the reduction's
    identity: 0 for a sum, the type's extreme for min/max (for floats +-inf,
    and +-finfo.max in a replicated result over several ranks, as in the
    JAX package)."""
    return _dispatch_sparse_dense("spmv", A, x, out_split, precision, reduce, pattern, audit)


def spmm(A: SparseDNDarray, X: DNDarray, *, out_split: Optional[int] = 0,
         precision: Optional[str] = None, audit: bool = False) -> DNDarray:
    """Sparse times dense matrix ``A @ X``: :func:`spmv` over an ``(n, k)``
    operand, the result ``(m, k)``."""
    return _dispatch_sparse_dense("spmm", A, X, out_split, precision, "sum", False, audit)


def make_solver_matvec(A: SparseDNDarray, dt):
    """The matvec that ``linalg.cg``/``lanczos`` call on ``A``
    (``SparseDNDarray._matvec_spec``): a replicated ``(n,)`` tensor in
    ``dt`` in, the replicated ``(m,)`` product out; the shard-local product
    and one allreduce, as :func:`spmv` with ``out_split=None`` (its sum at
    ``HEAT_TPU_SPARSE_SPMV_PREC``'s wire)."""
    ht = types.canonical_heat_type(dt)
    tdt, wire = ht.torch_type(), spmv_wire(ht)
    return lambda x: _finish(A, _contract(A, x.to(tdt), tdt, "sum", False), tdt, "sum", True,
                             wire)


# -- densify --------------------------------------------------------------------


def to_dense(A: SparseDNDarray) -> DNDarray:
    """The dense row-split :class:`DNDarray` (each rank scatters its live
    rows; duplicate coordinates, which the constructors reject, would
    sum)."""
    if not isinstance(A, SparseDNDarray):
        raise TypeError(f"expected a SparseDNDarray, got {type(A)}")
    m, n = A.shape
    dense = program_cache.cached_program("sparse.to_dense", (n, A.dtype), lambda: _to_dense,
                                         comm=A.comm, inline=True)(A)
    _record("to_dense", nnz=A.nnz, rows=m, cols=n)
    return DNDarray(dense, (m, n), A.dtype, 0, A.device, A.comm, True)


def _to_dense(A: SparseDNDarray) -> torch.Tensor:
    """This rank's dense rows (the registry program of site
    ``sparse.to_dense``)."""
    c = A.lnnz
    vals = _bits(A.values[:c])
    dense = vals.new_zeros((A.lrows, A.shape[1]))
    dense.index_put_((A._slot_rows(), A.indices[:c].to(torch.int64)), vals, accumulate=True)
    return _unbits(dense, A.values.dtype)


def _padded(vals: torch.Tensor, cap: int) -> torch.Tensor:
    """``vals`` followed by zeros up to ``cap`` slots."""
    bits = _bits(vals)
    out = bits.new_zeros(cap)
    out[: bits.shape[0]] = bits
    return _unbits(out, vals.dtype)


# -- transpose ---------------------------------------------------------------------


def _counts_of(comm: TorchCommunication, count: int, device: torch.device) -> np.ndarray:
    """Every rank's ``count``, in rank order (replicated numpy)."""
    t = torch.tensor([count], dtype=torch.int64, device=device)
    return comm.allgather(t, 0, comm.size).cpu().numpy()


def _exchange(comm: TorchCommunication, dest: torch.Tensor, *payloads: torch.Tensor):
    """Send each element of ``payloads`` to rank ``dest`` (one
    ``alltoallv`` a payload); returns the received elements in (source
    rank, source order) order."""
    if comm.size == 1:
        return payloads
    order = torch.argsort(dest, stable=True)
    send = torch.bincount(dest, minlength=comm.size)
    recv = comm.alltoallv(send, [1] * comm.size, [1] * comm.size)
    # heatlint: disable=HL004 -- alltoallv takes its counts on the host: a
    # variable-length exchange has no fixed-shape form in torch.distributed
    # (the program runs inline, never captured)
    send_counts, recv_counts = send.tolist(), recv.tolist()
    return tuple(_unbits(comm.alltoallv(_bits(p)[order], send_counts, recv_counts), p.dtype)
                 for p in payloads)


def transpose(A: SparseDNDarray, *, audit: bool = False, slab: Optional[int] = None) -> SparseDNDarray:
    """``A.T``: each element goes to the rank that owns its destination row,
    in ``ceil(cap / slab)`` stages of ``slab`` slots (one ``alltoallv`` of
    packed keys and one of values a stage; without ``slab`` the stages the
    memory budget allows, one without a budget). The
    result's counts, capacity and order within a row (by column, then
    source row) are the JAX package's, and a staged transpose is bit for
    bit the one-stage one. A ``sparse.transpose`` span; ``audit=True``
    records the exchange against ``sparse_transpose_cost`` (module
    docstring)."""
    if not isinstance(A, SparseDNDarray):
        raise TypeError(f"expected a SparseDNDarray, got {type(A)}")
    comm = A.comm
    m, n = A.shape
    cap = A.capacity
    item = A.dtype.byte_size()
    if slab is None:
        from ..core import relayout_planner

        slab = relayout_planner.sparse_slab(cap, item, comm.size)
    slab = max(1, min(int(slab), cap))
    n_stages = max(1, math.ceil(cap / slab))
    cost, fields, do_audit = telemetry.op_cost(
        telemetry.collectives.sparse_transpose_cost, slab, item, comm.size, n_stages,
        audit=audit)
    with telemetry.span("sparse.transpose", gshape=[m, n], nnz=A.nnz, mesh=comm.size,
                        stages=n_stages, slab=slab, **fields) as sp:
        if do_audit:
            # the whole plan's bytes: one stage's cost times the stages
            plan = telemetry.collectives.CollectiveCost(cost.kind, cost.bytes * cost.steps)
            out, _ = telemetry.hlo.audit_call(
                "sparse.transpose_a2a", lambda: _transpose(A, slab), predicted=plan,
                fields={"mesh": comm.size, "stages": n_stages})
        else:
            out = _transpose(A, slab)
        sp.output(out.values)
    _record("transpose", nnz=A.nnz, rows=m, cols=n, stages=n_stages, slab=slab,
            **({"bytes": cost.bytes * cost.steps} if cost is not None else {}))
    return out


def _transpose(A: SparseDNDarray, slab: int) -> SparseDNDarray:
    comm = A.comm
    m, n = A.shape
    cap = A.capacity
    R = comm.padded_size(m)  # the packed key's row base
    r_new = comm.chunk_size(n)
    c = A.lnnz
    cols = A.indices[:c].to(torch.int64)
    keys = cols * R + (A._slot_rows() + comm.rank * A.row_chunk)
    vals = A.values[:c]
    got_k, got_v = [], []
    stage = program_cache.cached_program("sparse.transpose_a2a", (R, r_new, A.dtype),
                                         lambda: _exchange, comm=comm, inline=True)
    for k0 in range(0, cap, slab):  # the same stages on every rank: cap is uniform
        lo, hi = min(k0, c), min(k0 + slab, c)
        k, v = stage(comm, cols[lo:hi] // r_new, keys[lo:hi], vals[lo:hi])
        got_k.append(k)
        got_v.append(v)
    return program_cache.cached_program(
        "sparse.transpose_build", (R, r_new, len(got_k), A.dtype), lambda: _transpose_build,
        comm=comm, inline=True)(A, got_k, got_v, R, r_new)


def _transpose_build(A: SparseDNDarray, got_k, got_v, R: int, r_new: int) -> SparseDNDarray:
    """The transpose's shard from the keys and values the stages brought
    (the registry program of site ``sparse.transpose_build``): sorted by
    (row, column), counted, packed."""
    comm = A.comm
    m, n = A.shape
    ks = torch.cat(got_k)
    ks, order = torch.sort(ks, stable=True)
    vs = _unbits(_bits(torch.cat(got_v))[order], A.values.dtype)
    count = ks.shape[0]
    counts = _counts_of(comm, count, ks.device)
    new_cap = max(1, int(counts.max()))
    local_row = ks // R - comm.rank * r_new
    new_ip = torch.searchsorted(local_row, torch.arange(r_new + 1, device=ks.device)).to(torch.int32)
    new_ix = _padded((ks % R).to(torch.int32), new_cap)
    return SparseDNDarray.from_shard_arrays(new_ip, new_ix, _padded(vs, new_cap), (n, m), counts,
                                            device=A.device, comm=comm, dtype=A.dtype)


# -- constructors ------------------------------------------------------------------


def _pack_rows(rows: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor, shape: Tuple[int, int],
               comm: TorchCommunication, device, dtype=None,
               counts: Optional[np.ndarray] = None) -> SparseDNDarray:
    """This rank's shard from the triplets of its own rows, sorted by (row,
    col), ``rows`` relative to the shard; ``counts`` are gathered unless
    given."""
    m, _ = shape
    r = comm.chunk_size(m)
    c = rows.shape[0]
    tdev = rows.device
    if counts is None:
        counts = _counts_of(comm, c, tdev)
    cap = max(1, int(counts.max(initial=0)))
    ip = torch.searchsorted(rows.contiguous(), torch.arange(r + 1, device=tdev)).to(torch.int32)
    return SparseDNDarray.from_shard_arrays(ip, _padded(cols.to(torch.int32), cap),
                                            _padded(vals, cap), shape, counts, device=device, comm=comm,
                                            dtype=dtype)


def _keep_rule(block: torch.Tensor, threshold: float, keep: str) -> torch.Tensor:
    """The entries that ``keep`` keeps (numpy's comparison: an exact type
    compares as float64, a float one in its own type)."""
    if block.dtype in _SIGNED:
        block = _widened(block)
    elif not (block.is_floating_point() or block.is_complex()):
        block = block.to(torch.float64)
    if keep == "above":
        return block > threshold
    if keep == "below":
        return block < threshold
    return block.abs() > threshold


def _widened(t: torch.Tensor) -> torch.Tensor:
    """Wide unsigned values as float64."""
    s = t.view(_SIGNED[t.dtype]).to(torch.float64)
    return torch.where(s < 0, s + float(1 << (8 * t.element_size())), s)


def _compact(block: torch.Tensor, offset: int, threshold: float, keep: str,
             include_diagonal: bool):
    """(local rows, cols, values) of the kept entries of ``block``, the rows
    ``offset..`` of a square or rectangular matrix, in row-major order; with
    ``include_diagonal`` every diagonal entry too, storing 0 where the rule
    fails."""
    rule = _keep_rule(block, threshold, keep)
    mask = rule
    if include_diagonal:
        mask = rule.clone()
        i = torch.arange(block.shape[0], device=block.device)
        live = i + offset < block.shape[1]
        mask[i[live], i[live] + offset] = True
    rows, cols = torch.nonzero(mask, as_tuple=True)
    vals = _bits(block)[rows, cols]
    vals = torch.where(rule[rows, cols], vals, torch.zeros((), dtype=vals.dtype, device=vals.device))
    return rows, cols, _unbits(vals, block.dtype)


def csr_from_dense(x, *, threshold: float = 0.0, keep: str = "nonzero",
                   include_diagonal: bool = False, comm=None, device=None) -> SparseDNDarray:
    """Compact a dense matrix (numpy or DNDarray) into a
    :class:`SparseDNDarray`.

    ``keep`` is the rule: ``'nonzero'`` (``|v| > threshold``, default 0),
    ``'above'`` (``v > threshold``) or ``'below'`` (``v < threshold``).
    ``include_diagonal`` gives every row of a square matrix a diagonal slot
    (storing 0 where the rule fails). Each rank compacts its own rows on its
    device; only the element counts are gathered."""
    if keep not in ("nonzero", "above", "below"):
        raise ValueError(f"keep must be 'nonzero'/'above'/'below', got {keep!r}")
    if isinstance(x, DNDarray):
        comm = x.comm if comm is None else comm
        device = x.device if device is None else device
        dtype = x.dtype
        shape = x.shape
        if x.ndim != 2:
            raise ValueError(f"expected a 2-D matrix, got {x.ndim}-D")
        if x.split == 0:
            block = x.larray
        elif x.split == 1 and x.comm.size > 1:
            block = x.resplit(0).larray
        else:
            _, _, sl = x.comm.chunk(shape, 0)
            block = x.larray[sl]
    else:
        host = np.asarray(x)
        if host.ndim != 2:
            raise ValueError(f"expected a 2-D matrix, got {host.ndim}-D")
        comm = sanitize_comm(comm)
        device = sanitize_device(device)
        dtype = None
        shape = host.shape
        _, _, sl = comm.chunk(shape, 0)
        block = torch.from_numpy(np.ascontiguousarray(host[sl])).to(device.torch_device)
    comm = sanitize_comm(comm)
    device = sanitize_device(device)
    if include_diagonal and shape[0] != shape[1]:
        raise ValueError("include_diagonal requires a square matrix")
    offset = comm.chunk(shape, 0)[0]
    rows, cols, vals = _compact(block, offset, threshold, keep, include_diagonal)
    out = _pack_rows(rows, cols, vals, shape, comm, device, dtype)
    _record("from_dense", nnz=out.nnz, rows=shape[0], cols=shape[1], keep=keep)
    return out


_COO_ORDER = ("COO triplets must be sorted by (row, col) and free of duplicate coordinates")


def _check_ranges(rmin: int, rmax: int, cmin: int, cmax: int, m: int, n: int) -> None:
    if rmin < 0 or rmax >= m:
        raise ValueError(f"row indices must lie in [0, {m})")
    if cmin < 0 or cmax >= n:
        raise ValueError(f"column indices must lie in [0, {n})")


def _from_host_coo(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray, shape: Tuple[int, int],
                   comm: TorchCommunication, device, dtype=None) -> SparseDNDarray:
    """This rank's shard from sorted host COO triplets (the JAX package's
    checks and errors)."""
    m, n = (int(s) for s in shape)
    p = comm.size
    r = comm.chunk_size(m)
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals)
    if rows.size:
        _check_ranges(int(rows.min()), int(rows.max()), int(cols.min()), int(cols.max()), m, n)
        if (np.diff(rows * n + cols) <= 0).any():
            raise ValueError(_COO_ORDER)
    bounds = np.searchsorted(rows, np.arange(p + 1) * r)
    lo, hi = int(bounds[comm.rank]), int(bounds[comm.rank + 1])
    tdev = device.torch_device
    return _pack_rows(torch.from_numpy(rows[lo:hi] - comm.rank * r).to(tdev),
                      torch.from_numpy(cols[lo:hi]).to(tdev),
                      torch.from_numpy(np.ascontiguousarray(vals[lo:hi])).to(tdev),
                      (m, n), comm, device, dtype, counts=np.diff(bounds))


def _from_dnd_coo(rows: DNDarray, cols: DNDarray, values: DNDarray, shape: Tuple[int, int],
                  comm: TorchCommunication, device) -> SparseDNDarray:
    """Triplets as DNDarrays: packed ``row·n + col`` keys ordered by the
    distributed sort, each element sent to its row's rank."""
    from ..core import manipulations

    m, n = shape
    local = [rows.larray, cols.larray]
    ext = []
    for t in local:
        t = t.to(torch.int64)
        if t.numel():
            ext += [t.min(), -t.max()]
        else:
            ext += [torch.tensor(1 << 62, device=t.device)] * 2
    ext = comm.allreduce(torch.stack(ext), "min")
    if rows.shape[0]:
        _check_ranges(int(ext[0]), -int(ext[1]), int(ext[2]), -int(ext[3]), m, n)
    packed = rows.astype(types.int64) * n + cols.astype(types.int64)
    keys, order = manipulations.sort(packed)
    vals = values[order]
    if vals.split != keys.split:
        vals = vals.resplit(keys.split)
    k, v = keys.larray, vals.larray
    r = comm.chunk_size(m)
    if keys.split is None or comm.size == 1:
        # every rank holds all the keys: keep the rows it owns
        lo = int(torch.searchsorted(k, torch.tensor([comm.rank * r * n], device=k.device)))
        hi = int(torch.searchsorted(k, torch.tensor([min(m, (comm.rank + 1) * r) * n],
                                                    device=k.device)))
        k, v = k[lo:hi], v[lo:hi]
    else:
        k, v = _exchange(comm, k // n // r, k, v)
    dup = torch.tensor([int(bool((k.diff() <= 0).any()))], device=k.device)
    if int(comm.allreduce(dup, "max")):
        raise ValueError(_COO_ORDER)
    return _pack_rows(k // n - comm.rank * r, k % n, v, shape, comm, device)


def csr_from_coo(rows, cols, values, shape: Tuple[int, int], *, comm=None,
                 device=None) -> SparseDNDarray:
    """A :class:`SparseDNDarray` from COO triplets: DNDarrays (any split)
    ordered by the distributed sort of packed ``row·n + col`` keys, each
    element then sent to the rank of its row; host arrays by a
    ``lexsort``. Duplicate coordinates raise ``ValueError``."""
    m, n = (int(s) for s in shape)
    if isinstance(rows, DNDarray):
        if not (isinstance(cols, DNDarray) and isinstance(values, DNDarray)):
            raise TypeError("csr_from_coo: rows/cols/values must all be DNDarrays "
                            "(or all host arrays)")
        comm = sanitize_comm(rows.comm if comm is None else comm)
        device = sanitize_device(rows.device if device is None else device)
        if not (rows.shape == cols.shape == values.shape) or rows.ndim != 1:
            raise ValueError(f"csr_from_coo: triplets must be matching 1-D vectors, got "
                             f"{rows.shape}/{cols.shape}/{values.shape}")
        out = _from_dnd_coo(rows, cols, values, (m, n), comm, device)
        sorted_via = "distributed-sort"
    else:
        rh = np.asarray(rows, dtype=np.int64)
        ch = np.asarray(cols, dtype=np.int64)
        vh = np.asarray(values)
        order = np.lexsort((ch, rh))
        out = _from_host_coo(rh[order], ch[order], vh[order], (m, n), sanitize_comm(comm),
                             sanitize_device(device))
        sorted_via = "lexsort"
    _record("from_coo", nnz=out.nnz, rows=m, cols=n, sorted_via=sorted_via)
    return out
