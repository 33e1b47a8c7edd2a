"""Graph Laplacian construction (counterpart of
``heat_tpu/graph/laplacian.py``).

``L`` keeps the rows of ``X``: a row-split ``X`` gives a row-split ``L``.

The eNeighbour graph is a :class:`~heat_tpu_torch.sparse.SparseDNDarray`
unless ``sparse=False``, or, with ``sparse=None``, unless its density
(diagonal slots included) is above ``HEAT_TPU_SPARSE_DENSE_THRESHOLD``
(default 0.25). It is built without the n × n similarity: blocks of
global rows, ``bs = max(1, min(n, 2^28 // (n·itemsize)))`` of them a rank,
split along their rows as ``X``, each block's similarity against every row
(``pair_similarity``, on the cdist kernel for ``rbf``; without it one full
similarity, hoisted) thresholded and compacted on the device at once,
every row given a diagonal slot storing 0 (no self-loops); the elements go
to the ranks that own their rows (``alltoallv``). Then the
degree is ``spmv(A, ones, out_split=None)`` (its allreduce is the one
collective) and each value is rewritten in place: the diagonal slots to 1
(``norm_sym``) or the degree (``simple``), the others to ``−v/√(dᵢdⱼ)`` or
``−v``.

The dense Laplacian: each rank thresholds its rows, drops their self-loops
and sums them into its part of the degree vector ``d``. ``L = D − A``
needs nothing more; ``L = I − D^-1/2 A D^-1/2`` allgathers ``d`` (the JAX
package gathers ``A``, :291 there).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .. import _knobs as knobs
from .. import telemetry
from ..core import program_cache, types
from ..core.dndarray import DNDarray

__all__ = ["Laplacian"]

_BLOCK_BUDGET = 1 << 28  # bytes of one (rows, n) similarity block


def _laplacian_values(A, dvec: torch.Tensor, definition: str) -> torch.Tensor:
    """The Laplacian's values on the adjacency ``A``'s slots, in ``dvec``'s
    type (the registry program of site ``sparse.laplacian``)."""
    tdt = dvec.dtype
    c = A.lnnz
    rows = A._slot_rows() + A.comm.rank * A.row_chunk
    ix = A.indices[:c].to(torch.int64)
    vals = A.values[:c].to(tdt)
    on_diag = ix == rows
    if definition == "norm_sym":
        dinv = torch.where(dvec > 0, 1.0 / torch.sqrt(dvec), torch.zeros((), dtype=tdt,
                                                                            device=dvec.device))
        out = torch.where(on_diag, torch.ones((), dtype=tdt, device=vals.device),
                          -vals * dinv[rows] * dinv[ix])
    else:
        out = torch.where(on_diag, dvec[rows], -vals)
    new_vals = torch.zeros(A.capacity, dtype=tdt, device=vals.device)
    new_vals[:c] = out
    return new_vals


class Laplacian:
    """A graph Laplacian from pairwise similarities (reference
    laplacian.py:29).

    Parameters
    ----------
    similarity : callable
        DNDarray (n, d) → similarity matrix (n, n), such as ``spatial.rbf``.
    weighted : bool
        Keep the similarities as edge weights (else every edge weighs 1).
    definition : 'simple' | 'norm_sym'
        ``L = D − A`` or ``L = I − D^-1/2 A D^-1/2``.
    mode : 'fully_connected' | 'eNeighbour'
        The whole weighted graph, or the edges whose weight is below
        (``threshold_key='upper'``) or above (``'lower'``)
        ``threshold_value``.
    sparse : bool, optional
        The eNeighbour graph's form: ``None`` a sparse array unless its
        density is above ``HEAT_TPU_SPARSE_DENSE_THRESHOLD``, ``True``
        always sparse, ``False`` always dense. A fully connected graph is
        dense.
    pair_similarity : callable, optional
        The two-operand form ``(rows, x) -> (rows, n)`` similarity, with
        which the sparse graph is built block by block; without it the
        full similarity is computed once first.
    neighbours : int
        Kept for the JAX package's signature.
    """

    def __init__(
        self,
        similarity: Callable,
        weighted: bool = True,
        definition: str = "norm_sym",
        mode: str = "fully_connected",
        threshold_key: str = "upper",
        threshold_value: float = 1.0,
        neighbours: int = 10,
        sparse: Optional[bool] = None,
        pair_similarity: Optional[Callable] = None,
    ):
        if definition not in ("simple", "norm_sym"):
            raise NotImplementedError(
                "Only simple and normalized symmetric graph laplacians are supported at the moment")
        if mode not in ("eNeighbour", "fully_connected"):
            raise NotImplementedError(
                "Only eNeighborhood and fully-connected graphs supported at the moment.")
        self.similarity_metric = similarity
        self.weighted = weighted
        self.definition = definition
        self.mode = mode
        self.epsilon = (threshold_key, threshold_value)
        self.neighbours = neighbours
        self.sparse = sparse
        self.pair_similarity = pair_similarity

    # -- the sparse eNeighbour path ---------------------------------------------

    def _compact(self, block: torch.Tensor, first: int):
        """(global rows, cols, values) of a similarity block whose rows are
        the global rows ``first..``: the thresholded entries and a diagonal
        slot storing 0 in every row, in row-major order."""
        from ..sparse.ops import _compact

        key, val = self.epsilon
        r, c, v = _compact(block, first, val, "below" if key == "upper" else "above", True)
        if not self.weighted:
            v = torch.ones_like(v)
        return r + first, c, torch.where(c == r + first, torch.zeros_like(v), v)

    def _sparse_adjacency(self, X: DNDarray):
        """(local rows, cols, values, element type) of this rank's rows of
        the thresholded adjacency, sorted by (row, col), with a diagonal
        slot storing 0 in every row; built block by block on the device.
        With ``pair_similarity`` a block is a range of global rows, split
        along them as ``X`` (each rank computes at most ``bs`` of them) and
        its elements then go to the ranks that own their rows."""
        from ..sparse.ops import _exchange

        n = X.shape[0]
        comm = X.comm
        dt = types.promote_types(X.dtype, types.float32)
        tdt = dt.torch_type()
        bs = max(1, min(n, _BLOCK_BUDGET // max(1, n * tdt.itemsize)))
        offset, (n_local, _), _ = comm.chunk(X.shape, 0)
        parts = []
        if self.pair_similarity is None:
            # no block form: one full similarity, hoisted out of the loop
            S = self.similarity_metric(X)
            s_local = S.larray if S.split == 0 else S._global()[offset:offset + n_local]
            for lo in range(0, n_local, bs):
                parts.append(self._compact(s_local[lo:lo + bs].to(tdt), offset + lo))
        else:
            rows_x = X if X.split == 0 or (X.split is None and comm.size == 1) else X.resplit(0)
            x_rep = X if X.split is None else X.resplit(None)
            for lo in range(0, n, bs * comm.size):
                xb = rows_x[lo:min(n, lo + bs * comm.size)]
                first = lo + (comm.chunk(xb.shape, 0)[0] if xb.split == 0 else 0)
                parts.append(self._compact(self.pair_similarity(xb, x_rep).larray.to(tdt), first))
        if parts:
            rows, cols, vals = (torch.cat(t) for t in zip(*parts))
        else:
            dev = X.larray.device
            rows = cols = torch.zeros(0, dtype=torch.int64, device=dev)
            vals = torch.zeros(0, dtype=tdt, device=dev)
        if self.pair_similarity is not None and comm.size > 1:
            # each element to the rank of its row, then in (row, col) order
            rows, cols, vals = _exchange(comm, rows // comm.chunk_size(n), rows, cols, vals)
            keys, order = torch.sort(rows * n + cols)
            rows, cols, vals = keys // n, keys % n, vals[order]
        return rows - offset, cols, vals, dt

    def _sparse_laplacian_values(self, A, d: DNDarray, dt):
        """The adjacency's values rewritten into the Laplacian's on the same
        structure: diagonal slots 1 (``norm_sym``) or the degree
        (``simple``), the others ``−v·d_i^-1/2·d_j^-1/2`` or ``−v``. Local to
        each rank."""
        from ..sparse.container import SparseDNDarray

        tdt = dt.torch_type()
        new_vals = program_cache.cached_program(
            "sparse.laplacian", (self.definition, str(tdt)), lambda: _laplacian_values,
            comm=A.comm, inline=True)(A, d.larray.to(tdt), self.definition)
        return SparseDNDarray.from_shard_arrays(A.indptr, A.indices, new_vals, A.shape, A.counts,
                                                device=A.device, comm=A.comm, dtype=dt)

    def _construct_sparse(self, X: DNDarray):
        """The eNeighbour sparse pipeline: blocked thresholding → density
        gate → degree spmv → value rewrite. None when the density gate sends
        the graph to the dense path."""
        from .. import sparse as htsparse
        from ..core import factories
        from ..sparse.ops import _pack_rows

        n = X.shape[0]
        rows, cols, vals, dt = self._sparse_adjacency(X)
        A = _pack_rows(rows, cols, vals, (n, n), X.comm, X.device, dt)
        limit = float(knobs.get("HEAT_TPU_SPARSE_DENSE_THRESHOLD"))
        if self.sparse is None and A.density > limit:
            if telemetry.enabled():
                reg = telemetry.get_registry()
                reg.add("sparse.dense_fallback", 1)
                reg.emit("sparse", "laplacian", event="dense_fallback", density=A.density,
                         limit=limit, rows=n)
            return None
        ones = factories.ones(n, dtype=dt, device=X.device, comm=X.comm)
        d = htsparse.spmv(A, ones, out_split=None)
        L = self._sparse_laplacian_values(A, d, dt)
        if telemetry.enabled():
            reg = telemetry.get_registry()
            reg.add("sparse.laplacian", 1)
            reg.emit("sparse", "laplacian", event="laplacian", rows=n, nnz=L.nnz,
                     density=A.density)
        return L

    def construct(self, X: DNDarray):
        """Similarity → adjacency → Laplacian, split as ``X``'s rows: a
        :class:`~heat_tpu_torch.sparse.SparseDNDarray` for an eNeighbour
        graph (unless ``sparse=False`` or the density gate), else a dense
        DNDarray."""
        if self.mode == "eNeighbour" and self.sparse is not False:
            L = self._construct_sparse(X)
            if L is not None:
                return L
        S = self.similarity_metric(X)
        split = 0 if X.split == 0 and X.comm.size > 1 else None
        if split == 0:
            A = (S if S.split == 0 else S.resplit(0)).larray
            start = X.comm.counts_displs(X.shape[0])[1][X.comm.rank]
        else:
            A, start = S._global(), 0
        dt = types.promote_types(S.dtype, types.float32).torch_type()
        A = A.to(dt)
        if self.mode == "eNeighbour":
            key, val = self.epsilon
            mask = A < val if key == "upper" else A > val
            A = torch.where(mask, A if self.weighted else torch.ones_like(A), torch.zeros_like(A))
        rows = torch.arange(A.shape[0], device=A.device)
        diag = (rows, rows + start)
        A = A.clone() if A is S.larray else A
        A[diag] = 0  # no self-loops
        d = A.sum(dim=1)
        if self.definition == "norm_sym":
            d_all = X.comm.allgather(d, 0, X.shape[0]) if split == 0 else d
            inv = torch.where(d_all > 0, 1.0 / torch.sqrt(d_all), torch.zeros_like(d_all))
            L = -A * inv[start:start + A.shape[0], None] * inv[None, :]
            L[diag] = 1.0
        else:
            L = -A
            L[diag] += d
        gsplit = X.split if X.split in (None, 0) else None
        return DNDarray(L, (X.shape[0], X.shape[0]), types.canonical_heat_type(L.dtype),
                        gsplit, X.device, X.comm, True)
