"""Graph Laplacian construction (counterpart of
``heat_tpu/graph/laplacian.py``).

``L`` keeps the rows of ``X``: a row-split ``X`` gives a row-split
similarity, each rank thresholds its rows, drops their self-loops and sums
them into its part of the degree vector ``d``. ``L = D − A`` needs nothing
more; ``L = I − D^-1/2 A D^-1/2`` allgathers ``d`` (the JAX package
gathers ``A``, :291 there). The eNeighbour graph is dense here also when
``sparse`` is None, where the JAX package builds a ``SparseDNDarray`` with
the same values; ``sparse=True`` waits for the sparse arrays (ROADMAP item
10a).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..core import types
from ..core.dndarray import DNDarray

__all__ = ["Laplacian"]


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
        ``True`` asks for a sparse eNeighbour graph, not ported yet.
    neighbours, pair_similarity :
        Kept for the JAX package's signature; only its sparse path reads
        them.
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
        if sparse:
            raise NotImplementedError("sparse Laplacians come with the sparse arrays "
                                      "(ROADMAP item 10a)")
        self.similarity_metric = similarity
        self.weighted = weighted
        self.definition = definition
        self.mode = mode
        self.epsilon = (threshold_key, threshold_value)
        self.neighbours = neighbours
        self.sparse = sparse
        self.pair_similarity = pair_similarity

    def construct(self, X: DNDarray) -> DNDarray:
        """Similarity → adjacency → Laplacian, split as ``X``'s rows."""
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
