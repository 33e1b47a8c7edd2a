"""Connected components by label propagation (counterpart of
``heat_tpu/graph/components.py``).

Every vertex starts as its own label (its index) and takes the least label
among its neighbours and itself, round after round, until a round changes
nothing. A round is one structure-only sparse product,
``spmv(A, labels, reduce="min", pattern=True, out_split=None)``, and the
same with ``Aᵀ`` unless the graph is known to be symmetric; the host reads
one comparison a round.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import telemetry
from ..core import types
from ..core.dndarray import DNDarray

__all__ = ["connected_components"]


def connected_components(A, *, assume_symmetric: bool = False,
                         max_iter: Optional[int] = None) -> DNDarray:
    """Component labels of the graph whose edges are ``A``'s stored entries
    (the values are ignored).

    ``A`` is a :class:`~heat_tpu_torch.sparse.SparseDNDarray` (a dense
    square DNDarray is compacted first). Edges count in both directions:
    unless ``assume_symmetric``, the transpose (taken once) joins each
    round. Returns the replicated ``(n,)`` int64 labels, each component's
    least vertex index."""
    from .. import sparse as htsparse
    from ..core import factories

    if isinstance(A, DNDarray):
        A = htsparse.csr_from_dense(A)
    if not isinstance(A, htsparse.SparseDNDarray):
        raise TypeError(f"expected a SparseDNDarray (or dense DNDarray), got {type(A)}")
    n, n2 = A.shape
    if n != n2:
        raise ValueError(f"adjacency must be square, got {A.shape}")
    At = None if assume_symmetric else A.transpose()
    labels = factories.array(np.arange(n, dtype=np.int64), device=A.device, comm=A.comm).larray
    limit = n if max_iter is None else int(max_iter)
    rounds = 0
    with telemetry.span("sparse.components", gshape=[n, n], nnz=A.nnz):
        for _ in range(max(1, limit)):
            rounds += 1
            cur = DNDarray(labels, (n,), types.int64, None, A.device, A.comm, True)
            new = torch.minimum(labels, htsparse.spmv(A, cur, reduce="min", pattern=True,
                                                      out_split=None).larray)
            if At is not None:
                new = torch.minimum(new, htsparse.spmv(At, cur, reduce="min", pattern=True,
                                                       out_split=None).larray)
            done = torch.equal(new, labels)
            labels = new
            if done:
                break
    if telemetry.enabled():
        reg = telemetry.get_registry()
        reg.add("sparse.components", 1)
        reg.emit("sparse", "components", event="components", rows=n, rounds=rounds,
                 n_components=int(torch.unique(labels).shape[0]))
    return DNDarray(labels, (n,), types.int64, None, A.device, A.comm, True)
