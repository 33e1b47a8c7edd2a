"""``heat_tpu_torch.sparse``: row-split CSR arrays and their products
(counterpart of ``heat_tpu/sparse``).

:class:`SparseDNDarray` holds each rank's CSR rows with the JAX package's
shard layout; ``spmv``/``spmm`` contract them with a dense operand,
``transpose`` moves elements between ranks with ``alltoallv``, and
``csr_from_dense``/``csr_from_coo`` build them. Consumers:
``graph.Laplacian`` (eNeighbour), ``cluster.Spectral`` (its Lanczos matvecs
become spmv), ``graph.connected_components``. :class:`CsrRows` is the
host-side row batch.
"""

from .container import SparseDNDarray
from .host import CsrRows
from .ops import csr_from_coo, csr_from_dense, spmm, spmv, spmv_wire, to_dense, transpose

__all__ = [
    "SparseDNDarray",
    "CsrRows",
    "csr_from_coo",
    "csr_from_dense",
    "spmv",
    "spmm",
    "spmv_wire",
    "to_dense",
    "transpose",
    "EVENT_COUNTER",
]

# the JAX package's sparse event names and their counters (ops._record,
# graph.laplacian, graph.components)
EVENT_COUNTER = {
    name: f"sparse.{name}"
    for name in (
        "spmv", "spmm", "to_dense", "transpose", "from_dense", "from_coo",
        "laplacian", "dense_fallback", "components",
    )
}
