"""Shared machinery for the K-family clusterers (counterpart of
``heat_tpu/cluster/_kcluster.py``: ``_d2`` and ``_KCluster``)."""

from __future__ import annotations

from typing import Optional

import torch

from ..core import types
from ..core.base import BaseEstimator, ClusteringMixin
from ..core.dndarray import DNDarray

__all__ = ["_KCluster", "_d2"]


def _d2(xb: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """(m, k) squared euclidean distances in GEMM form, clamped at 0. The
    product runs in full f32: TF32, whose ~3 decimal digits would flip
    assignments near cluster boundaries, is off for the product alone, and
    the caller's setting is restored after it, also when it raises."""
    x2 = (xb * xb).sum(dim=1, keepdim=True)
    c2 = (centers * centers).sum(dim=1)[None, :]
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        xc = xb @ centers.T
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return torch.clamp(x2 + c2 - 2.0 * xc, min=0.0)


class _KCluster(BaseEstimator, ClusteringMixin):
    """Base for the K-family clusterers (reference _kcluster.py:10).

    ``init`` is ``'random'`` (k distinct data rows) or a DNDarray of initial
    centers. ``'random'`` draws the rows with a ``torch.Generator`` seeded
    by ``random_state`` (0 when None); it does not reproduce the JAX
    package's ``jax.random`` draw, so the two packages start from different
    rows for the same seed. ``'probability_based'`` is not ported yet.
    """

    def __init__(self, metric: str, n_clusters: int, init, max_iter: int, tol: float,
                 random_state: Optional[int]):
        if metric != "euclidean":
            raise ValueError(f"metric must be 'euclidean', got {metric!r}")
        self._metric_name = metric
        self.n_clusters = n_clusters
        self.init = init
        self.max_iter = max_iter
        self.tol = tol
        self.random_state = random_state
        self._cluster_centers = None
        self._labels = None
        self._inertia = None
        self._n_iter = None

    @property
    def cluster_centers_(self) -> DNDarray:
        return self._cluster_centers

    @property
    def labels_(self) -> DNDarray:
        return self._labels

    @property
    def inertia_(self) -> float:
        return self._inertia

    @property
    def n_iter_(self) -> int:
        return self._n_iter

    def _initialize_cluster_centers(self, x: DNDarray) -> torch.Tensor:
        """Initial (k, d) centers, the same on every rank."""
        k = self.n_clusters
        if isinstance(self.init, DNDarray):
            if self.init.shape != (k, x.shape[1]):
                raise ValueError(
                    f"passed centroids need to be of shape ({k}, {x.shape[1]}), but are {self.init.shape}"
                )
            return self.init._global().to(x.larray.device)
        if self.init == "random":
            n = x.shape[0]
            if k > n:
                raise ValueError(f"cannot draw {k} initial centers from {n} rows")
            gen = torch.Generator(device="cpu")
            gen.manual_seed(self.random_state if self.random_state is not None else 0)
            idx = torch.randperm(n, generator=gen)[:k].to(x.larray.device)
            if x.split is None or x.comm.size == 1:
                return x.larray[idx].clone()
            # each rank fills the drawn rows it owns; one allreduce joins them
            offset, lshape, _ = x.comm.chunk(x.shape, x.split)
            mine = (idx >= offset) & (idx < offset + lshape[0])
            centers = torch.zeros((k, x.shape[1]), dtype=x.larray.dtype, device=x.larray.device)
            centers[mine] = x.larray[idx[mine] - offset]
            return x.comm.allreduce(centers)
        if self.init in ("probability_based", "kmeans++", "k-means++"):
            raise NotImplementedError("init='probability_based' is not ported yet")
        raise ValueError(
            f"initialization needs to be 'random', 'probability_based' or a DNDarray, but was {self.init}"
        )

    def _assign_to_cluster(self, x: DNDarray) -> DNDarray:
        """Nearest center of each sample (reference _kcluster.py:196)."""
        centers = self._cluster_centers._global()
        d = _d2(x.larray.to(centers.dtype), centers)
        labels = torch.argmin(d, dim=1).to(torch.int64)
        return DNDarray(labels, (x.shape[0],), types.int64, x.split, x.device, x.comm, True)

    def predict(self, x: DNDarray) -> DNDarray:
        """Nearest learned centroid for each sample."""
        if self._cluster_centers is None:
            raise RuntimeError("fit needs to be called before predict")
        return self._assign_to_cluster(x)
