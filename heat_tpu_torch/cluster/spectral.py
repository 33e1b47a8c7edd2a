"""Spectral clustering (counterpart of ``heat_tpu/cluster/spectral.py``).

The JAX package's pipeline: ``rbf(quadratic_expansion=True)`` (or
``cdist``, ``manhattan`` or a callable) → ``Laplacian(norm_sym)`` →
``lanczos(L, min(n_lanczos, n))`` → ``eigh`` of ``T`` in float64 on the
host → Ritz vectors ``V·eigvec`` in float64 → the ``k`` lowest as float32 →
``KMeans(init="probability_based")``. On the card ``rbf`` is the cdist
kernel's ``rbf`` epilogue and KMeans runs the Lloyd kernel. An eNeighbour
graph is built from the two-operand similarity in row blocks and reaches
``lanczos`` as a ``sparse.SparseDNDarray`` (its matvecs are spmv) unless
it is too dense or ``sparse=False``. The rows stay on their ranks
throughout: the Ritz vectors are this rank's rows of ``V`` times the small
eigenvector matrix.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import spatial
from ..core import types
from ..core.base import BaseEstimator, ClusteringMixin
from ..core.dndarray import DNDarray
from ..core.linalg import lanczos
from ..graph import Laplacian
from .kmeans import KMeans

__all__ = ["Spectral"]


class Spectral(BaseEstimator, ClusteringMixin):
    """Spectral clustering on the graph Laplacian's spectral embedding
    (reference spectral.py:26). ``gamma`` is the RBF coefficient (σ =
    sqrt(1/2γ)), ``metric`` the similarity ('rbf', 'euclidean',
    'manhattan' or a callable), ``laplacian`` the graph, ``n_lanczos`` the
    Krylov subspace size. ``n_clusters=None`` picks the largest gap of the
    eigenvalues."""

    def __init__(
        self,
        n_clusters: Optional[int] = None,
        gamma: float = 1.0,
        metric: str = "rbf",
        laplacian: str = "fully_connected",
        threshold: float = 1.0,
        boundary: str = "upper",
        n_lanczos: int = 300,
        assign_labels: str = "kmeans",
        sparse: Optional[bool] = None,
        **params,
    ):
        self.n_clusters = n_clusters
        self.gamma = gamma
        self.metric = metric
        self.laplacian = laplacian
        self.threshold = threshold
        self.boundary = boundary
        self.n_lanczos = n_lanczos
        self.assign_labels = assign_labels
        self.sparse = sparse

        sigma = float(np.sqrt(1.0 / (2.0 * gamma)))
        pair = None  # the two-operand form the sparse graph is built from
        if callable(metric):
            sim = metric
        elif metric == "rbf":
            sim = lambda x: spatial.rbf(x, sigma=sigma, quadratic_expansion=True)
            pair = lambda a, b: spatial.rbf(a, b, sigma=sigma, quadratic_expansion=True)
        elif metric == "euclidean":
            sim = lambda x: spatial.cdist(x, quadratic_expansion=True)
            pair = lambda a, b: spatial.cdist(a, b, quadratic_expansion=True)
        elif metric == "manhattan":
            sim = spatial.manhattan
            pair = spatial.manhattan
        else:
            raise NotImplementedError(f"Metric {metric} is currently not implemented")
        self._laplacian = Laplacian(
            sim,
            definition="norm_sym",
            mode="eNeighbour" if laplacian == "eNeighbour" else "fully_connected",
            threshold_key=boundary,
            threshold_value=threshold,
            sparse=sparse,
            pair_similarity=pair,
        )
        if assign_labels != "kmeans":
            raise NotImplementedError(f"Linkage via {assign_labels} is currently not implemented")
        self._cluster = KMeans(n_clusters=n_clusters if n_clusters else 8,
                               init="probability_based")
        self._labels = None
        self._embedding = None

    @property
    def labels_(self) -> DNDarray:
        return self._labels

    def _spectral_embedding(self, x: DNDarray):
        """(eigenvalues of T ascending, this rank's rows of the float64 Ritz
        vectors)."""
        L = self._laplacian.construct(x)
        V, T = lanczos(L, min(self.n_lanczos, x.shape[0]))
        if V.split != x.split:  # a sparse L's basis is row-split
            V = V.resplit(x.split)
        eigval, eigvec = np.linalg.eigh(np.asarray(T.numpy(), dtype=np.float64))
        v = V.larray.to(torch.float64)
        return eigval, v @ torch.as_tensor(eigvec, device=v.device)

    def _embed(self, x: DNDarray, ritz: torch.Tensor) -> DNDarray:
        """The ``n_clusters`` lowest Ritz vectors as float32 rows, split as
        ``x``: the clustering space of fit and predict."""
        comp = ritz[:, : self.n_clusters].to(torch.float32).contiguous()
        return DNDarray(comp, (x.shape[0], comp.shape[1]), types.float32, x.split, x.device,
                        x.comm, True)

    @staticmethod
    def _as_rows(x: DNDarray) -> DNDarray:
        """Row-split (or replicated) samples: a feature-split input is
        resplit once."""
        return x.resplit(0) if x.split is not None and x.split != 0 else x

    def fit(self, x: DNDarray) -> "Spectral":
        """Embed and cluster (reference spectral.py:134)."""
        if not isinstance(x, DNDarray):
            raise TypeError(f"input needs to be a DNDarray, but was {type(x)}")
        x = self._as_rows(x)
        eigval, ritz = self._spectral_embedding(x)
        if self.n_clusters is None:
            self.n_clusters = int(np.argmax(np.diff(eigval)) + 1)
            self._cluster.n_clusters = self.n_clusters
        self._embedding = self._embed(x, ritz)
        self._cluster.fit(self._embedding)
        self._labels = self._cluster.labels_
        return self

    def predict(self, x: DNDarray) -> DNDarray:
        """Labels of ``x``, re-embedded from its own similarity graph and
        assigned to the fitted centroids (reference spectral.py:162)."""
        if self._embedding is None:
            raise RuntimeError("fit needs to be called before predict")
        if not isinstance(x, DNDarray):
            raise TypeError(f"input needs to be a DNDarray, but was {type(x)}")
        x = self._as_rows(x)
        _, ritz = self._spectral_embedding(x)
        return self._cluster.predict(self._embed(x, ritz))
