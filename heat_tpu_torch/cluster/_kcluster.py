"""Shared machinery for the K-family clusterers (counterpart of
``heat_tpu/cluster/_kcluster.py``: ``_d2``, ``_d1`` and ``_KCluster``)."""

from __future__ import annotations

from typing import Optional

import torch

from ..core import _threefry, cuda_random, types
from ..core.base import BaseEstimator, ClusteringMixin
from ..core.dndarray import DNDarray

__all__ = ["_KCluster", "_d1", "_d2"]


def _rows(x: DNDarray, data: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The rows ``idx`` (global indices, the same on every rank) of ``x``
    on every rank; ``data`` is the local rows (all rows unless ``x`` is
    split along 0). Across ranks each rank fills the rows it owns and one
    allreduce joins them."""
    if x.split != 0 or x.comm.size == 1:
        return data[idx].clone()
    offset, lshape, _ = x.comm.chunk(x.shape, 0)
    mine = (idx >= offset) & (idx < offset + lshape[0])
    rows = torch.zeros((idx.shape[0], x.shape[1]), dtype=data.dtype, device=data.device)
    rows[mine] = data[idx[mine] - offset]
    return x.comm.allreduce(rows)


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


def _d1(xb: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """(m, k) Manhattan distances, the assignment metric of KMedians and
    KMedoids, over row blocks of ``xb`` so that the (rows, k, d) difference
    stays under 256 MiB (``spatial``'s broadcast form)."""
    from ..spatial.distance import _blocked

    return _blocked(xb, centers, manhattan=True)


def _argmin_rows(x: DNDarray, d: torch.Tensor) -> torch.Tensor:
    """The global row index of each column's minimum of ``d`` (this rank's
    rows of an (n, k) matrix, rows split as ``x``), the lowest index among
    equal minima, the same on every rank."""
    idx = torch.argmin(d, dim=0) if d.shape[0] else d.new_zeros(d.shape[1], dtype=torch.int64)
    if x.split != 0 or x.comm.size == 1:
        return idx
    best = d.gather(0, idx[None]).squeeze(0) if d.shape[0] else torch.full_like(
        idx, float("inf"), dtype=d.dtype)
    offset = x.comm.chunk(x.shape, 0)[0]
    p = x.comm.size
    vals = x.comm.allgather(best[None], 0, p)  # (p, k)
    rows = x.comm.allgather((idx + offset)[None], 0, p)
    # the lowest rank among the minima holds the lowest index
    winner = torch.argmin(vals, dim=0)
    return rows.gather(0, winner[None]).squeeze(0)


class _KCluster(BaseEstimator, ClusteringMixin):
    """Base for the K-family clusterers (reference _kcluster.py:10).

    ``init`` is ``'random'`` (k distinct data rows), ``'probability_based'``
    (k-means++; also ``'kmeans++'``) or a DNDarray of initial centers. The
    draws are the JAX package's, from ``PRNGKey(random_state)`` (0 when
    None) through the port's threefry stream, on the card: ``'random'``
    takes the first k of ``permutation(n)`` and picks the same rows as the
    JAX package; k-means++ draws its first row with ``randint`` and each
    further one with ``choice(p = d2 / sum d2)``, the same rows unless a
    draw falls within rounding of a boundary of the cumulative ``p``.
    """

    def __init__(self, metric: str, n_clusters: int, init, max_iter: int, tol: float,
                 random_state: Optional[int]):
        if metric not in ("euclidean", "manhattan"):
            raise ValueError(f"metric must be 'euclidean' or 'manhattan', got {metric!r}")
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
        """Initial (k, d) centers, the same on every rank, drawn as the JAX
        package draws them from ``PRNGKey(random_state or 0)`` (its
        ``_kcluster.py:103-133``)."""
        k = self.n_clusters
        if isinstance(self.init, DNDarray):
            if self.init.shape != (k, x.shape[1]):
                raise ValueError(
                    f"passed centroids need to be of shape ({k}, {x.shape[1]}), but are {self.init.shape}"
                )
            return self.init._global().to(x.larray.device)
        key = _threefry.prng_key(self.random_state if self.random_state is not None else 0)
        n, tdev = x.shape[0], x.larray.device
        data = x.larray if x.split in (None, 0) else x._global()
        sharded = x.split == 0 and x.comm.size > 1
        if self.init == "random":
            idx = _threefry.choice(key, n, (k,), replace=False, device=tdev,
                                   draw=cuda_random.draw)
            return _rows(x, data, idx)
        if self.init in ("probability_based", "kmeans++", "k-means++"):
            # k-means++: the first row uniformly, each further one with
            # probability proportional to its squared distance from the
            # nearest center so far
            first = _threefry.randint(key, _threefry.Slice.whole(()), 0, n, torch.int64,
                                      cuda_random.draw, tdev)
            centers = [_rows(x, data, first.reshape(1))]
            xf = data.to(torch.float32)
            for _ in range(1, k):
                key, sub = _threefry.split(key)
                d2 = _d2(xf, torch.cat(centers).to(torch.float32)).min(dim=1).values
                if sharded:
                    d2 = x.comm.allgather(d2, 0, n)
                probs = d2 / torch.clamp(d2.sum(), min=1e-30)
                nxt = _threefry.choice(sub, n, p=probs, device=tdev, draw=cuda_random.draw)
                centers.append(_rows(x, data, nxt.reshape(1)))
            return torch.cat(centers)
        raise ValueError(
            f"initialization needs to be 'random', 'probability_based' or a DNDarray, but was {self.init}"
        )

    def _assign_to_cluster(self, x: DNDarray) -> DNDarray:
        """Nearest center of each sample under the estimator's metric
        (reference _kcluster.py:196)."""
        centers = self._cluster_centers._global()
        dist = _d1 if self._metric_name == "manhattan" else _d2
        d = dist(x.larray.to(centers.dtype), centers)
        labels = torch.argmin(d, dim=1).to(torch.int64)
        return DNDarray(labels, (x.shape[0],), types.int64, x.split, x.device, x.comm, True)

    def predict(self, x: DNDarray) -> DNDarray:
        """Nearest learned centroid for each sample."""
        if self._cluster_centers is None:
            raise RuntimeError("fit needs to be called before predict")
        return self._assign_to_cluster(x)
