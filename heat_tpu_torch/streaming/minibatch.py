"""Mini-batch K-Means: the Lloyd window applied per chunk, with a
decayed-count blend of the centers.

Counterpart of ``heat_tpu/streaming/minibatch.py``. Each
``partial_fit(chunk)``

1. runs a window of at most ``inner_iter`` Lloyd iterations on the chunk
   from the carried centers: ``cluster.kmeans._lloyd_window``, the loop of
   the checkpointed ``KMeans`` fit, with its shift carry threading across
   chunks; on the card each iteration is one launch of the Lloyd kernel
   (K4, ``csrc/lloyd.cu``) over this rank's rows, and one allreduce;
2. assigns the chunk to the refined centers (``_d2``, full f32) and sums
   the one-hot rows (per-center counts and sums of this chunk);
3. blends ``counts' = decay·counts + counts_b`` and ``centers' =
   ((decay·counts)·centers + sums_b) / max(counts', 1e-12)`` for the
   centers the chunk touched, in the JAX package's order of operations
   (:127-150 there): the decayed running mean of all each center absorbed.

A chunk holds no pad rows in this port (each rank holds only its own rows),
so every row a rank holds is valid: a short last chunk is just shorter.
The initial centers are drawn from the first chunk as ``KMeans`` draws
them (the threefry kernel on the card). The carry (centers, counts, shift)
lives on the host; save, restore and continue equals the uninterrupted
stream bit for bit on the same chunks.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from ..cluster._kcluster import _KCluster, _d2
from ..cluster.cuda_lloyd import lloyd_update, lloyd_update_plain, pallas_lloyd_applicable
from ..cluster.kmeans import _lloyd_window
from ..core import program_cache, types
from ..core.dndarray import DNDarray
from . import events

__all__ = ["MiniBatchKMeans"]


def _onehot_sums(xb: torch.Tensor, labels: torch.Tensor, k: int):
    """Per-center counts (k,) and sums (k, d) of the rows by label: the
    one-hot product in full f32 (TF32 off for it, restored after). A GEMM
    sums in a fixed order, so two runs agree bit for bit on the card."""
    onehot = (labels[:, None] == torch.arange(k, device=xb.device)[None, :]).to(xb.dtype)
    counts = onehot.sum(dim=0)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        sums = onehot.T @ xb
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return counts, sums


def _fold_chunk(xb: torch.Tensor, c0: torch.Tensor, cnt0: torch.Tensor, shift: float,
                inner_iter: int, tol: float, decay: float, comm, update):
    """One chunk folded into the carry (the registry program of site
    ``streaming.minibatch_kmeans``): ``(centers, counts, shift, inertia)``."""
    k = c0.shape[0]
    # (1) the carried Lloyd window on this chunk, over this rank's rows
    c_ref, _, shift = _lloyd_window(xb, c0, shift, inner_iter, tol, comm, update, xb.shape[0])
    # (2) the hard assignment against the refined centers
    d2 = _d2(xb, c_ref)
    labels = torch.argmin(d2, dim=1)
    c_b, s_b = _onehot_sums(xb, labels, k)
    inertia = d2.min(dim=1).values.sum() if d2.shape[0] else xb.new_zeros(())
    if comm is not None:
        comm.allreduce(c_b)
        comm.allreduce(s_b)
        inertia = comm.allreduce(inertia.reshape(1)).reshape(())
    # (3) the decayed-count blend into the running centers
    decay = torch.tensor(decay, dtype=xb.dtype, device=xb.device)
    cnt = decay * cnt0 + c_b
    blended = ((decay * cnt0)[:, None] * c0 + s_b) / torch.clamp(cnt, min=1e-12)[:, None]
    c_new = torch.where(c_b[:, None] > 0, blended, c0)
    return c_new, cnt, shift, inertia


class MiniBatchKMeans(_KCluster):
    """Online K-Means over a chunked stream.

    Parameters
    ----------
    n_clusters : int
    init : 'random' | 'probability_based' | DNDarray
        Initial centers, drawn from the first chunk.
    inner_iter : int
        The Lloyd window a chunk (at most; it ends early once the carried
        shift is no longer above ``tol``).
    tol : float
        Threshold on the squared center shift carry.
    decay : float
        Count decay a chunk in (0, 1]: 1.0 is the exact running mean,
        smaller values forget old chunks geometrically.
    random_state : int, optional
    """

    def __init__(
        self,
        n_clusters: int = 8,
        init: Union[str, DNDarray] = "random",
        inner_iter: int = 3,
        tol: float = 0.0,
        decay: float = 1.0,
        random_state: Optional[int] = None,
    ):
        super().__init__("euclidean", n_clusters, init, inner_iter, tol, random_state)
        if not 0.0 < decay <= 1.0:
            raise ValueError(f"decay must be in (0, 1], got {decay}")
        self.inner_iter = int(inner_iter)
        self.decay = float(decay)
        self._centers_np: Optional[np.ndarray] = None
        self._counts_np: Optional[np.ndarray] = None
        self._shift = float("inf")
        self.chunks_seen = 0
        self.rows_seen = 0
        # the Lloyd pass of the window: None picks the kernel inside its gate;
        # set to cluster.cuda_lloyd.lloyd_update_plain to run the plain version
        self._update = None

    def partial_fit(self, x: DNDarray) -> "MiniBatchKMeans":
        """Fold one chunk into (centers, counts, shift)."""
        if not isinstance(x, DNDarray):
            raise TypeError(f"input needs to be a DNDarray, but was {type(x)}")
        if x.ndim != 2:
            raise ValueError("input needs to be 2D")
        dt = types.promote_types(x.dtype, types.float32)
        xb = x.larray.to(dt.torch_type())
        if x.split not in (None, 0):
            xb = x._global().to(dt.torch_type())
        k = self.n_clusters
        if self._centers_np is None:
            init = self._initialize_cluster_centers(x).to(xb.dtype)
            self._centers_np = init.cpu().numpy()
            self._counts_np = np.zeros((k,), dtype=self._centers_np.dtype)
            self._shift = float("inf")
        elif self._centers_np.shape[1] != xb.shape[1]:
            raise ValueError(f"partial_fit chunk has {xb.shape[1]} feature columns but the "
                             f"carried centers hold {self._centers_np.shape[1]}")
        c0 = torch.from_numpy(self._centers_np).to(device=xb.device, dtype=xb.dtype)
        cnt0 = torch.from_numpy(self._counts_np).to(device=xb.device, dtype=xb.dtype)
        # only a row-split chunk sums its ranks' rows
        comm = x.comm if x.split == 0 and x.comm.size > 1 else None
        update = self._update
        if update is None:
            gated = pallas_lloyd_applicable(x.comm.size, x.split, x.shape[1], k, xb.dtype)
            update = lloyd_update if gated else lloyd_update_plain
        c_new, cnt, shift, inertia = program_cache.cached_program(
            "streaming.minibatch_kmeans", (k, self.inner_iter, tuple(xb.shape), str(xb.dtype)),
            lambda: _fold_chunk, comm=x.comm, inline=True)(
            xb, c0, cnt0, self._shift, self.inner_iter, self.tol, self.decay, comm, update)
        self._centers_np = c_new.cpu().numpy()
        self._counts_np = cnt.cpu().numpy()
        self._shift = float(shift)
        self._inertia = float(inertia)
        self.chunks_seen += 1
        self.rows_seen += int(x.shape[0])
        self._cluster_centers = DNDarray(c_new, tuple(c_new.shape), dt, None, x.device, x.comm,
                                         True)
        return self

    def save(self, path: str) -> str:
        """Checkpoint the carry (centers, counts, shift): the same substrate
        and resume contract as the checkpointed ``KMeans``. Every rank calls
        it; rank 0 writes."""
        from .. import resilience

        if self._centers_np is None:
            raise RuntimeError("nothing to checkpoint: no chunk seen yet")
        out = resilience.save_checkpoint(
            [self._centers_np, self._counts_np], path,
            extra={"algo": "minibatch_kmeans", "shift": float(self._shift),
                   "chunks_seen": int(self.chunks_seen), "rows_seen": int(self.rows_seen),
                   "decay": float(self.decay), "inner_iter": int(self.inner_iter),
                   "tol": float(self.tol)})
        events.emit("minibatch_kmeans", "checkpoint", path=path, rows_seen=self.rows_seen,
                    chunks=self.chunks_seen)
        return out

    @classmethod
    def restore(cls, path: str) -> "MiniBatchKMeans":
        """The estimator saved at ``path`` (by either package)."""
        from .. import resilience

        leaves, extra = resilience.load_checkpoint(path, with_extra=True)
        if (extra or {}).get("algo") != "minibatch_kmeans" or len(leaves) != 2:
            raise resilience.CheckpointError(
                f"{path!r} is a {(extra or {}).get('algo')!r} checkpoint, not minibatch_kmeans")
        centers = np.asarray(leaves[0])
        est = cls(n_clusters=centers.shape[0], inner_iter=int(extra.get("inner_iter", 3)),
                  tol=float(extra.get("tol", 0.0)), decay=float(extra.get("decay", 1.0)))
        est._centers_np = centers
        est._counts_np = np.asarray(leaves[1])
        est._shift = float(extra["shift"])
        est.chunks_seen = int(extra.get("chunks_seen", 0))
        est.rows_seen = int(extra.get("rows_seen", 0))
        events.emit("minibatch_kmeans", "resume", path=path, rows_seen=est.rows_seen,
                    chunks=est.chunks_seen)
        return est
