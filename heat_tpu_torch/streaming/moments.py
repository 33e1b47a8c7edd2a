"""Online column moments: the moments kernel (K2) behind a Chan-mergeable
carry.

Counterpart of ``heat_tpu/streaming/moments.py``. Each
``partial_fit(chunk)`` is one ``core.statistics.chunk_moments`` call, which
on the card is one launch of the moments kernel (``csrc/moments.cu``; and
the two-allreduce merge across ranks), giving the chunk's
``(n, mean, M2)``; the carry folds it in with ``cuda_moments.chan_merge``,
the formula the kernel applies across its blocks. The carry is float64 on
the host: the merges are deterministic host arithmetic, so a checkpointed
stream resumes bit for bit, and the carry does not depend on the world.

- one-chunk ``partial_fit`` equals ``chunk_moments`` of the chunk;
- K chunks against the moments of the whole: equal within f32 rounding
  (the merges associate otherwise than one pass does);
- save, restore and continue equals the uninterrupted stream bit for bit
  on the same chunks.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..core.cuda_moments import chan_merge
from ..core.dndarray import DNDarray
from ..core.statistics import chunk_moments
from . import events

__all__ = ["StreamingMoments"]


def _host64(t) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float64)


class StreamingMoments:
    """Single-pass streaming mean, var and std over the rows of a chunked
    2-D stream.

    Parameters
    ----------
    ddof : int
        Delta degrees of freedom of :meth:`var`/:meth:`std` (0: population,
        1: sample).
    """

    def __init__(self, ddof: int = 0):
        self.ddof = int(ddof)
        self.n_seen = 0.0  # float64: exact for any real row count
        self._mean: Optional[np.ndarray] = None  # (d,) float64
        self._m2: Optional[np.ndarray] = None    # (d,) float64
        self.chunks_seen = 0

    def partial_fit(self, x: DNDarray) -> "StreamingMoments":
        """Fold one chunk into the carry: one ``chunk_moments`` (one K2
        launch on the card) and one host-side Chan merge."""
        n, mu, m2 = chunk_moments(x)
        mu, m2 = _host64(mu), _host64(m2)
        if self._mean is None:
            self._mean = np.zeros_like(mu)
            self._m2 = np.zeros_like(m2)
        elif self._mean.shape != mu.shape:
            raise ValueError(f"partial_fit chunk has {mu.shape[0]} features but the carry holds "
                             f"{self._mean.shape[0]}")
        self.n_seen, self._mean, self._m2 = chan_merge(self.n_seen, self._mean, self._m2,
                                                       float(n), mu, m2)
        self.chunks_seen += 1
        return self

    def merge(self, other: "StreamingMoments") -> "StreamingMoments":
        """Combine another stream's carry into this one (shards of a stream
        processed apart merge into one estimate)."""
        if other._mean is None:
            return self
        if self._mean is None:
            self.n_seen = other.n_seen
            self._mean = other._mean.copy()
            self._m2 = other._m2.copy()
            self.chunks_seen += other.chunks_seen
            return self
        self.n_seen, self._mean, self._m2 = chan_merge(self.n_seen, self._mean, self._m2,
                                                       other.n_seen, other._mean, other._m2)
        self.chunks_seen += other.chunks_seen
        return self

    @property
    def mean(self) -> np.ndarray:
        if self._mean is None:
            raise RuntimeError("partial_fit needs at least one chunk")
        return self._mean.copy()

    def var(self, ddof: Optional[int] = None) -> np.ndarray:
        if self._m2 is None:
            raise RuntimeError("partial_fit needs at least one chunk")
        k = self.ddof if ddof is None else int(ddof)
        denom = self.n_seen - k
        if denom <= 0:
            raise ValueError(f"var(ddof={k}) needs more than {k} rows, saw {self.n_seen}")
        return self._m2 / denom

    def std(self, ddof: Optional[int] = None) -> np.ndarray:
        return np.sqrt(self.var(ddof))

    def save(self, path: str) -> str:
        """Checkpoint the carry (``resilience.checkpoint``: CRC-checked
        blobs, an atomic directory swap); the float64 carry round-trips bit
        for bit. Every rank calls it; rank 0 writes."""
        from .. import resilience

        if self._mean is None:
            raise RuntimeError("nothing to checkpoint: no chunk seen yet")
        out = resilience.save_checkpoint(
            [self._mean, self._m2], path,
            extra={"algo": "streaming_moments", "n_seen": float(self.n_seen),
                   "chunks_seen": int(self.chunks_seen), "ddof": int(self.ddof)})
        events.emit("moments", "checkpoint", path=path, rows_seen=float(self.n_seen),
                    chunks=int(self.chunks_seen))
        return out

    @classmethod
    def restore(cls, path: str) -> "StreamingMoments":
        """The estimator saved at ``path`` (by either package)."""
        from .. import resilience

        leaves, extra = resilience.load_checkpoint(path, with_extra=True)
        if (extra or {}).get("algo") != "streaming_moments" or len(leaves) != 2:
            raise resilience.CheckpointError(
                f"{path!r} is a {(extra or {}).get('algo')!r} checkpoint, not streaming_moments")
        est = cls(ddof=int(extra.get("ddof", 0)))
        est._mean = np.asarray(leaves[0], dtype=np.float64)
        est._m2 = np.asarray(leaves[1], dtype=np.float64)
        est.n_seen = float(extra["n_seen"])
        est.chunks_seen = int(extra.get("chunks_seen", 0))
        events.emit("moments", "resume", path=path, rows_seen=est.n_seen,
                    chunks=est.chunks_seen)
        return est
