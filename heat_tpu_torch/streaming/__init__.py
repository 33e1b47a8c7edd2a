"""Online estimators and out-of-core ingestion.

Counterpart of ``heat_tpu/streaming``:

- :class:`ChunkStream` walks ``.npy``/HDF5 files in row blocks sized from
  the memory budget, each rank reading only its own slab of a block;
- :class:`StreamingMoments` (one launch of the moments kernel a chunk,
  behind a float64 Chan-mergeable carry) and :class:`MiniBatchKMeans` (the
  Lloyd window on the Lloyd kernel, with a decayed-count blend); both
  checkpoint and resume their carries bit for bit through
  ``resilience.checkpoint``, in the JAX package's format;
- :func:`rolling_update` rolls a new checkpoint through a replica pool.

``Server.publish`` and the replica pool it needs come with the serving tier
(ROADMAP §1 item 14).
"""

from __future__ import annotations

from .chunks import ChunkStream
from .events import EVENT_COUNTER, emit
from .minibatch import MiniBatchKMeans
from .moments import StreamingMoments
from .publish import rolling_update

__all__ = ["ChunkStream", "EVENT_COUNTER", "MiniBatchKMeans", "StreamingMoments", "emit",
           "rolling_update"]
