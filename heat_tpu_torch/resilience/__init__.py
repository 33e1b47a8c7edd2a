"""Checkpoint and restore, and the memory budget.

Counterpart of ``heat_tpu/resilience/__init__.py``. Ported:

- :mod:`.checkpoint`: per-leaf ``.npy`` blobs with a JSON manifest and
  CRC32, an atomic directory swap, in the JAX package's format, consumed by
  ``cluster.KMeans(checkpoint_every=...)`` and the streaming estimators'
  ``save``/``restore``;
- :mod:`.memory_guard`: the ``HEAT_TPU_HBM_BUDGET`` budget, ``headroom``,
  ``temp_budget`` and :class:`HeatTpuMemoryError`, whose base
  :class:`HeatTpuRuntimeError` the guarded dispatch will raise.

Not ported yet (ROADMAP §1 item 13): ``faults`` (fault injection),
``guard`` (guarded retries), ``wrap_program``, ``armed``, ``refresh`` and
``stats``, which hang on the JAX package's program cache.
"""

from __future__ import annotations

from . import checkpoint, memory_guard
from .checkpoint import CheckpointCorruptError, CheckpointError, load_checkpoint, save_checkpoint
from .memory_guard import HeatTpuMemoryError, HeatTpuRuntimeError

__all__ = [
    "CheckpointCorruptError",
    "CheckpointError",
    "HeatTpuMemoryError",
    "HeatTpuRuntimeError",
    "checkpoint",
    "load_checkpoint",
    "memory_guard",
    "save_checkpoint",
]
