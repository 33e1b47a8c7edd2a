"""Fault injection, the guarded dispatch, the memory budget, and
checkpoint and restore.

Counterpart of ``heat_tpu/resilience/__init__.py``:

- :mod:`.faults`: the seeded fault injector (``HEAT_TPU_FAULTS`` or
  :func:`inject`);
- :mod:`.guard`: :func:`guarded_call`, transient-or-permanent
  classification, capped exponential backoff (``HEAT_TPU_RETRIES``),
  escalation to :class:`HeatTpuRuntimeError`;
- :mod:`.memory_guard`: the ``HEAT_TPU_HBM_BUDGET`` budget, ``headroom``,
  ``temp_budget``, ``program_bytes`` and ``preflight``;
- :mod:`.checkpoint`: per-leaf ``.npy`` blobs with a JSON manifest and
  CRC32, an atomic directory swap, in the JAX package's format.

None of the dispatch machinery runs until the package is **armed**
(retries requested, a fault rule installed, or a budget set): disarmed,
a program of the registry (:mod:`heat_tpu_torch.core.program_cache`) pays
one flag check a call. :func:`refresh` recomputes the flag; it runs at
import, at :func:`inject` and :func:`clear_faults`, and after a test
changes those variables.
"""

from __future__ import annotations

import warnings

from . import checkpoint, faults, guard, memory_guard
from .checkpoint import CheckpointCorruptError, CheckpointError, load_checkpoint, save_checkpoint
from .faults import clear as clear_faults
from .faults import inject
from .guard import guarded_call
from .memory_guard import HeatTpuMemoryError, HeatTpuRuntimeError

__all__ = [
    "CheckpointCorruptError",
    "CheckpointError",
    "HeatTpuMemoryError",
    "HeatTpuRuntimeError",
    "armed",
    "checkpoint",
    "clear_faults",
    "faults",
    "guard",
    "guarded_call",
    "inject",
    "load_checkpoint",
    "memory_guard",
    "refresh",
    "save_checkpoint",
    "stats",
    "wrap_program",
]

# the dispatch's one flag: False, a wrapped program is a plain call
_ARMED = False


def armed() -> bool:
    """Whether retries, fault rules or a memory budget are active."""
    return _ARMED


def refresh() -> bool:
    """Recompute the armed flag from the rule table and the environment
    (``HEAT_TPU_RETRIES``, ``HEAT_TPU_HBM_BUDGET``)."""
    global _ARMED
    _ARMED = (faults.active() or guard.max_retries() > 0
              or memory_guard.budget_bytes() is not None)
    return _ARMED


def wrap_program(site: str, fn, *, donated: bool = False):
    """Wrap one program with the resilience dispatch: disarmed, one flag
    check and a tail call; armed, the memory preflight and the retry
    guard. Called once per registry miss, so a hit returns the wrapped
    callable and pays no wrapping. ``__wrapped__`` is the program."""

    def call(*args, **kwargs):
        if not _ARMED:
            return fn(*args, **kwargs)
        if not kwargs and memory_guard.budget_bytes() is not None:
            memory_guard.preflight(site, fn, args)
        return guard.guarded_call(site, fn, args, kwargs, donated=donated)

    call.__wrapped__ = fn
    return call


def stats() -> dict:
    """The armed flag, the retry budget, the fault rules and injections,
    and the memory budget."""
    return {"armed": _ARMED, "retries": guard.max_retries(), "faults": faults.stats(),
            "hbm_budget": memory_guard.budget_bytes()}


# HEAT_TPU_FAULTS installs its rules at import; HEAT_TPU_RETRIES and
# HEAT_TPU_HBM_BUDGET arm their features the same way
_spec = faults.env_spec()
if _spec:
    try:
        faults.install_spec(_spec)
    except ValueError as _e:
        warnings.warn(f"heat_tpu_torch.resilience: ignoring malformed HEAT_TPU_FAULTS spec ({_e})")
del _spec
refresh()
