"""The device memory budget (``HEAT_TPU_HBM_BUDGET``) and the byte budget
of one kernel's temporaries.

Counterpart of ``heat_tpu/resilience/memory_guard.py``: :func:`budget_bytes`
(``_parse_budget``'s K/M/G/T suffixes, :79-110 there), :func:`headroom` and
:func:`temp_budget` (:227-234: a quarter of the budget, at most
``1 << 28`` and at least 1 MiB; ``1 << 28`` with no budget). The cap of
256 MiB is the JAX package's rule and is kept on the card too, although an
H100 has 80 GB: it sizes ``streaming.ChunkStream``'s chunks.

Live bytes are ``torch.cuda.memory_allocated()`` of the current card. On
the CPU the port does not account its allocations, so live bytes are 0
there.

Not ported yet (ROADMAP §1 item 13): ``preflight`` and ``program_bytes``,
which read XLA's compiled memory analysis, and the degradation ladder
around them.
"""

from __future__ import annotations

import re
from typing import Optional, Tuple

from .. import _knobs as knobs

__all__ = [
    "HeatTpuMemoryError",
    "HeatTpuRuntimeError",
    "budget_bytes",
    "headroom",
    "live_bytes",
    "temp_budget",
]


class HeatTpuRuntimeError(RuntimeError):
    """A dispatch failed for good. Carries the ``site`` that failed, the
    ``attempts`` made and ``hints`` for the remedy (also in the message);
    the JAX package's ``resilience.guard`` error, which that module's port
    will raise."""

    def __init__(self, message: str, *, site: Optional[str] = None,
                 attempts: Optional[list] = None, hints: Optional[list] = None):
        self.site = site
        self.attempts = list(attempts or [])
        self.hints = list(hints or [])
        if self.hints:
            message = message + "\n  remediation: " + "; ".join(self.hints)
        super().__init__(message)


class HeatTpuMemoryError(HeatTpuRuntimeError):
    """The memory budget cannot hold what was asked of it."""


_SUFFIX = {"k": 1 << 10, "m": 1 << 20, "g": 1 << 30, "t": 1 << 40}
_BUDGET_RE = re.compile(r"^(\d+(?:\.\d+)?)\s*([kmgt]?)i?b?$")


def _parse_budget(raw: str) -> Optional[int]:
    m = _BUDGET_RE.match(raw.strip().lower().replace("_", ""))
    if not m:
        return None
    val = float(m.group(1)) * _SUFFIX.get(m.group(2), 1)
    return int(val) if val > 0 else None


def budget_bytes() -> Optional[int]:
    """The budget in bytes from ``HEAT_TPU_HBM_BUDGET`` (plain bytes or
    K/M/G/T suffixes: ``"512M"``, ``"8G"``, ``"8GiB"``), read now; None when
    unset or malformed."""
    raw = (knobs.raw("HEAT_TPU_HBM_BUDGET", "") or "").strip()
    return _parse_budget(raw) if raw else None


def live_bytes() -> int:
    """Bytes the caching allocator holds for tensors on the current card;
    0 without a card (the CPU's allocations are not accounted)."""
    import torch

    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return 0
    return int(torch.cuda.memory_allocated())


def headroom() -> Tuple[Optional[int], int]:
    """``(budget_bytes, live_bytes)``; live bytes are not read (0) when no
    budget is set."""
    budget = budget_bytes()
    if budget is None:
        return None, 0
    return budget, live_bytes()


def temp_budget(default: int = 1 << 28) -> int:
    """Byte budget of one kernel's temporaries: ``default`` without a
    budget, else a quarter of it, at most ``default`` and at least 1 MiB."""
    b = budget_bytes()
    if b is None:
        return default
    return max(1 << 20, min(default, b // 4))
