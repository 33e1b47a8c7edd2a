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

:func:`program_bytes` and :func:`preflight` (:123-224 there) budget one
dispatch of a program of the registry
(:mod:`heat_tpu_torch.core.program_cache`) before it runs: live bytes plus
the program's bytes against the budget. Where the JAX package reads XLA's
memory analysis of the compiled executable, the port reads what the
program's warm build took: on the card, the bytes its CUDA graph's private
pool reserved, measured around the capture; on the CPU, the analytic
``cost_bytes`` its caller registered (the serving endpoints' estimate).
0 means unknown, and the budget then holds live bytes alone. The JAX
package's first rung of degradation, the fusion window, has no counterpart
yet (item 13's fusion); the port collects garbage and measures again.
"""

from __future__ import annotations

import gc
import re
from typing import Optional, Tuple

from .. import _knobs as knobs

__all__ = [
    "HeatTpuMemoryError",
    "HeatTpuRuntimeError",
    "budget_bytes",
    "headroom",
    "live_bytes",
    "preflight",
    "program_bytes",
    "temp_budget",
]


class HeatTpuRuntimeError(RuntimeError):
    """A dispatch failed for good. Carries the ``site`` that failed, the
    ``attempts`` made and ``hints`` for the remedy (also in the message);
    the JAX package's ``resilience.guard`` error, which
    :func:`heat_tpu_torch.resilience.guard.guarded_call` raises."""

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


def program_bytes(fn, args: tuple) -> int:
    """Bytes of one dispatch of the registry program ``fn`` (the wrapped
    callable, or the program itself) on ``args``: what its warm build of
    this signature reserved on the card, or its registered analytic bytes
    on the CPU; 0 when unknown (not built yet, or not a registry program)."""
    program = getattr(fn, "__wrapped__", fn)
    measure = getattr(program, "program_bytes", None)
    return int(measure(args)) if measure is not None else 0


def preflight(site: str, fn, args: tuple) -> None:
    """The budget check before one guarded dispatch: a no-op without a
    budget; when live bytes plus the program's bytes exceed it, collect
    garbage and measure again, then raise :class:`HeatTpuMemoryError`."""
    budget = budget_bytes()
    if budget is None:
        return
    need = program_bytes(fn, args)
    live = live_bytes()
    if live + need <= budget:
        return
    from .. import telemetry

    if telemetry.enabled():
        reg = telemetry.get_registry()
        reg.add("resilience.memory_pressure", 1)
        reg.emit("resilience", site, event="memory_pressure", live_bytes=live,
                 program_bytes=need, budget=budget)
    gc.collect()  # drop dead references that pin device memory
    live = live_bytes()
    if live + need <= budget:
        return
    if telemetry.enabled():
        telemetry.flush("memory_escalation")
    raise HeatTpuMemoryError(
        f"pre-flight memory budget exceeded at site {site!r}: live {live:,} B + program "
        f"{need:,} B > HEAT_TPU_HBM_BUDGET {budget:,} B (after gc)",
        site=site,
        hints=["raise HEAT_TPU_HBM_BUDGET or unset it to disable pre-flight budgeting",
               "shard the operand over more devices (resplit) so the live bytes a card drop",
               "chunk the workload along the batch axis"])
