"""Guarded dispatch: classify, retry, escalate.

Counterpart of ``heat_tpu/resilience/guard.py``. While the resilience
package is armed, every execution of a program of the registry
(:mod:`heat_tpu_torch.core.program_cache`) runs through
:func:`guarded_call`, which

* asks the fault injector first, so a synthetic fault lands before the
  program runs and a retry replays the program already built (a CUDA
  graph is replayed, never captured again);
* classifies an exception as **transient** (the injector's faults,
  ``torch.cuda.OutOfMemoryError`` and other "out of memory" messages,
  connection resets, RPC-style deadline and availability errors) or
  **permanent** (everything else, which propagates unchanged);
* retries a transient fault up to ``HEAT_TPU_RETRIES`` times with capped
  exponential backoff and deterministic jitter (``HEAT_TPU_RETRY_BASE``,
  ``HEAT_TPU_RETRY_CAP``);
* escalates an exhausted transient to :class:`HeatTpuRuntimeError`, with
  the site, every attempt and remedies, after flushing telemetry.

A donated program (``donated=True``: one that changes state in place, an
optimizer step or a merge into parameters) is retried only when the fault
came before it ran (the injector's faults): a transient fault raised while
it runs escalates at once, so no update is ever applied twice.

A sticky CUDA error (an illegal memory access, a device-side assert, an
unspecified launch failure, a misaligned address, an illegal instruction)
leaves the CUDA context unusable: every later call fails the same way. It
is permanent, and it is matched before the transient markers, because
such messages can carry words the transient markers look for.
"""

from __future__ import annotations

import time
import zlib
from typing import Any, Callable, Dict, List, Optional

from .. import _knobs as knobs
from .. import telemetry
from . import faults
from .memory_guard import HeatTpuRuntimeError

__all__ = ["HeatTpuRuntimeError", "classify", "guarded_call", "max_retries"]

DEFAULT_BASE = 0.05  # seconds; first backoff
DEFAULT_CAP = 2.0    # seconds; backoff ceiling


def max_retries() -> int:
    """``HEAT_TPU_RETRIES``, read now (0: retries off)."""
    return max(0, int(knobs.get("HEAT_TPU_RETRIES")))


def _backoff_base() -> float:
    return float(knobs.get("HEAT_TPU_RETRY_BASE"))


def _backoff_cap() -> float:
    return float(knobs.get("HEAT_TPU_RETRY_CAP"))


# lower-case substrings of str(exc): the JAX package's transient markers
# (XLA's allocator and RPC status codes, transport resets), which also
# cover torch's "CUDA out of memory"
_TRANSIENT_MARKERS = (
    "resource_exhausted",
    "resource exhausted",
    "out of memory",
    "connection reset",
    "connection aborted",
    "socket closed",
    "deadline_exceeded",
    "deadline exceeded",
    "unavailable",
    "aborted",
)

# a deleted or donated buffer never comes back
_PERMANENT_MARKERS = ("deleted", "donated")

# CUDA errors that poison the context: retrying repeats the failure
_STICKY_CUDA_MARKERS = (
    "illegal memory access",
    "device-side assert",
    "unspecified launch failure",
    "misaligned address",
    "illegal instruction",
    "hardware stack error",
    "invalid program counter",
)


def classify(exc: BaseException) -> str:
    """``"transient"`` or ``"permanent"`` for one exception."""
    if isinstance(exc, faults.InjectedFault):
        return "transient"
    if isinstance(exc, (ConnectionResetError, ConnectionAbortedError)):
        return "transient"
    msg = str(exc).lower()
    if any(m in msg for m in _STICKY_CUDA_MARKERS):
        return "permanent"
    if any(m in msg for m in _PERMANENT_MARKERS):
        return "permanent"
    if isinstance(exc, (RuntimeError, OSError)) and any(m in msg for m in _TRANSIENT_MARKERS):
        return "transient"
    return "permanent"


def _sleep_backoff(site: str, attempt: int) -> None:
    base = _backoff_base()
    if base <= 0:
        return
    delay = min(_backoff_cap(), base * (2.0 ** attempt))
    # deterministic jitter in [0.75, 1.25) of the nominal delay
    u = zlib.crc32(f"{site}:{attempt}".encode()) / 2**32
    time.sleep(delay * (0.75 + 0.5 * u))


def _hints_for(site: str, last: BaseException, donated: bool) -> List[str]:
    hints = []
    msg = str(last).lower()
    if "resource" in msg or "memory" in msg:
        hints.append("reduce operand size or set HEAT_TPU_HBM_BUDGET to pre-flight allocations")
    if donated:
        hints.append(f"site {site!r} changes state in place; a fault while it ran cannot be "
                     "replayed: restore the state (a checkpoint) and re-dispatch")
    hints.append("raise HEAT_TPU_RETRIES / HEAT_TPU_RETRY_CAP for flakier substrates")
    return hints


def _give_up(site: str, attempts: list, e: BaseException) -> None:
    if telemetry.enabled():
        reg = telemetry.get_registry()
        reg.add("resilience.gave_up", 1)
        reg.emit("resilience", site, event="gave_up", attempts=len(attempts), error=repr(e))
        telemetry.flush("escalation")


def guarded_call(site: str, fn: Callable, args: tuple = (),
                 kwargs: Optional[Dict[str, Any]] = None, *, donated: bool = False):
    """``fn(*args, **kwargs)`` under the fault injector and the retry
    policy: the result; a permanent first-attempt error unchanged; an
    exhausted transient (or a permanent error mid-retry) as
    :class:`HeatTpuRuntimeError`."""
    kwargs = kwargs or {}
    retries = max_retries()
    attempts: List[dict] = []
    attempt = 0
    injector_on = faults.active()
    while True:
        ran = False
        try:
            directive = faults.check(site) if injector_on else None
            ran = True
            out = fn(*args, **kwargs)
        except Exception as e:  # noqa: BLE001 - classification decides
            cls = classify(e)
            attempts.append({"attempt": attempt, "error": repr(e), "classification": cls})
            if cls == "transient" and donated and ran:
                _give_up(site, attempts, e)
                raise HeatTpuRuntimeError(
                    f"transient fault at site {site!r} while its in-place update ran; not "
                    f"retried, so the update is not applied twice: {e!r}",
                    site=site, attempts=attempts, hints=_hints_for(site, e, donated)) from e
            if cls != "transient":
                if attempt == 0:
                    raise  # the existing error contracts hold
                _give_up(site, attempts, e)
                raise HeatTpuRuntimeError(
                    f"retry of site {site!r} hit a permanent error after "
                    f"{len(attempts) - 1} transient failure(s): {e!r}",
                    site=site, attempts=attempts, hints=_hints_for(site, e, donated)) from e
            if telemetry.enabled():
                telemetry.get_registry().add("resilience.transient_faults", 1)
            if attempt >= retries:
                _give_up(site, attempts, e)
                raise HeatTpuRuntimeError(
                    f"transient fault at site {site!r} persisted through {len(attempts)} "
                    f"attempt(s) (HEAT_TPU_RETRIES={retries}); last error: {e!r}",
                    site=site, attempts=attempts, hints=_hints_for(site, e, donated)) from e
            if telemetry.enabled():
                reg = telemetry.get_registry()
                reg.add("resilience.retries", 1)
                reg.emit("resilience", site, event="retry", attempt=attempt, error=repr(e))
            _sleep_backoff(site, attempt)
            attempt += 1
            continue
        if directive == "nan":
            out = _corrupt_nan(out)
        return out


def _corrupt_nan(out):
    """Every floating tensor of ``out`` (a tensor, or a tuple or list of
    them) times NaN: the injected silent-corruption fault."""
    import torch

    def poison(x):
        if isinstance(x, torch.Tensor) and (x.is_floating_point() or x.is_complex()):
            return x * float("nan")
        return x

    if isinstance(out, (tuple, list)):
        return type(out)(poison(x) for x in out)
    return poison(out)
