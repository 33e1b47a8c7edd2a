"""Admission control: shed before running out of memory, degrade before
shedding.

Counterpart of ``heat_tpu/serve/admission.py``. Every ``Server.submit``
runs :meth:`AdmissionController.admit` before the request enters the
queue, so overload surfaces as an immediate 503-style
:class:`ServerOverloadedError` at the front door.

Two gates:

* **queue depth**: ``HEAT_TPU_SERVE_QUEUE_MAX`` (default 1024) pending
  requests; past it every submit sheds with ``reason="queue_full"``;
* **memory budget**: with ``HEAT_TPU_HBM_BUDGET`` set, the projected bytes
  of dispatching the request at the current ladder bucket (the bytes a
  warmed bucket's build measured, through
  :func:`heat_tpu_torch.resilience.memory_guard.program_bytes`, else the
  endpoint's analytic estimate) are held against the headroom of
  :func:`heat_tpu_torch.resilience.memory_guard.headroom` (live bytes on
  the card). On projected overflow the controller first **degrades**: the
  ladder cap halves until a bucket fits; only when even the smallest
  bucket cannot fit does the request shed with ``reason="memory"``.
  Headroom under half the budget releases the cap.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional

from .. import _knobs as knobs
from .. import telemetry
from ..resilience import memory_guard

__all__ = [
    "ServeError",
    "ServerOverloadedError",
    "ServerClosedError",
    "AdmissionController",
]

DEFAULT_QUEUE_MAX = 1024


class ServeError(RuntimeError):
    """Base class for serving-front-end errors."""


class ServerOverloadedError(ServeError):
    """Request shed by admission control (HTTP-503 analog). Carries
    ``status`` (always 503), ``reason`` (``"queue_full"`` | ``"memory"``
    | ``"draining"``) and ``endpoint``."""

    status = 503

    def __init__(self, message: str, *, reason: str, endpoint: str):
        self.reason = reason
        self.endpoint = endpoint
        super().__init__(message)


class ServerClosedError(ServeError):
    """Submit after close, or the server shut down with the request
    pending."""


def _queue_max() -> int:
    v = knobs.get("HEAT_TPU_SERVE_QUEUE_MAX")
    return v if v > 0 else DEFAULT_QUEUE_MAX


class AdmissionController:
    """Front-door gate + batch-ladder degradation state for one server.

    ``measured_cost`` maps ``(endpoint_name, bucket) -> bytes`` from the
    server's warm-up measurements; buckets never warmed fall back to the
    endpoint's analytic :meth:`~.endpoints.Endpoint.cost_bytes`.
    """

    def __init__(
        self,
        queue_max: Optional[int] = None,
        *,
        measured_cost: Optional[Callable[[str, int], Optional[int]]] = None,
        live_ttl: float = 0.010,
    ):
        self.queue_max = (
            queue_max if queue_max is not None
            else _queue_max()
        )
        self._measured_cost = measured_cost
        self._lock = threading.Lock()
        self._cap: Optional[int] = None  # degraded ladder cap (None = full)
        # at serving rates many submits land inside one batch window, so
        # the (budget, live) reading is memoized for ``live_ttl`` seconds:
        # admission is a projection, not an allocator. 0 disables.
        self.live_ttl = live_ttl
        self._headroom_cached = (None, 0)
        self._headroom_ts = float("-inf")
        self.sheds = 0
        self.degrades = 0

    # -- ladder state --------------------------------------------------------

    def bucket_cap(self, ladder: List[int]) -> int:
        """The largest ladder bucket currently allowed (degradation
        clamps it)."""
        cap = self._cap
        top = ladder[-1]
        return top if cap is None else min(cap, top)

    def _degrade_to(self, cap: int, endpoint: str) -> None:
        with self._lock:
            if self._cap is not None and self._cap <= cap:
                return
            self._cap = cap
            self.degrades += 1
        if telemetry.enabled():
            reg = telemetry.get_registry()
            reg.add("serve.degraded", 1)
            reg.emit("serve", endpoint, event="degrade", bucket_cap=cap)

    def _release(self) -> None:
        with self._lock:
            if self._cap is None:
                return
            self._cap = None
        if telemetry.enabled():
            reg = telemetry.get_registry()
            reg.emit("serve", "ladder", event="degrade_release")

    def shed(self, endpoint: str, reason: str, message: str) -> None:
        """Count + emit one shed and raise the 503-style error. Public:
        the server routes its own shed reasons (``"draining"``) through
        here so every shed carries the same telemetry."""
        with self._lock:
            self.sheds += 1
        if telemetry.enabled():
            reg = telemetry.get_registry()
            reg.add("serve.shed", 1)
            reg.emit("serve", endpoint, event="shed", reason=reason)
        raise ServerOverloadedError(message, reason=reason, endpoint=endpoint)

    # -- the gate ------------------------------------------------------------

    def _headroom(self):
        """``memory_guard.headroom()`` memoized for ``live_ttl`` seconds."""
        if self.live_ttl <= 0:
            return memory_guard.headroom()
        now = time.monotonic()
        with self._lock:
            if now - self._headroom_ts <= self.live_ttl:
                return self._headroom_cached
        reading = memory_guard.headroom()
        with self._lock:
            self._headroom_cached = reading
            self._headroom_ts = now
        return reading

    def _cost(self, name: str, ep, bucket: int) -> int:
        if self._measured_cost is not None:
            m = self._measured_cost(name, bucket)
            if m:
                return m
        return ep.cost_bytes(bucket)

    def admit(
        self, name: str, ep, rows: int, queue_depth: int, ladder: List[int]
    ) -> None:
        """Raise :class:`ServerOverloadedError` or return (admitted).
        Degradation is a side effect: the ladder cap the batcher reads
        may shrink (or recover) here."""
        if queue_depth >= self.queue_max:
            self.shed(
                name, "queue_full",
                f"serve queue is full ({queue_depth} >= "
                f"{self.queue_max} pending requests); retry later or raise "
                f"HEAT_TPU_SERVE_QUEUE_MAX",
            )
        budget, live = self._headroom()
        if budget is None:
            return
        cap = self.bucket_cap(ladder)
        bucket = next((b for b in ladder if b >= min(rows, cap)), cap)
        need = self._cost(name, ep, bucket)
        if live + need <= budget:
            if self._cap is not None and live + need < budget // 2:
                self._release()
            return
        # degrade: walk the ladder down until a bucket's projected cost
        # fits — smaller batches, smaller temporaries, same answers
        for b in reversed([b for b in ladder if b < bucket]):
            if live + self._cost(name, ep, b) <= budget:
                self._degrade_to(b, name)
                return
        self.shed(
            name, "memory",
            f"projected dispatch cost {need:,} B on top of {live:,} B live "
            f"exceeds HEAT_TPU_HBM_BUDGET {budget:,} B even at the smallest "
            f"batch bucket; shedding before OOM",
        )
