"""Serving latency and occupancy accounting.

Counterpart of ``heat_tpu/serve/metrics.py`` (pure Python, the same
bucket geometry, so histograms of either package merge). A serving front
end needs cheap online aggregates it can report while telemetry is off:
per-endpoint request counts, shed and error tallies, batch occupancy and
latency percentiles. :class:`LatencyHistogram` is a fixed-size
log-bucketed histogram (10 µs … ~460 s, 1.25× growth): O(1) record,
O(buckets) quantile, no allocation a request. Percentiles interpolate
inside the winning bucket, so p50/p95/p99 are within one bucket width
(≤ 25%) of exact.
"""

from __future__ import annotations

import math
import threading
import time
from typing import List, Optional

__all__ = ["LatencyHistogram", "EndpointStats"]

# bucket i covers (BASE*GROWTH^(i-1), BASE*GROWTH^i]; bucket 0 covers
# [0, BASE]. 80 buckets reach BASE*1.25^79 ≈ 459 s — beyond any sane SLO.
_BASE = 1e-5
_GROWTH = 1.25
_NBUCKETS = 80
_LOG_GROWTH = math.log(_GROWTH)


class LatencyHistogram:
    """Log-bucketed latency histogram with quantile estimation."""

    __slots__ = ("counts", "count", "total", "min", "max")

    def __init__(self):
        self.counts: List[int] = [0] * _NBUCKETS
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = 0.0

    def record(self, seconds: float) -> None:
        if seconds < 0:
            seconds = 0.0
        if seconds <= _BASE:
            i = 0
        else:
            i = min(
                _NBUCKETS - 1,
                1 + int(math.log(seconds / _BASE) / _LOG_GROWTH),
            )
        self.counts[i] += 1
        self.count += 1
        self.total += seconds
        if seconds < self.min:
            self.min = seconds
        if seconds > self.max:
            self.max = seconds

    def quantile(self, q: float) -> Optional[float]:
        """Estimated ``q``-quantile in seconds (linear interpolation inside
        the winning bucket, clamped to the observed min/max). None when
        empty."""
        if self.count == 0:
            return None
        target = q * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if seen + c >= target:
                lo = 0.0 if i == 0 else _BASE * _GROWTH ** (i - 1)
                hi = _BASE * _GROWTH ** i
                frac = (target - seen) / c
                est = lo + (hi - lo) * frac
                return max(self.min, min(self.max, est))
            seen += c
        return self.max

    def snapshot(self) -> dict:
        if self.count == 0:
            return {"count": 0}
        return {
            "count": self.count,
            "mean_s": self.total / self.count,
            "min_s": self.min,
            "max_s": self.max,
            "p50_s": self.quantile(0.50),
            "p95_s": self.quantile(0.95),
            "p99_s": self.quantile(0.99),
        }

    # -- the merge contract ---------------------------------------------------
    # Two histograms with the same (base, growth, nbuckets) merge exactly by
    # bucket-wise addition: a sample's bucket depends on its value alone, so
    # the merged counts equal those of one histogram fed both sample sets.
    # raw() / from_raw() are the wire form (GET /metrics ships raw counts).

    def raw(self) -> dict:
        """Wire-form snapshot: the raw bucket counts plus the scalar
        moments, tagged with the bucket geometry so a merger can refuse
        a mismatched histogram instead of silently mis-binning."""
        return {
            "base": _BASE,
            "growth": _GROWTH,
            "counts": list(self.counts),
            "count": self.count,
            "total": self.total,
            "min": self.min if self.count else None,
            "max": self.max if self.count else None,
        }

    @classmethod
    def from_raw(cls, raw: dict) -> "LatencyHistogram":
        """Inverse of :meth:`raw` (ValueError on bucket-geometry drift)."""
        if (
            float(raw.get("base", _BASE)) != _BASE
            or float(raw.get("growth", _GROWTH)) != _GROWTH
            or len(raw.get("counts", ())) != _NBUCKETS
        ):
            raise ValueError(
                "histogram bucket geometry mismatch: expected "
                f"base={_BASE} growth={_GROWTH} nbuckets={_NBUCKETS}, got "
                f"base={raw.get('base')} growth={raw.get('growth')} "
                f"nbuckets={len(raw.get('counts', ()))}"
            )
        h = cls()
        h.counts = [int(c) for c in raw["counts"]]
        h.count = int(raw.get("count", sum(h.counts)))
        h.total = float(raw.get("total", 0.0))
        if raw.get("min") is not None:
            h.min = float(raw["min"])
        if raw.get("max") is not None:
            h.max = float(raw["max"])
        return h

    def merge(self, other: "LatencyHistogram") -> "LatencyHistogram":
        """Bucket-wise in-place merge (the exact aggregation contract);
        returns ``self``."""
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.count += other.count
        self.total += other.total
        if other.count:
            if other.min < self.min:
                self.min = other.min
            if other.max > self.max:
                self.max = other.max
        return self


class EndpointStats:
    """Per-endpoint serving aggregates: request/row/batch tallies, shed
    and error counts, pad overhead, and the latency histogram. All
    mutation goes through the instance lock — the submit path and the
    batcher thread both write here.

    Scrape contract: every tally is **cumulative since
    ``window_start``** (a monotonic-clock stamp taken at construction)
    and is never reset. A scraper derives windowed rates entirely on its
    own side — ``(cur.requests - prev.requests) / (cur.mono -
    prev.mono)`` — so two consecutive scrapes can never race a reset
    (there is none), and K scrapers each keep their own window without
    perturbing each other or the autoscaler.
    """

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self.window_start = time.monotonic()
        self.requests = 0
        self.rows = 0
        self.batches = 0
        self.dispatched_rows = 0
        self.padded_rows = 0
        self.shed = 0
        self.errors = 0
        self.latency = LatencyHistogram()

    def record_request(self, rows: int) -> None:
        with self._lock:
            self.requests += 1
            self.rows += rows

    def record_shed(self) -> None:
        with self._lock:
            self.shed += 1

    def record_batch(self, rows: int, padded: int) -> None:
        with self._lock:
            self.batches += 1
            self.dispatched_rows += rows
            self.padded_rows += padded

    def record_done(self, seconds: float) -> None:
        with self._lock:
            self.latency.record(seconds)

    def record_error(self, n: int = 1) -> None:
        with self._lock:
            self.errors += n

    def snapshot(self) -> dict:
        with self._lock:
            out = {
                "requests": self.requests,
                "rows": self.rows,
                "batches": self.batches,
                "shed": self.shed,
                "errors": self.errors,
                "padded_rows": self.padded_rows,
                "latency": self.latency.snapshot(),
                "window_start": self.window_start,
                "mono": time.monotonic(),
            }
            if self.batches:
                out["mean_batch_rows"] = self.dispatched_rows / self.batches
                denom = self.dispatched_rows + self.padded_rows
                out["occupancy"] = (
                    self.dispatched_rows / denom if denom else 1.0
                )
            return out

    def raw_snapshot(self) -> dict:
        """The ``GET /metrics`` form: cumulative tallies plus the RAW
        latency bucket counts (mergeable bucket-wise, unlike the
        quantized quantiles in :meth:`snapshot`), stamped with
        ``window_start``/``mono`` so scrapers derive windowed rates
        without any server-side reset."""
        with self._lock:
            return {
                "requests": self.requests,
                "rows": self.rows,
                "batches": self.batches,
                "dispatched_rows": self.dispatched_rows,
                "padded_rows": self.padded_rows,
                "shed": self.shed,
                "errors": self.errors,
                "window_start": self.window_start,
                "mono": time.monotonic(),
                "latency_raw": self.latency.raw(),
            }
