"""Fleet-wide observability: metrics merging, SLO accounting, and the
merged cross-process trace.

The port's counterpart of ``heat_tpu/telemetry/cluster.py``: the sensor
plane over a fleet (a :class:`~heat_tpu_torch.serve.net.Router` and N
replica processes, rolled by version), built on three exact contracts:

* **histogram merging is exact** — the per-endpoint latency histograms
  (:class:`heat_tpu_torch.serve.metrics.LatencyHistogram`, the JAX
  package's bucket geometry) are log-bucketed
  with fleet-wide fixed geometry, so bucket-wise addition of K replica
  scrapes yields byte-for-byte the histogram of the concatenated
  samples. Fleet p50/p95/p99 therefore carry the *same* one-bucket-width
  resolution as any single replica's — merging loses nothing.
* **scrapes are cumulative, rates are scraper-side** — ``GET /metrics``
  tallies are monotone since each replica's ``window_start`` and never
  reset, so windowed rates are per-replica deltas between two scrapes
  (``Δrequests / Δmono``) and can never race a reset. The same
  delta-histograms feed the SLO tail fractions.
* **clock alignment is explicit** — each process stamps wall clock on
  its own domain; the merged Perfetto export measures per-replica
  offsets via the ``/healthz`` round trip (offset = remote wall − RTT
  midpoint, uncertainty = RTT/2) and writes a ``clock_sync`` record per
  track instead of silently mixing domains.

:class:`SLO` + :func:`evaluate_slos` turn the merged view into the
error-budget **burn rate** an autoscaler consumes: a
latency SLO ``p99_s`` allows 1% of requests over the target, an
availability SLO allows ``1 - availability`` failed/shed — burn rate is
(observed bad fraction) / (allowed bad fraction), so burn 1.0 spends the
budget exactly on schedule and burn ≫ 1 is the scale-up trigger. The
:class:`~heat_tpu_torch.serve.net.router.Router` emits ``slo_burn`` events on
threshold crossings; everything here is pure computation.

All serve imports are lazy (function-local): telemetry must stay
importable without the serving tier.
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict, List, Optional, Sequence

from .. import _knobs as knobs

__all__ = [
    "SLO",
    "merge_metrics",
    "summarize_cluster",
    "evaluate_slos",
    "prometheus_text",
    "export_merged_trace",
]

_COUNT_KEYS = (
    "requests", "rows", "batches", "dispatched_rows", "padded_rows",
    "shed", "errors",
)


class SLO:
    """One endpoint's service-level objective: ``p99_s`` (at most 1% of
    requests slower than this) and/or ``availability`` (at least this
    fraction answered, i.e. not errored or shed). Either may be None —
    only the declared objectives are accounted."""

    __slots__ = ("endpoint", "p99_s", "availability")

    def __init__(
        self,
        endpoint: str,
        p99_s: Optional[float] = None,
        availability: Optional[float] = None,
    ):
        if p99_s is None and availability is None:
            raise ValueError(
                f"SLO for {endpoint!r} declares no objective — give "
                f"p99_s and/or availability"
            )
        if p99_s is not None and p99_s <= 0:
            raise ValueError(f"p99_s must be positive, got {p99_s}")
        if availability is not None and not (0.0 < availability < 1.0):
            raise ValueError(
                f"availability must be in (0, 1), got {availability}"
            )
        self.endpoint = endpoint
        self.p99_s = None if p99_s is None else float(p99_s)
        self.availability = (
            None if availability is None else float(availability)
        )

    def describe(self) -> dict:
        return {"endpoint": self.endpoint, "p99_s": self.p99_s,
                "availability": self.availability}

    def __repr__(self) -> str:  # pragma: no cover — debugging aid
        return (f"SLO({self.endpoint!r}, p99_s={self.p99_s}, "
                f"availability={self.availability})")


# -- metrics merging ----------------------------------------------------------


def merge_metrics(scrapes: Dict[str, Optional[dict]]) -> dict:
    """Merge per-replica ``GET /metrics`` payloads (``{url: payload}``;
    ``None`` marks a failed scrape) into the fleet view: per-endpoint
    summed tallies + bucket-wise-merged latency histograms (exact — the
    module contract), per-replica identity/compile/version rows, and the
    list of replicas that failed to scrape (never silently dropped)."""
    from ..serve.metrics import LatencyHistogram

    endpoints: Dict[str, dict] = {}
    replicas: Dict[str, dict] = {}
    failures: List[str] = []
    for url in sorted(scrapes):
        payload = scrapes[url]
        if not payload:
            failures.append(url)
            continue
        net = payload.get("net", {})
        counters = payload.get("counters", {}) or {}
        replicas[url] = {
            "pid": net.get("pid"),
            "queue_depth": payload.get("queue_depth", 0),
            "shed": payload.get("shed", 0),
            "steady_backend_compiles": net.get(
                "steady_backend_compiles", 0
            ),
            "versions": dict(payload.get("versions", {}) or {}),
            "tracing": {
                "sampled": counters.get("tracing.sampled", 0),
                "spans": counters.get("tracing.spans", 0),
            },
        }
        for name, ep in (payload.get("endpoints", {}) or {}).items():
            agg = endpoints.get(name)
            if agg is None:
                agg = endpoints[name] = {k: 0 for k in _COUNT_KEYS}
                agg["hist"] = LatencyHistogram()
                agg["replicas"] = 0
            agg["replicas"] += 1
            for k in _COUNT_KEYS:
                agg[k] += int(ep.get(k, 0) or 0)
            lr = ep.get("latency_raw")
            if lr:
                agg["hist"].merge(LatencyHistogram.from_raw(lr))
    return {
        "endpoints": endpoints,
        "replicas": replicas,
        "scrape_failures": failures,
    }


def _scrape_state(scrapes: Dict[str, Optional[dict]]) -> dict:
    """The JSON-serializable per-(replica, endpoint) snapshot a later
    scrape diffs against for windowed rates: cumulative tallies, the
    replica's monotonic stamp, and the raw histogram counts."""
    state: Dict[str, dict] = {}
    for url, payload in scrapes.items():
        if not payload:
            continue
        eps = {}
        for name, ep in (payload.get("endpoints", {}) or {}).items():
            lr = ep.get("latency_raw") or {}
            eps[name] = {
                "requests": int(ep.get("requests", 0) or 0),
                "errors": int(ep.get("errors", 0) or 0),
                "shed": int(ep.get("shed", 0) or 0),
                "mono": float(ep.get("mono", 0.0) or 0.0),
                "window_start": float(ep.get("window_start", 0.0) or 0.0),
                "counts": list(lr.get("counts", ())),
                "count": int(lr.get("count", 0) or 0),
            }
        state[url] = eps
    return state


def _window_deltas(
    cur: dict, prev: Optional[dict]
) -> Dict[str, dict]:
    """Per-endpoint windowed deltas between two scrape states (fleet
    sums of per-replica deltas; a replica absent from ``prev`` — fresh
    spawn or first scrape — contributes its cumulative tallies over its
    own lifetime window). Returns ``{endpoint: {"requests", "errors",
    "shed", "seconds", "qps", "counts", "count"}}``."""
    out: Dict[str, dict] = {}
    prev = prev or {}
    for url, eps in cur.items():
        pep_all = prev.get(url, {})
        for name, c in eps.items():
            p = pep_all.get(name)
            row = out.setdefault(name, {
                "requests": 0, "errors": 0, "shed": 0,
                "seconds": 0.0, "qps": 0.0,
                "counts": None, "count": 0,
            })
            if p is not None and p.get("mono", 0.0) <= c["mono"]:
                d_req = max(0, c["requests"] - p["requests"])
                d_err = max(0, c["errors"] - p["errors"])
                d_shed = max(0, c["shed"] - p["shed"])
                dt = c["mono"] - p["mono"]
                d_counts = [
                    max(0, a - b)
                    for a, b in zip(c["counts"], p.get("counts", ()))
                ] if c["counts"] else []
            else:
                d_req, d_err, d_shed = (
                    c["requests"], c["errors"], c["shed"]
                )
                dt = max(0.0, c["mono"] - c["window_start"])
                d_counts = list(c["counts"])
            row["requests"] += d_req
            row["errors"] += d_err
            row["shed"] += d_shed
            row["seconds"] = max(row["seconds"], dt)
            if dt > 0:
                row["qps"] += d_req / dt
            if d_counts:
                if row["counts"] is None:
                    row["counts"] = [0] * len(d_counts)
                for i, v in enumerate(d_counts):
                    row["counts"][i] += v
                row["count"] += sum(d_counts)
    return out


def _tail_count(counts: Sequence[int], threshold_s: float) -> float:
    """Estimated number of samples above ``threshold_s`` in a raw
    bucket-count vector (exact for buckets fully above the threshold;
    the straddling bucket contributes its log-interpolated fraction)."""
    from ..serve import metrics as m

    if threshold_s <= 0:
        return float(sum(counts))
    total = 0.0
    for i, c in enumerate(counts):
        if not c:
            continue
        lo = 0.0 if i == 0 else m._BASE * m._GROWTH ** (i - 1)
        hi = m._BASE * m._GROWTH ** i
        if lo >= threshold_s:
            total += c
        elif hi > threshold_s:
            total += c * (hi - threshold_s) / (hi - lo)
    return total


# -- SLO accounting -----------------------------------------------------------


def burn_threshold() -> float:
    """``HEAT_TPU_SLO_BURN_THRESHOLD`` — the burn rate above which the
    router emits ``slo_burn`` events (1.0 = budget spent on schedule)."""
    try:
        return float(knobs.get("HEAT_TPU_SLO_BURN_THRESHOLD"))
    except (TypeError, ValueError):
        return 1.0


def evaluate_slos(
    slos: Sequence[SLO],
    window: Dict[str, dict],
) -> List[dict]:
    """Score each SLO against the windowed deltas (on the first scrape
    the "window" is each replica's lifetime — :func:`_window_deltas`
    falls back to the cumulative tallies). Returns one row per SLO: the
    objective, observed window, per-objective burn rates, the combined
    ``burn_rate`` (max of the declared objectives), and ``breach``
    (burn above :func:`burn_threshold`)."""
    thr = burn_threshold()
    rows = []
    for slo in slos:
        w = window.get(slo.endpoint) or {}
        n = int(w.get("requests", 0) or 0)
        row = {
            **slo.describe(),
            "window_requests": n,
            "window_seconds": round(float(w.get("seconds", 0.0)), 3),
            "burn_rate": 0.0,
            "breach": False,
            "threshold": thr,
        }
        burns = []
        if slo.p99_s is not None:
            counts = w.get("counts") or []
            total = int(w.get("count", 0) or 0)
            slow = _tail_count(counts, slo.p99_s) if total else 0.0
            frac = slow / total if total else 0.0
            # the p99 objective budgets 1% of requests over the target
            row["slow_fraction"] = round(frac, 6)
            row["latency_burn"] = round(frac / 0.01, 4)
            burns.append(row["latency_burn"])
        if slo.availability is not None:
            bad = int(w.get("errors", 0) or 0) + int(w.get("shed", 0) or 0)
            denom = n + int(w.get("shed", 0) or 0)
            frac = bad / denom if denom else 0.0
            budget = 1.0 - slo.availability
            row["bad_fraction"] = round(frac, 6)
            row["availability_burn"] = round(
                frac / budget if budget > 0 else math.inf, 4
            )
            burns.append(row["availability_burn"])
        if burns:
            row["burn_rate"] = max(burns)
            row["breach"] = bool(row["burn_rate"] > thr)
        rows.append(row)
    return rows


# -- fleet summary ------------------------------------------------------------


def summarize_cluster(
    scrapes: Dict[str, Optional[dict]],
    *,
    slos: Sequence[SLO] = (),
    prev_state: Optional[dict] = None,
    router_stats: Optional[dict] = None,
) -> dict:
    """The fleet-merged observability report (``report.summarize`` for a
    cluster): per-endpoint fleet tallies + QPS + merged p50/p95/p99 +
    occupancy, per-replica rows (pid, queue depth, compile counters,
    version lag, tracing counters), the optional router's own counters,
    and — when SLOs are declared — the ``slo`` burn-rate block an
    autoscaler consumes.

    Pure function of its scrape inputs. ``prev_state`` is the ``state``
    field of an earlier summary; with it, QPS and SLO fractions are
    windowed per-replica deltas (scrape contract: cumulative counters,
    scraper-side rates); without it, they cover each replica's lifetime.
    The returned ``state`` feeds the next call."""
    merged = merge_metrics(scrapes)
    state = _scrape_state(scrapes)
    window = _window_deltas(state, prev_state)

    # endpoint versions across replicas: lag = replicas serving below
    # the fleet-max version (rolling update in flight / stuck)
    fleet_ver: Dict[str, int] = {}
    for rep in merged["replicas"].values():
        for name, v in rep["versions"].items():
            fleet_ver[name] = max(fleet_ver.get(name, 0), int(v))

    endpoints = {}
    for name, agg in merged["endpoints"].items():
        hist = agg["hist"]
        w = window.get(name, {})
        denom = agg["dispatched_rows"] + agg["padded_rows"]
        lagging = sum(
            1 for rep in merged["replicas"].values()
            if name in rep["versions"]
            and int(rep["versions"][name]) < fleet_ver.get(name, 0)
        )
        endpoints[name] = {
            "replicas": agg["replicas"],
            "requests": agg["requests"],
            "rows": agg["rows"],
            "batches": agg["batches"],
            "shed": agg["shed"],
            "errors": agg["errors"],
            "occupancy": (
                agg["dispatched_rows"] / denom if denom else None
            ),
            "qps": round(float(w.get("qps", 0.0)), 3),
            "window_requests": int(w.get("requests", 0)),
            "latency": hist.snapshot(),
            "version": fleet_ver.get(name),
            "version_lag": lagging,
        }

    out = {
        "replicas": merged["replicas"],
        "endpoints": endpoints,
        "scrape_failures": merged["scrape_failures"],
        "state": state,
    }
    if router_stats is not None:
        out["router"] = {
            "counters": router_stats.get("router", {}),
            "queue_depth": router_stats.get("queue_depth", 0),
            "replicas": router_stats.get("replicas", {}),
        }
    if slos:
        out["slo"] = evaluate_slos(list(slos), window)
    return out


# -- Prometheus exposition ----------------------------------------------------

def _prom_escape(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"')


def prometheus_text(summary: dict) -> str:
    """Render a :func:`summarize_cluster` report in Prometheus text
    exposition format (the merged fleet view — scrape the *router*, not
    N replicas). Counters are fleet-cumulative; quantiles come from the
    exactly-merged histograms."""
    lines: List[str] = []

    def head(name: str, typ: str, help_: str) -> None:
        lines.append(f"# HELP {name} {help_}")
        lines.append(f"# TYPE {name} {typ}")

    head("heat_tpu_requests_total", "counter",
         "Fleet-cumulative requests per endpoint.")
    for name, ep in sorted(summary.get("endpoints", {}).items()):
        lines.append(
            f'heat_tpu_requests_total{{endpoint="{_prom_escape(name)}"}} '
            f'{ep["requests"]}'
        )
    head("heat_tpu_errors_total", "counter",
         "Fleet-cumulative failed requests per endpoint.")
    for name, ep in sorted(summary.get("endpoints", {}).items()):
        lines.append(
            f'heat_tpu_errors_total{{endpoint="{_prom_escape(name)}"}} '
            f'{ep["errors"]}'
        )
    head("heat_tpu_shed_total", "counter",
         "Fleet-cumulative shed (503) requests per endpoint.")
    for name, ep in sorted(summary.get("endpoints", {}).items()):
        lines.append(
            f'heat_tpu_shed_total{{endpoint="{_prom_escape(name)}"}} '
            f'{ep["shed"]}'
        )
    head("heat_tpu_qps", "gauge",
         "Windowed fleet requests/second per endpoint (scraper-side "
         "delta).")
    for name, ep in sorted(summary.get("endpoints", {}).items()):
        lines.append(
            f'heat_tpu_qps{{endpoint="{_prom_escape(name)}"}} {ep["qps"]}'
        )
    head("heat_tpu_request_latency_seconds", "summary",
         "Merged-histogram latency quantiles per endpoint (exact "
         "bucket-wise merge; one-bucket-width resolution).")
    for name, ep in sorted(summary.get("endpoints", {}).items()):
        lat = ep.get("latency", {})
        for q, key in (("0.5", "p50_s"), ("0.95", "p95_s"),
                       ("0.99", "p99_s")):
            v = lat.get(key)
            if v is not None:
                lines.append(
                    f'heat_tpu_request_latency_seconds{{endpoint='
                    f'"{_prom_escape(name)}",quantile="{q}"}} {v:.9f}'
                )
    head("heat_tpu_replica_queue_depth", "gauge",
         "Per-replica admitted-but-unresolved backlog.")
    for url, rep in sorted(summary.get("replicas", {}).items()):
        lines.append(
            f'heat_tpu_replica_queue_depth{{replica='
            f'"{_prom_escape(url)}"}} {rep["queue_depth"]}'
        )
    head("heat_tpu_replica_steady_compiles", "counter",
         "Backend compiles after warm-up per replica (zero-recompile "
         "oracle).")
    for url, rep in sorted(summary.get("replicas", {}).items()):
        lines.append(
            f'heat_tpu_replica_steady_compiles{{replica='
            f'"{_prom_escape(url)}"}} {rep["steady_backend_compiles"]}'
        )
    if summary.get("slo"):
        head("heat_tpu_slo_burn_rate", "gauge",
             "Error-budget burn rate per SLO (1.0 = spending the budget "
             "exactly on schedule).")
        for row in summary["slo"]:
            lines.append(
                f'heat_tpu_slo_burn_rate{{endpoint='
                f'"{_prom_escape(row["endpoint"])}"}} {row["burn_rate"]}'
            )
    return "\n".join(lines) + "\n"


# -- merged Perfetto trace ----------------------------------------------------


def export_merged_trace(router, path: str) -> str:
    """Export ONE Perfetto/Chrome trace covering the router process plus
    every scrapable replica: each process becomes its own pid track
    (labelled with the replica URL), timestamps are clock-offset
    corrected from the router's ``/healthz`` round-trip calibration
    (explicit per-track ``clock_sync`` records carry offset +
    uncertainty), and all tracks share one fleet-wide t=0 — a sampled
    request's ``router.queue → router.post → serve.queue → … →
    serve.reply`` hops line up on one timeline, joined by trace_id."""
    from . import get_registry
    from . import trace as trace_mod

    sync = router.clock_sync()
    scraped = router.scrape_traces()

    # (events, pid, offset, uncertainty, label) per process; the router
    # itself is the reference clock domain (offset 0, no uncertainty —
    # but still labelled, so the merged file is self-describing)
    procs = [(
        list(get_registry().events), os.getpid(), 0.0, 0.0, "router",
    )]
    for url in sorted(scraped):
        payload = scraped[url]
        if not payload:
            continue
        s = sync.get(url) or {}
        procs.append((
            payload.get("events", []) or [],
            int(payload.get("pid") or 0),
            float(s.get("offset", 0.0)),
            float(s.get("uncertainty", 0.0)),
            url,
        ))

    # fleet anchor: earliest corrected start across every process
    anchor = None
    for events, _pid, offset, _unc, _label in procs:
        t = trace_mod.earliest_start(events)
        if t is not None:
            t -= offset
            if anchor is None or t < anchor:
                anchor = t

    all_events: List[dict] = []
    for events, pid, offset, unc, label in procs:
        all_events.extend(trace_mod.to_trace_events(
            events, pid,
            clock_offset=offset, clock_uncertainty=unc,
            anchor_ts=anchor, process_name=label,
        ))
    with open(path, "w") as f:
        json.dump(
            {"traceEvents": all_events, "displayTimeUnit": "ms"},
            f, default=str,
        )
    return path
