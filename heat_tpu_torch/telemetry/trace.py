"""Chrome-trace / Perfetto export of the telemetry event stream.

The port's copy of ``heat_tpu/telemetry/trace.py``: pure Python over the
event list, so the same events give the same JSON as the JAX package's
(the process track keeps the JAX package's default name).

Turns the registry's events (or a JSONL sink read back via
:func:`..report.load_events`) into a `Trace Event Format
<https://docs.google.com/document/d/1CvAClvFfyA5R-PhYUmn5OOQtYMH4h6I0nSsKchNAySU>`_
JSON file loadable in ``chrome://tracing`` or https://ui.perfetto.dev:

* ``span`` / ``span_error`` events → complete (``"X"``) slices on the
  *spans* track, with their user fields (``bytes``, ``collective``,
  ``gshape``, anything via ``add_fields``) and, on the card, their
  ``device_s`` (the live registry's pending spans resolved first) as
  ``args``;
* ``compile`` events → ``"X"`` slices on the *compile* track (the
  AOT/backend-compile durations, visually separated from execution);
* ``memory`` events → a ``live_bytes`` counter (``"C"``) track;
* ``trace_span`` events (request-trace hops) → ``"X"`` slices
  on the *requests* track, carrying their ``trace_id`` in ``args`` so
  Perfetto's query/filter UI groups one request's hops across tracks —
  and, in a merged export, across processes;
* everything else (``collective_trace``, ``hlo_audit``, …) → instant
  (``"i"``) markers on the *events* track.

Timestamps: the registry records wall-clock *end* times plus durations;
slices are re-anchored to their start (``ts - seconds``), shifted so the
earliest event is t=0, and emitted in microseconds, sorted — the
monotonic, pid/tid-complete stream the format requires.

Cross-process merging: each process records wall clock on its
own clock domain. A merged export passes per-process ``clock_offset``
(this process's wall minus the reference process's wall, measured by the
``/healthz`` round trip), ``clock_uncertainty`` (± RTT/2 of that probe),
and one fleet-wide ``anchor_ts`` so every track shares t=0. The offset
correction is explicit, never silent: a merged track carries a
``clock_sync`` instant record stating the applied offset and its
uncertainty. The single-process default (no offset, no anchor, no
uncertainty) adds no such record.
"""

from __future__ import annotations

import json
import os
from typing import Iterable, List, Optional

__all__ = ["to_trace_events", "export_trace", "earliest_start"]

_TID_SPANS = 1
_TID_COMPILE = 2
_TID_EVENTS = 3
_TID_MEMORY = 4
_TID_AUTOTUNE = 5
_TID_REQUESTS = 6

_THREAD_NAMES = {
    _TID_SPANS: "spans",
    _TID_COMPILE: "compile",
    _TID_EVENTS: "events",
    _TID_MEMORY: "memory",
    _TID_AUTOTUNE: "autotune",
    _TID_REQUESTS: "requests",
}

_META_KEYS = ("ts", "kind", "name", "seconds", "depth", "parent", "start_ts")


def _args(ev: dict) -> dict:
    out = {k: v for k, v in ev.items() if k not in _META_KEYS}
    # depth/parent are span structure, useful to keep visible in the UI
    if "parent" in ev and ev.get("parent") is not None:
        out["parent"] = ev["parent"]
    return out


def _event_start(ev: dict) -> float:
    kind = ev.get("kind")
    ts_end = float(ev.get("ts", 0.0))
    dur = float(ev.get("seconds", 0.0) or 0.0)
    if kind in ("span", "span_error", "compile", "trace_span"):
        # spans carry their wall-clock start explicitly (deriving it as
        # `ts - seconds` mixes the wall and perf_counter clocks and
        # breaks slice containment at µs scale); compile events do not,
        # so they fall back to the derived start
        return float(ev.get("start_ts") or (ts_end - dur))
    return ts_end


def earliest_start(events: Iterable[dict]) -> Optional[float]:
    """Earliest wall-clock slice start in ``events`` (this process's
    clock domain) — the per-process input to a merged export's global
    ``anchor_ts``. ``None`` for an empty stream."""
    t0 = None
    for ev in events:
        start = _event_start(ev)
        if t0 is None or start < t0:
            t0 = start
    return t0


def to_trace_events(
    events: Optional[Iterable[dict]] = None, pid: Optional[int] = None,
    *,
    clock_offset: float = 0.0,
    clock_uncertainty: Optional[float] = None,
    anchor_ts: Optional[float] = None,
    process_name: Optional[str] = None,
) -> List[dict]:
    """Convert telemetry events (default: the live registry's) into a
    sorted Trace Event Format list (``ts``/``dur`` in microseconds,
    earliest event at t=0, ``pid``/``tid`` on every record).

    The keyword-only parameters serve cross-process merges (module
    docstring): ``clock_offset`` (seconds this process's wall clock runs
    ahead of the reference — subtracted from every timestamp) with its
    ``clock_uncertainty`` (emitted as an explicit ``clock_sync`` record
    whenever it is not ``None``), ``anchor_ts`` (the fleet-wide t=0 in
    reference wall seconds, replacing the local earliest-event anchor),
    and ``process_name`` (the track label — e.g. the replica URL). The
    defaults reproduce the single-process export byte-for-byte."""
    if events is None:
        from . import get_registry

        reg = get_registry()
        reg.resolve()
        events = list(reg.events)
    else:
        events = list(events)
    if pid is None:
        pid = os.getpid()

    out: List[dict] = [
        {"name": "process_name", "ph": "M", "ts": 0, "pid": pid, "tid": 0,
         "args": {"name": process_name or "heat_tpu.telemetry"}},
    ]
    for tid, tname in _THREAD_NAMES.items():
        out.append({"name": "thread_name", "ph": "M", "ts": 0, "pid": pid,
                    "tid": tid, "args": {"name": tname}})

    rows: List[dict] = []
    t0 = None
    for ev in events:
        start = _event_start(ev) - clock_offset
        dur = float(ev.get("seconds", 0.0) or 0.0)
        if t0 is None or start < t0:
            t0 = start
        rows.append({"_start": start, "_dur": dur, **ev})
    if anchor_ts is not None:
        t0 = anchor_ts
    t0 = t0 or 0.0

    if clock_uncertainty is not None:
        # merged-export honesty: state the applied correction instead of
        # silently mixing clock domains
        out.append({
            "name": "clock_sync", "cat": "clock_sync", "ph": "i", "ts": 0.0,
            "s": "p", "pid": pid, "tid": _TID_EVENTS,
            "args": {"offset_s": clock_offset,
                     "uncertainty_s": clock_uncertainty},
        })

    for ev in rows:
        kind = ev.get("kind")
        name = str(ev.get("name", "?"))
        ts_us = (ev["_start"] - t0) * 1e6
        dur_us = ev["_dur"] * 1e6
        clean = {k: v for k, v in ev.items() if k not in ("_start", "_dur")}
        if kind in ("span", "span_error"):
            out.append({
                "name": name, "cat": kind, "ph": "X", "ts": ts_us,
                "dur": dur_us, "pid": pid, "tid": _TID_SPANS,
                "args": _args(clean),
            })
        elif kind == "trace_span":
            # request-trace hops: trace_id stays in args so
            # Perfetto's filter box collects one request across tracks
            out.append({
                "name": name, "cat": "trace_span", "ph": "X", "ts": ts_us,
                "dur": dur_us, "pid": pid, "tid": _TID_REQUESTS,
                "args": _args(clean),
            })
        elif kind == "compile":
            out.append({
                "name": name, "cat": "compile", "ph": "X", "ts": ts_us,
                "dur": dur_us, "pid": pid, "tid": _TID_COMPILE,
                "args": _args(clean),
            })
        elif kind == "memory":
            out.append({
                "name": "live_bytes", "cat": "memory", "ph": "C",
                "ts": ts_us, "pid": pid, "tid": _TID_MEMORY,
                "args": {"total": ev.get("total", 0)},
            })
        elif kind == "autotune":
            # tuner activity gets its own track: trial /
            # db_hit / pick / adopt markers, named by their event so the
            # timeline reads as a tuning narrative
            out.append({
                "name": f"{ev.get('event', 'event')}:{name}",
                "cat": "autotune", "ph": "i", "ts": ts_us, "s": "p",
                "pid": pid, "tid": _TID_AUTOTUNE, "args": _args(clean),
            })
        else:  # collective_trace, hlo_audit, and future kinds
            out.append({
                "name": name, "cat": str(kind), "ph": "i", "ts": ts_us,
                "s": "p", "pid": pid, "tid": _TID_EVENTS,
                "args": _args(clean),
            })

    # metadata first, then everything else in monotonic ts order
    meta = [e for e in out if e["ph"] == "M"]
    rest = sorted((e for e in out if e["ph"] != "M"), key=lambda e: e["ts"])
    return meta + rest


def export_trace(
    path: str, events: Optional[Iterable[dict]] = None
) -> str:
    """Write the event stream as a Chrome-trace JSON object
    (``{"traceEvents": [...]}``) loadable in ``chrome://tracing`` /
    Perfetto; returns ``path``. ``events`` defaults to the live
    registry's stream — pass ``report.load_events(sink)`` to convert a
    JSONL sink from an earlier run."""
    trace = {
        "traceEvents": to_trace_events(events),
        "displayTimeUnit": "ms",
    }
    with open(path, "w") as f:
        json.dump(trace, f, default=str)
    return path
