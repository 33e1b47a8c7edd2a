"""The Chrome-trace / Perfetto export against heat_tpu's.

``to_trace_events`` and ``export_trace`` are pure Python over the event
list in both packages: one fixture of events (spans, span errors,
compiles, memory, request hops, autotune, collectives, audits) must give
the same list and the same JSON file (exact), with and without the
cross-process ``clock_offset``/``anchor_ts`` merge. A live run of the
port's instrumented ops must export a well-formed trace: every slice with
``ph``, ``ts``, ``dur``, ``pid`` and ``tid``, timestamps not decreasing.
"""

import json

import numpy as np
import pytest

from heat_tpu.telemetry import trace as jtrace

import heat_tpu_torch as htt
from heat_tpu_torch import telemetry
from heat_tpu_torch.telemetry import trace


@pytest.fixture(autouse=True)
def on_cpu():
    htt.use_device("cpu")
    yield
    htt.use_device(None)


EVENTS = [
    {"ts": 100.5, "kind": "span", "name": "resplit", "seconds": 0.25, "depth": 0,
     "parent": None, "start_ts": 100.25, "collective": "all-to-all", "bytes": 4096},
    {"ts": 100.45, "kind": "span", "name": "relayout", "seconds": 0.125, "depth": 1,
     "parent": "resplit", "start_ts": 100.3, "bytes": 4096},
    {"ts": 101.0, "kind": "span_error", "name": "qr", "seconds": 0.0625, "start_ts": 100.9375,
     "error": "ValueError('x')"},
    {"ts": 101.5, "kind": "compile", "name": "backend_compile", "seconds": 0.5},
    {"ts": 101.6, "kind": "memory", "name": "watermark", "total": 777, "per_device": {"cpu": 7}},
    {"ts": 101.7, "kind": "collective_trace", "name": "all_gather", "group_size": 4},
    {"ts": 101.8, "kind": "hlo_audit", "name": "tsqr", "drift": 0, "ok": True},
    {"ts": 101.9, "kind": "autotune", "name": "cdist", "event": "trial", "ms": 1.5},
    {"ts": 102.0, "kind": "trace_span", "name": "serve.queue", "seconds": 0.001,
     "start_ts": 101.999, "trace_id": "t1"},
    {"ts": 99.0, "kind": "streaming", "name": "moments", "event": "stream_chunk", "rows": 5},
]


@pytest.mark.parametrize("cut", [1, 4, len(EVENTS)])
def test_to_trace_events_matches_reference(cut):
    got = trace.to_trace_events(EVENTS[:cut], pid=42)
    assert got == jtrace.to_trace_events(EVENTS[:cut], pid=42)


@pytest.mark.parametrize("offset,unc,anchor,name", [
    (0.0, None, None, None), (0.25, 0.001, None, "replica"), (-1.5, 0.0, 98.0, "router"),
    (2.0, 0.5, 97.5, None)])
def test_merged_form_matches_reference(offset, unc, anchor, name):
    kw = dict(clock_offset=offset, clock_uncertainty=unc, anchor_ts=anchor, process_name=name)
    got = trace.to_trace_events(EVENTS, 7, **kw)
    assert got == jtrace.to_trace_events(EVENTS, 7, **kw)
    assert any(e["name"] == "clock_sync" for e in got) == (unc is not None)


def test_earliest_start_matches_reference():
    assert trace.earliest_start(EVENTS) == jtrace.earliest_start(EVENTS) == 99.0
    assert trace.earliest_start([]) is None and jtrace.earliest_start([]) is None


def test_export_trace_writes_the_reference_json(tmp_path, monkeypatch):
    monkeypatch.setattr("os.getpid", lambda: 1234)
    got = trace.export_trace(str(tmp_path / "port.json"), EVENTS)
    want = jtrace.export_trace(str(tmp_path / "ref.json"), EVENTS)
    assert open(got).read() == open(want).read()


def _check_slices(doc):
    rows = doc["traceEvents"]
    assert doc["displayTimeUnit"] == "ms"
    body = [e for e in rows if e["ph"] != "M"]
    for e in rows:
        assert {"ph", "ts", "pid", "tid"} <= set(e), e
    for e in body:
        if e["ph"] == "X":
            assert e["dur"] >= 0, e
    ts = [e["ts"] for e in body]
    assert ts == sorted(ts) and ts[0] >= 0
    return body


def test_live_export_is_well_formed(tmp_path):
    reg = telemetry.get_registry()
    reg.clear()
    telemetry.enable()
    try:
        x = htt.array(np.random.default_rng(0).standard_normal((40, 6)).astype(np.float32),
                      split=0)
        htt.resplit(x, 1)
        htt.linalg.qr(x)
        telemetry.memory.watermark()
        with telemetry.span("outer", bytes=8):
            with telemetry.span("inner"):
                pass
        path = telemetry.export_trace(str(tmp_path / "t.json"))
    finally:
        telemetry.disable()
        reg.clear()
    body = _check_slices(json.loads(open(path).read()))
    names = {e["name"] for e in body if e["ph"] == "X"}
    assert {"resplit", "outer", "inner"} <= names  # qr on one rank: no TSQR span
    assert any(e["ph"] == "C" and e["name"] == "live_bytes" for e in body)
    outer = next(e for e in body if e["name"] == "outer")
    inner = next(e for e in body if e["name"] == "inner")
    assert outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


def test_sink_replay_exports_the_live_trace(tmp_path):
    reg = telemetry.get_registry()
    reg.clear()
    sink = tmp_path / "sink.jsonl"
    telemetry.enable(str(sink))
    try:
        htt.resplit(htt.array(np.ones((8, 2), np.float32), split=0), None)
    finally:
        telemetry.disable()
    live = trace.to_trace_events(pid=1)
    replay = trace.to_trace_events(telemetry.report.load_events(str(sink)), pid=1)
    reg.clear()
    assert json.loads(json.dumps(live, default=str)) == json.loads(json.dumps(replay, default=str))
