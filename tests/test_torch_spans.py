"""The port's telemetry spans: off they are one shared no-op; under
``torch.profiler`` they are ``htt.<name>`` ranges in the profiler's trace,
around the ops they run; while telemetry records they never wait for the
card, and their device time, from CUDA events, is resolved only when the
registry is read. Also the spans at the sites of KMeans and cdist, and the
always-on count of the program's blocking reads of device values.

The file imports neither jax nor heat_tpu. The test marked ``cuda`` needs a
card:

    python -m pytest tests/test_torch_spans.py -m cuda --noconftest -q
"""

import io
import json
from collections import defaultdict

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import heat_tpu_torch as htt
from heat_tpu_torch import telemetry


@pytest.fixture(autouse=True)
def on_cpu():
    htt.use_device("cpu")
    yield
    htt.use_device(None)


@pytest.fixture
def registry():
    """An empty registry, telemetry off; off and empty again after."""
    telemetry.disable()
    reg = telemetry.get_registry()
    reg.clear()
    yield reg
    telemetry.disable()
    reg.clear()


def _ranges(prof, tmp_path):
    """The ``htt.*`` ranges and the aten ops of a profile's Chrome trace."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    spans = [e for e in events if e["name"].startswith("htt.")]
    aten = [e for e in events if e["name"].startswith("aten::")]
    return spans, aten


def _inside(inner, outer):
    return (outer["ts"] <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1e-3)


def test_off_a_span_is_the_shared_noop_and_records_nothing(registry):
    assert not telemetry.spanning()
    sp = telemetry.span("off", bytes=8)
    assert sp is telemetry.span("other")
    t = torch.ones(3)
    with sp as inside:
        assert inside.add_fields(x=1) is inside and inside.output(t) is t
    assert registry.events == [] and dict(registry.counters) == {}


@pytest.mark.parametrize("recording", [False, True])
def test_spans_are_profiler_ranges_nested_as_entered(registry, tmp_path, recording):
    if recording:
        telemetry.enable()
    a = torch.randn(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert telemetry.spanning()
        with telemetry.span("outer", bytes=4):
            with telemetry.span("inner"):
                a @ a
            a + a
    spans, aten = _ranges(prof, tmp_path)
    by = {e["name"]: e for e in spans}
    assert sorted(by) == ["htt.inner", "htt.outer"]
    assert _inside(by["htt.inner"], by["htt.outer"])
    mm = [e for e in aten if e["name"] == "aten::mm"]
    add = [e for e in aten if e["name"] == "aten::add"]
    assert mm and all(_inside(e, by["htt.inner"]) for e in mm)
    assert add and all(_inside(e, by["htt.outer"]) and not _inside(e, by["htt.inner"])
                       for e in add)
    names = [e["name"] for e in registry.events if e["kind"] == "span"]
    assert names == (["inner", "outer"] if recording else [])
    if recording:
        # no CUDA here: no device time to resolve
        assert all("device_s" not in e for e in registry.events)
        assert registry.events[0]["parent"] == "outer" and registry.events[1]["depth"] == 0


class _FakeEvent:
    """A CUDA event on a card that the test drives: ``done`` says whether
    the card has passed it, ``at`` when (ms)."""

    made = []

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.done, self.at, self.waited = False, None, False
        _FakeEvent.made.append(self)

    def record(self, stream=None):
        assert stream is not None and stream.device_index == 0
        self.done, self.at = False, 10.0 * len(_FakeEvent.made)

    def query(self):
        return self.done

    def synchronize(self):
        self.waited = True
        self.done = True

    def elapsed_time(self, end):
        assert end.done  # and so self, recorded before it on the same stream
        return end.at - self.at


@pytest.fixture
def fake_card(monkeypatch):
    """CUDA initialised, with no card behind it: events are _FakeEvent, and
    any wait for the whole card fails the test."""

    class Stream:
        device_index = 0

    def no_sync(*a, **k):
        raise AssertionError("a span waited for the card")

    _FakeEvent.made = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    monkeypatch.setattr(telemetry, "_current_stream", Stream)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    monkeypatch.setattr(telemetry, "_POOL", defaultdict(list))
    return _FakeEvent


def _resolve_by_flush(reg):
    telemetry.flush()


def _resolve_by_snapshot(reg):
    reg.snapshot()


def _resolve_by_export(reg):
    telemetry.trace.to_trace_events()


def _resolve_by_summary(reg):
    telemetry.report.summarize()


def _resolve_by_disable(reg):
    telemetry.disable()


@pytest.mark.parametrize("read", [_resolve_by_flush, _resolve_by_snapshot, _resolve_by_export,
                                  _resolve_by_summary, _resolve_by_disable],
                         ids=lambda f: f.__name__[len("_resolve_by_"):])
def test_a_recording_span_never_waits_and_resolves_when_read(registry, fake_card, read):
    sink = io.StringIO()
    telemetry.enable(sink)
    t = torch.ones(2)
    with telemetry.span("outer"):
        with telemetry.span("inner") as sp:
            assert sp.output(t) is t
    assert not any(e.waited for e in fake_card.made)
    spans = [e for e in registry.events if e["kind"] == "span"]
    assert [e["name"] for e in spans] == ["inner", "outer"]
    assert all("device_s" not in e for e in spans) and sink.getvalue() == ""
    read(registry)
    assert [e["device_s"] for e in spans] == [pytest.approx(0.01), pytest.approx(0.03)]
    assert {e["name"]: e["depth"] for e in spans} == {"inner": 1, "outer": 0}
    written = [json.loads(line) for line in sink.getvalue().splitlines()]
    assert {e["name"]: e["device_s"] for e in written if e["kind"] == "span"} == {
        "inner": pytest.approx(0.01), "outer": pytest.approx(0.03)}
    assert registry.counters["span.inner.device_s"] == pytest.approx(0.01)
    # resolved events go back to the pool: the next spans make none
    made = len(fake_card.made)
    telemetry.enable()
    with telemetry.span("again"):
        pass
    assert len(fake_card.made) == made


def test_spans_pend_until_read_or_cleared_and_none_inside_a_capture(registry, fake_card,
                                                                    monkeypatch):
    telemetry.enable()
    for _ in range(300):
        with telemetry.span("s"):
            pass
    assert len(registry._pending) == 300 and not any(e.waited for e in fake_card.made)
    registry.clear(kinds=["span"])
    assert registry._pending == [] and registry.events == []
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    made = len(fake_card.made)
    with telemetry.span("captured"):
        pass
    assert len(fake_card.made) == made and registry._pending == []
    assert [e["name"] for e in registry.events] == ["captured"]
    assert "device_s" not in registry.events[0]


def test_a_span_that_raises_returns_its_event(registry, fake_card):
    telemetry.enable()
    with pytest.raises(ValueError):
        with telemetry.span("bad"):
            raise ValueError("x")
    assert [e["kind"] for e in registry.events] == ["span_error"]
    assert registry._pending == [] and len(telemetry._POOL[0]) == 1


@pytest.mark.parametrize("passes", [1, 4, 9])
def test_host_reads_of_a_kmeans_fit(registry, passes):
    x = htt.array(np.random.default_rng(passes).normal(size=(600, 5)).astype(np.float32),
                  split=0)
    telemetry.reset_host_read_counts()
    htt.cluster.KMeans(n_clusters=3, max_iter=passes, tol=-1.0, random_state=1).fit(x)
    assert telemetry.host_read_counts() == {"lloyd.shift": passes, "kmeans.inertia": 1}
    telemetry.reset_host_read_counts()
    assert telemetry.host_read_counts() == {}
    assert telemetry.host_read(torch.tensor(2.5), "site") == 2.5
    assert telemetry.host_read_counts() == {"site": 1}
    telemetry.reset_host_read_counts()


def test_the_sites_are_ranges_under_the_profiler_alone(registry, tmp_path):
    rng = np.random.default_rng(0)
    x = htt.array(rng.normal(size=(500, 4)).astype(np.float32), split=0)
    q = htt.array(rng.normal(size=(40, 4)).astype(np.float32), split=0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        htt.cluster.KMeans(n_clusters=3, max_iter=2, tol=-1.0, random_state=0).fit(x)
        htt.spatial.cdist(q, x, quadratic_expansion=True)
    spans, _ = _ranges(prof, tmp_path)
    names = [e["name"][4:] for e in sorted(spans, key=lambda e: e["ts"])]
    assert names == ["kmeans.fit", "kmeans.init", "lloyd.pass", "lloyd.update", "lloyd.read",
                     "lloyd.pass", "lloyd.update", "lloyd.read", "kmeans.label", "cdist",
                     "resplit"]
    by = defaultdict(list)
    for e in spans:
        by[e["name"][4:]].append(e)
    fit = by["kmeans.fit"][0]
    for name in ("kmeans.init", "lloyd.pass", "kmeans.label"):
        assert all(_inside(e, fit) for e in by[name])
    for inner in ("lloyd.update", "lloyd.read"):
        assert all(any(_inside(e, p) for p in by["lloyd.pass"]) for e in by[inner])
    assert _inside(by["resplit"][0], by["cdist"][0])
    # telemetry was off: no events, no counters, no cost computed
    assert registry.events == [] and dict(registry.counters) == {}


@pytest.mark.cuda
def test_a_span_on_the_card_ends_before_its_kernel_and_times_it(registry):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    telemetry.enable()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with telemetry.span("sleep"):
        a.record()
        torch.cuda._sleep(200_000_000)  # ~0.1 s of spinning
        b.record()
    running = not b.query()
    telemetry.flush()
    assert running, "the span waited for its kernel"
    ev = [e for e in registry.events if e["kind"] == "span"][0]
    assert ev["device_s"] == pytest.approx(a.elapsed_time(b) / 1000.0, rel=0.1)
    assert ev["seconds"] < 0.5 * ev["device_s"]
