"""The fleet view (``telemetry.cluster``) against heat_tpu's, and the
router's four fleet methods over live fronts.

The histograms merge exactly only with the JAX package's bucket geometry,
so that is held first. Then ``merge_metrics``, ``summarize_cluster``,
``evaluate_slos`` and ``prometheus_text`` must give the JAX package's
results on one fixture of scrapes (exact: the same integer tallies and the
same float arithmetic), windowed and not; and ``export_merged_trace`` the
same merged document over one scripted router. Last, a port ``Router``
over two in-process ``HttpFront``s (CPU servers) answers
``cluster_summary``, ``check_slos``, ``prometheus_text`` and
``export_cluster_trace``.
"""

import json
import os

import numpy as np
import pytest

from heat_tpu.serve import metrics as jmetrics
from heat_tpu.telemetry import cluster as jcluster

import heat_tpu_torch as htt
from heat_tpu_torch import serve, telemetry
from heat_tpu_torch.serve import Server
from heat_tpu_torch.serve import metrics as tmetrics
from heat_tpu_torch.serve.net import HttpFront, Router
from heat_tpu_torch.telemetry import cluster


@pytest.fixture(autouse=True)
def on_cpu():
    htt.use_device("cpu")
    yield
    htt.use_device(None)


def test_histogram_geometry_is_the_reference():
    assert (tmetrics._BASE, tmetrics._GROWTH, tmetrics._NBUCKETS) == \
        (jmetrics._BASE, jmetrics._GROWTH, jmetrics._NBUCKETS)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_histograms_merge_exactly_across_packages(seed):
    rng = np.random.default_rng(seed)
    parts = [np.abs(rng.standard_normal(n)) * 10.0 ** rng.uniform(-4, 0) for n in (30, 1, 77)]
    merged = tmetrics.LatencyHistogram()
    for part in parts:
        h = jmetrics.LatencyHistogram()
        for s in part:
            h.record(float(s))
        merged.merge(tmetrics.LatencyHistogram.from_raw(h.raw()))
    whole = jmetrics.LatencyHistogram()
    for s in np.concatenate(parts):
        whole.record(float(s))
    got, want = merged.raw(), whole.raw()
    # the buckets merge exactly; the running sum of the seconds adds in
    # another order (the JAX package's own merge does the same)
    assert got.pop("total") == pytest.approx(want.pop("total"), rel=1e-12)
    assert got == want
    for q in (0.5, 0.95, 0.99):
        assert merged.quantile(q) == whole.quantile(q)


def _hist(module, samples):
    h = module.LatencyHistogram()
    for s in samples:
        h.record(float(s))
    return h


def _payload(module, requests, mono, samples=(), *, errors=0, shed=0, version=1, pid=100,
             window_start=0.0, sampled=0, spans=0, padded=0):
    h = _hist(module, samples)
    return {
        "endpoints": {"ep": {
            "requests": requests, "rows": requests, "batches": requests,
            "dispatched_rows": requests, "padded_rows": padded,
            "shed": shed, "errors": errors, "window_start": window_start, "mono": mono,
            "latency_raw": h.raw(),
        }},
        "versions": {"ep": version},
        "queue_depth": 3,
        "shed": shed,
        "counters": {"tracing.sampled": sampled, "tracing.spans": spans},
        "net": {"pid": pid, "steady_backend_compiles": 1},
    }


def _scrapes(module, rng_seed=17, later=False):
    rng = np.random.default_rng(rng_seed)
    s = np.abs(rng.standard_normal(300)) * 0.01 + 1e-4
    bump = 50 if later else 0
    return {
        "http://r1": _payload(module, 80 + bump, 10.0 + 5 * later, s[:80], pid=1, sampled=4,
                              padded=7),
        "http://r2": _payload(module, 120 + bump, 10.0 + 5 * later, s[80:200], pid=2, errors=2,
                              shed=3, version=2),
        "http://r3": None,  # a failed scrape is reported, never dropped
    }


def _strip_hist(merged):
    eps = {name: {k: v for k, v in ep.items() if k != "hist"}
           for name, ep in merged["endpoints"].items()}
    counts = {name: list(ep["hist"].counts) for name, ep in merged["endpoints"].items()}
    return dict(merged, endpoints=eps), counts


def test_merge_metrics_matches_reference():
    got, got_counts = _strip_hist(cluster.merge_metrics(_scrapes(tmetrics)))
    want, want_counts = _strip_hist(jcluster.merge_metrics(_scrapes(jmetrics)))
    assert got == want and got_counts == want_counts
    assert got["scrape_failures"] == ["http://r3"]


SLOS = [("ep", 0.001, None), ("ep", None, 0.99), ("ep", 0.05, 0.999), ("other", 1.0, None)]


@pytest.mark.parametrize("windowed", [False, True])
def test_summarize_cluster_matches_reference(windowed):
    slos_t = [cluster.SLO(*s) for s in SLOS]
    slos_j = [jcluster.SLO(*s) for s in SLOS]
    router = {"router": {"requests": 5}, "queue_depth": 1, "replicas": {"x": {}}}
    got = cluster.summarize_cluster(_scrapes(tmetrics), slos=slos_t, router_stats=router)
    want = jcluster.summarize_cluster(_scrapes(jmetrics), slos=slos_j, router_stats=router)
    if windowed:
        got = cluster.summarize_cluster(_scrapes(tmetrics, later=True), slos=slos_t,
                                        prev_state=got["state"])
        want = jcluster.summarize_cluster(_scrapes(jmetrics, later=True), slos=slos_j,
                                          prev_state=want["state"])
    assert got == want
    assert got["endpoints"]["ep"]["version_lag"] == 1
    assert cluster.prometheus_text(got) == jcluster.prometheus_text(want)


WINDOWS = [
    {"requests": 100, "errors": 0, "shed": 0, "seconds": 10.0, "qps": 10.0,
     "samples": [0.001] * 90 + [0.5] * 10},
    {"requests": 95, "errors": 3, "shed": 5, "seconds": 10.0, "qps": 9.5, "samples": None},
    {"requests": 99, "errors": 1, "shed": 0, "seconds": 10.0, "qps": 9.9,
     "samples": [0.001] * 100},
    {"requests": 0, "errors": 0, "shed": 0, "seconds": 0.0, "qps": 0.0, "samples": []},
]


def _window(module, w):
    out = {k: v for k, v in w.items() if k != "samples"}
    if w["samples"] is None:
        out.update(counts=None, count=0)
    else:
        h = _hist(module, w["samples"])
        out.update(counts=list(h.counts), count=h.count)
    return {"ep": out}


@pytest.mark.parametrize("threshold", [None, "1000", "0.5"])
@pytest.mark.parametrize("w", range(len(WINDOWS)))
def test_evaluate_slos_matches_reference(w, threshold, monkeypatch):
    if threshold is not None:
        monkeypatch.setenv("HEAT_TPU_SLO_BURN_THRESHOLD", threshold)
    got = cluster.evaluate_slos([cluster.SLO(*s) for s in SLOS],
                                _window(tmetrics, WINDOWS[w]))
    want = jcluster.evaluate_slos([jcluster.SLO(*s) for s in SLOS],
                                  _window(jmetrics, WINDOWS[w]))
    assert got == want


def test_slo_validation_matches_reference():
    for args in (("ep",), ("ep", 0.0), ("ep", None, 1.0)):
        with pytest.raises(ValueError):
            cluster.SLO(*args)
        with pytest.raises(ValueError):
            jcluster.SLO(*args)
    assert cluster.SLO("ep", p99_s=0.5).describe() == jcluster.SLO("ep", p99_s=0.5).describe()


def test_tail_count_matches_reference():
    counts = [0] * tmetrics._NBUCKETS
    counts[20], counts[3] = 10, 4
    for thr in (0.0, 1e-6, 5e-5, 1e-3, 0.5, 10.0):
        assert cluster._tail_count(counts, thr) == jcluster._tail_count(counts, thr)


class _ScriptedRouter:
    def clock_sync(self):
        return {"http://r1": {"offset": 0.25, "uncertainty": 0.001, "rtt": 0.002, "pid": 4242}}

    def scrape_traces(self):
        return {"http://r1": {"pid": 4242, "wall": 2000.0, "events": [{
            "ts": 2000.0, "kind": "trace_span", "name": "serve.execute", "seconds": 0.1,
            "start_ts": 2000.0, "trace_id": "aaaa0000bbbb1111", "parent": "router.post"}]},
            "http://r2": None}


def test_export_merged_trace_matches_reference(tmp_path, monkeypatch):
    import heat_tpu.telemetry as jtelemetry

    events = [{"ts": 1999.5, "kind": "span", "name": "route", "seconds": 0.5, "depth": 0,
               "parent": None, "start_ts": 1999.0}]
    monkeypatch.setattr(telemetry.get_registry(), "events", list(events))
    monkeypatch.setattr(jtelemetry.get_registry(), "events", list(events))
    got = cluster.export_merged_trace(_ScriptedRouter(), str(tmp_path / "port.json"))
    want = jcluster.export_merged_trace(_ScriptedRouter(), str(tmp_path / "ref.json"))
    assert open(got).read() == open(want).read()
    doc = json.loads(open(got).read())
    assert {e["pid"] for e in doc["traceEvents"]} == {os.getpid(), 4242}


# ------------------------------------------------------- the router over live fronts


def _server():
    srv = Server(max_batch=4, max_wait_ms=1.0)
    ref = np.random.default_rng(7).standard_normal((32, 8)).astype(np.float32)
    srv.register("cdist", serve.cdist_query(ref))
    return srv


def test_router_fleet_views_over_live_fronts(tmp_path):
    q = np.random.default_rng(3).standard_normal((2, 8)).astype(np.float32)
    reg = telemetry.get_registry()
    reg.clear()
    telemetry.enable()
    servers = [_server(), _server()]
    fronts = [HttpFront(s, port=0) for s in servers]
    for s, f in zip(servers, fronts):
        s.warmup()
        f.start()
    router = Router([f.url for f in fronts], poll_ms=50.0, workers=2,
                    slos=[cluster.SLO("cdist", p99_s=1e-9), cluster.SLO("cdist",
                                                                          availability=0.5)])
    try:
        for fut in [router.submit("cdist", q) for _ in range(12)]:
            fut.result(30)
        # the first pass covers each replica's lifetime: every request is
        # slower than 1 ns, so the latency SLO burns 100x and breaches;
        # nothing failed, so the availability one does not
        rows = router.check_slos()
        assert [r["breach"] for r in rows] == [True, False]
        assert rows[0]["latency_burn"] == pytest.approx(100.0)
        assert rows[0]["window_requests"] == 12
        assert reg.counters["serve_net.slo_burns"] == 1
        summary = router.cluster_summary()
        ep = summary["endpoints"]["cdist"]
        assert ep["requests"] == 12 and ep["replicas"] == 2 and ep["errors"] == 0
        assert ep["latency"]["count"] == 12 and ep["latency"]["p99_s"] > 0
        assert ep["window_requests"] == 0  # nothing since the first pass
        assert set(summary["replicas"]) == {f.url for f in fronts}
        assert summary["router"]["counters"]["requests"] == 12
        text = router.prometheus_text()
        assert 'heat_tpu_requests_total{endpoint="cdist"} 12' in text
        assert 'heat_tpu_slo_burn_rate{endpoint="cdist"}' in text
        path = router.export_cluster_trace(str(tmp_path / "fleet.json"))
        doc = json.loads(open(path).read())
        labels = {e["args"]["name"] for e in doc["traceEvents"]
                  if e["ph"] == "M" and e["name"] == "process_name"}
        assert {"router"} | {f.url for f in fronts} <= labels
        syncs = [e for e in doc["traceEvents"] if e.get("cat") == "clock_sync"]
        assert len(syncs) == 3
    finally:
        router.close()
        for f in fronts:
            f.stop()
        for s in servers:
            s.close()
        telemetry.disable()
        reg.clear()
