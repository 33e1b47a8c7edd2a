"""The port's telemetry substrate against heat_tpu's: the analytic cost
model, ``op_cost``, the collective counters, the memory probes, and the
summary of an event stream.

Every cost function of ``heat_tpu_torch.telemetry.collectives`` must
return what ``heat_tpu.telemetry.collectives``'s returns, field for field
(exact: both are integer arithmetic over the same arguments), over a grid
of shapes, item sizes, world sizes and wire precisions. ``summarize`` and
``bench_fields`` must give the JAX package's dict on one fixture of events
(exact). The memory probes and the counters are held to what the port
holds.
"""

import itertools
import json

import numpy as np
import pytest
import torch

from heat_tpu.telemetry import collectives as jc
from heat_tpu.telemetry import report as jreport

import heat_tpu_torch as htt
from heat_tpu_torch import telemetry
from heat_tpu_torch.telemetry import collectives as tc
from heat_tpu_torch.telemetry import memory, report


@pytest.fixture(autouse=True)
def on_cpu():
    htt.use_device("cpu")
    yield
    htt.use_device(None)


@pytest.fixture
def recording():
    """Telemetry on with an empty registry; off and empty again after."""
    reg = telemetry.get_registry()
    reg.clear()
    telemetry.enable()
    yield reg
    telemetry.disable()
    reg.clear()


def _same(got, want):
    assert (got.kind, got.bytes, got.steps, got.dcn_bytes) == \
        (want.kind, want.bytes, want.steps, want.dcn_bytes)
    assert got.as_fields() == want.as_fields()


WORLDS = [1, 2, 3, 4, 8]
ITEMS = [1, 2, 4, 8]
PRECS = ["off", "bf16", "int8", "blockwise"]
SPLITS = [None, 0, 1]
SHAPES = [(7, 5), (64, 32), (1000, 3), (16, 16, 4)]


def _grid(name, p):
    """Argument tuples (args, kwargs) of one cost function for world p."""
    out = []
    if name == "relayout_cost":
        for shape, item, old, new, prec in itertools.product(SHAPES, ITEMS, SPLITS, SPLITS, PRECS):
            out.append(((shape, item, old, new, p), {"precision": prec, "block": 32}))
    elif name == "relayout_chunk_cost":
        for shape, item, width, prec in itertools.product(SHAPES, ITEMS, [1, 3, 16], PRECS):
            out.append(((shape, item, 0, 1, width, p), {"precision": prec}))
    elif name == "a2a_kernel_cost":
        for shape, item, prec, block in itertools.product(SHAPES, ITEMS, PRECS, [8, 128]):
            out.append(((shape, item, p), {"precision": prec, "block": block}))
    elif name == "ring_cdist_cost":
        for n, k, item, hops, prec in itertools.product([10, 64, 1001], [3, 128], ITEMS,
                                                        [None, max(p - 1, 0), p], PRECS):
            out.append(((n, k, item, p, hops), {"precision": prec, "block": 16}))
    elif name == "tsqr_cost":
        for m, n, item in itertools.product([5, 64, 1000], [3, 32], ITEMS):
            out.append(((m, n, item, p), {}))
    elif name == "gram_ring_cost":
        for m, n, item, hops in itertools.product([64, 1000], [3, 7, 32], ITEMS, [None, p]):
            out.append(((m, n, item, p, hops), {}))
    elif name == "fusion_reduce_cost":
        for shape, item in itertools.product(SHAPES, ITEMS):
            out.append(((shape, item, p), {}))
    elif name in ("allreduce_cost", "reduce_scatter_cost"):
        for numel, item, prec, block in itertools.product([1, 100, 4097], ITEMS, PRECS, [16, 128]):
            out.append(((numel, item, p), {"precision": prec, "block": block}))
    elif name.startswith("hierarchical_") or name.startswith("fsdp_"):
        for numel, item, prec, local in itertools.product([1, 100, 4097], ITEMS, PRECS, [1, 2, 4]):
            if local > p or p % local:
                continue
            key = "precision" if name.startswith("fsdp_") else "cross_precision"
            out.append(((numel, item, p // local, local), {key: prec, "block": 64}))
    elif name in ("ring_attention_cost", "ulysses_attention_cost"):
        for b, t, h, d, item in itertools.product([1, 2], [64, 100], [4, 16], [32, 64], [2, 4]):
            out.append(((b, t, h, d, item, p), {}))
    elif name == "pipeline_cost":
        for batch, feat, item, mb in itertools.product([8, 32], [16, 1024], ITEMS, [1, 4]):
            out.append(((batch, feat, item, p, mb), {}))
    elif name == "pipeline_hop_cost":
        for mb, feat, item, stride, local in itertools.product([2, 8], [16, 1024], [2, 4], [1, 2],
                                                               [None, 1, 2]):
            out.append(((mb, feat, item, p, stride, local), {}))
    elif name == "spmm_cost":
        for m, n, k, item, xs, os_, prec in itertools.product([10, 64], [7, 64], [1, 5], [4, 8],
                                                              [None, 0], [None, 0], ["off", "bf16"]):
            out.append(((m, n, k, item, p), {"x_split": xs, "out_split": os_, "precision": prec}))
    elif name == "spmv_cost":
        for m, n, item, xs, os_, prec in itertools.product([10, 64], [7, 64], [4, 8], [None, 0],
                                                           [None, 0], ["off", "bf16"]):
            out.append(((m, n, item, p), {"x_split": xs, "out_split": os_, "precision": prec}))
    elif name == "sparse_transpose_cost":
        for slab, item, stages in itertools.product([1, 17, 256], ITEMS, [1, 3]):
            out.append(((slab, item, p, stages), {}))
    else:
        raise KeyError(name)
    return out


COST_FUNCTIONS = [n for n in jc.__all__ if n.endswith("_cost")]


def test_the_port_has_every_cost_function_and_constant():
    assert tc.__all__ == jc.__all__
    assert (tc.DEFAULT_WIRE_BLOCK, tc.DEFAULT_DCN_PREMIUM) == \
        (jc.DEFAULT_WIRE_BLOCK, jc.DEFAULT_DCN_PREMIUM)


@pytest.mark.parametrize("p", WORLDS)
@pytest.mark.parametrize("name", COST_FUNCTIONS)
def test_cost_function_matches_reference(name, p):
    cases = _grid(name, p)
    assert cases or name.startswith(("hierarchical_", "fsdp_"))
    for args, kwargs in cases:
        try:
            want = getattr(jc, name)(*args, **kwargs)
        except Exception as e:  # the same refusal in both packages
            with pytest.raises(type(e)):
                getattr(tc, name)(*args, **kwargs)
            continue
        _same(getattr(tc, name)(*args, **kwargs), want)


@pytest.mark.parametrize("prec", PRECS)
@pytest.mark.parametrize("item", ITEMS)
def test_compression_factor_matches_reference(item, prec):
    for block in (1, 8, 128):
        assert tc.compression_factor(item, prec, block) == jc.compression_factor(item, prec, block)


@pytest.mark.parametrize("premium", [None, 1.0, 8.0, 10.5])
def test_weighted_wire_matches_reference(premium):
    for kind, b, dcn in (("all-reduce", 1000, 0), ("all-gather", 4096, 1024), ("none", 0, 0)):
        got = tc.weighted_wire(tc.CollectiveCost(kind, b, 1, dcn), premium)
        assert got == jc.weighted_wire(jc.CollectiveCost(kind, b, 1, dcn), premium)


def test_weighted_wire_reads_the_premium_knob(monkeypatch):
    cost = tc.CollectiveCost("all-gather", 100, 1, 40)
    assert tc.weighted_wire(cost) == 60 + 8.0 * 40
    monkeypatch.setenv("HEAT_TPU_DCN_PREMIUM", "2")
    assert tc.weighted_wire(cost) == 60 + 2.0 * 40


# ---------------------------------------------------------------- op_cost


def test_op_cost_is_one_flag_check_when_disabled(monkeypatch):
    telemetry.disable()
    calls = []

    def cost_fn(*a):
        calls.append(a)
        return tc.CollectiveCost("all-gather", 8)

    assert telemetry.op_cost(cost_fn, 1, 2) == (None, {}, False)
    assert calls == []
    cost, fields, do_audit = telemetry.op_cost(cost_fn, 1, 2, audit=True)
    assert (cost.bytes, fields, do_audit) == (8, {}, True) and calls == [(1, 2)]
    monkeypatch.setattr(telemetry.hlo, "_AUDIT_ENABLED", True)
    assert telemetry.op_cost(cost_fn, 3, use_global=False) == (None, {}, False)
    assert telemetry.op_cost(cost_fn, 3)[2] is True


def test_op_cost_fields_while_recording(recording):
    cost, fields, do_audit = telemetry.op_cost(tc.relayout_cost, (8, 4), 4, 0, 1, 4)
    assert fields == {"collective": "all-to-all", "bytes": 96, "steps": 1} and not do_audit
    assert cost == tc.relayout_cost((8, 4), 4, 0, 1, 4)


def test_resplit_span_carries_the_cost_fields(recording):
    x = htt.array(np.arange(24, dtype=np.float32).reshape(6, 4), split=0)
    y = htt.resplit(x, None)
    assert np.array_equal(y.numpy(), x.numpy())
    spans = [e for e in recording.events if e["kind"] == "span"]
    assert [e["name"] for e in spans] == ["resplit"]
    # a world of one moves nothing: the model's "none"
    assert spans[0]["collective"] == "none" and spans[0]["bytes"] == 0
    assert spans[0]["old_split"] == 0 and spans[0]["new_split"] is None


def test_relayout_counters():
    htt.reset_perf_stats()
    x = htt.array(np.zeros((4, 3), np.float32), split=0)
    x.resplit(None)
    x.resplit(1)
    htt.array(np.zeros(3)).resplit(0)
    x.resplit(0)  # the same split: no relayout
    assert htt.perf_stats() == {"relayouts": 3, "local_slices": 1, "gathers": 1,
                                "all_to_alls": 1}
    htt.reset_perf_stats()
    assert set(htt.perf_stats().values()) == {0}


def test_trace_event_counts_always_and_records_while_enabled(recording):
    telemetry.reset_collective_counts()
    telemetry.disable()
    telemetry.trace_event("all_gather", op="all-gather", in_bytes=4, out_bytes=16, group_size=4)
    assert telemetry.collective_counts() == {"all_gather": 1}
    assert recording.events == []
    telemetry.enable()
    telemetry.trace_event("all_gather", op="all-gather", in_bytes=4, out_bytes=16, group_size=4)
    assert telemetry.collective_counts() == {"all_gather": 2}
    assert recording.counters["traced.all_gather"] == 1
    (ev,) = recording.events
    assert (ev["kind"], ev["name"], ev["group_size"]) == ("collective_trace", "all_gather", 4)
    telemetry.reset_collective_counts()
    assert telemetry.collective_counts() == {}


def test_a_world_of_one_issues_no_collective():
    telemetry.reset_collective_counts()
    x = htt.array(np.ones((5, 2), np.float32), split=0)
    htt.resplit(x, 1)
    htt.spatial.cdist(x, x, ring=True)
    htt.linalg.qr(x)
    assert telemetry.collective_counts() == {}


# ---------------------------------------------------------------- memory


def test_live_bytes_counts_each_storage_once():
    a = htt.array(np.zeros((1000, 10), np.float32), split=0)
    before = memory.live_bytes()
    b = htt.array(np.zeros((500, 10), np.float64), split=None)
    view = htt.core.dndarray.DNDarray(a.larray[:10], (10, 10), htt.float32, 0, a.device, a.comm,
                                      True)  # a view of a's storage: not counted again
    after = memory.live_bytes()
    assert after["arrays"] >= before["arrays"] + 2
    assert after["total"] - before["total"] == 500 * 10 * 8
    assert after["per_device"]["cpu"] == after["total"]
    del b, view


def test_device_memory_stats_on_the_cpu_is_none():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert memory.device_memory_stats() is None


def test_watermark_updates_high_water_marks(recording):
    keep = htt.array(np.zeros((256, 16), np.float32), split=0)
    snap = memory.watermark("probe")
    assert snap["total"] >= 256 * 16 * 4 and "device_stats" not in snap
    assert recording.watermarks["live_bytes.total"] == snap["total"]
    (ev,) = [e for e in recording.events if e["kind"] == "memory"]
    assert ev["name"] == "probe" and ev["total"] == snap["total"]
    del keep


def test_watermark_is_a_plain_probe_when_disabled():
    telemetry.disable()
    reg = telemetry.get_registry()
    reg.clear()
    snap = memory.watermark()
    assert "total" in snap and reg.watermarks == {} and reg.events == []


# ---------------------------------------------------------------- summarize

EVENTS = [
    {"ts": 10.0, "kind": "span", "name": "resplit", "seconds": 0.5, "depth": 0, "parent": None,
     "start_ts": 9.5, "collective": "all-to-all", "bytes": 4096, "steps": 1},
    {"ts": 10.2, "kind": "span", "name": "relayout", "seconds": 0.4, "depth": 1,
     "parent": "resplit", "start_ts": 9.6, "bytes": 4096},
    {"ts": 11.0, "kind": "span", "name": "resplit", "seconds": 0.25, "depth": 0, "parent": None,
     "start_ts": 10.75, "collective": "all-gather", "bytes": 1024},
    {"ts": 11.5, "kind": "compile", "name": "backend_compile", "seconds": 0.125},
    {"ts": 11.6, "kind": "collective_trace", "name": "all_gather", "group_size": 4},
    {"ts": 11.7, "kind": "collective_trace", "name": "all_gather", "group_size": 4},
    {"ts": 11.8, "kind": "collective_trace", "name": "ppermute", "group_size": 4},
    {"ts": 12.0, "kind": "hlo_audit", "name": "resplit", "ops": {"all-to-all": 1},
     "bytes_by_op": {"all-to-all": 3072}, "predicted": "all-to-all", "predicted_bytes": 3072,
     "emitted_bytes": 3072, "drift": 0, "ok": True},
    {"ts": 12.1, "kind": "hlo_audit", "name": "sparse.transpose_a2a",
     "ops": {"all-to-all": 3, "all-gather": 1}, "bytes_by_op": {"all-to-all": 900,
                                                                "all-gather": 96},
     "emitted_bytes": 900, "predicted_bytes": 16560, "drift": 2, "ok": False},
    {"ts": 12.5, "kind": "memory", "name": "watermark", "total": 123456},
    {"ts": 13.0, "kind": "serve_request", "name": "knn", "seconds": 0.002, "ok": True},
    {"ts": 13.1, "kind": "serve_request", "name": "knn", "seconds": 0.004, "ok": True},
    {"ts": 13.2, "kind": "serve_request", "name": "knn", "seconds": 0.010, "ok": False},
    {"ts": 13.3, "kind": "serve_batch", "name": "knn", "rows": 3, "padded_rows": 1},
    {"ts": 13.4, "kind": "serve", "name": "knn", "event": "shed"},
    {"ts": 13.5, "kind": "sparse", "name": "spmv", "event": "spmv", "nnz": 10},
    {"ts": 13.6, "kind": "sparse", "name": "transpose", "event": "transpose", "nnz": 10},
    {"ts": 13.7, "kind": "streaming", "name": "moments", "event": "stream_chunk", "rows": 1000,
     "seconds": 0.5},
    {"ts": 13.8, "kind": "resilience", "name": "x", "event": "retry"},
    {"ts": 13.9, "kind": "resilience", "name": "x", "event": "gave_up"},
    {"ts": 14.0, "kind": "serve_net", "name": "router", "event": "route"},
    {"ts": 14.1, "kind": "serve_net", "name": "router", "event": "evict"},
    {"ts": 14.2, "kind": "autotune", "name": "cdist", "event": "db_hit"},
    {"ts": 14.3, "kind": "autoscale", "name": "controller", "event": "scale_up"},
    {"ts": 14.4, "kind": "trace_span", "name": "serve.queue", "seconds": 0.001,
     "start_ts": 14.399, "trace_id": "abc", "ingress": True},
    {"ts": 14.5, "kind": "program_cache", "name": "serve.knn", "event": "retrace"},
    {"ts": 14.6, "kind": "program_cache", "name": "serve.knn", "event": "eviction", "count": 2},
]
WATERMARKS = {"live_bytes.total": 999.0, "serve.queue_depth": 7.0,
              "sparse.laplacian_live_bytes": 55.0, "streaming.chunk_bytes": 4096.0}


@pytest.mark.parametrize("watermarks", [None, WATERMARKS])
def test_summarize_matches_reference(watermarks):
    got = report.summarize(EVENTS, watermarks)
    want = jreport.summarize(EVENTS, watermarks)
    assert got == want
    assert got["hlo_collectives"]["drift"] == 2 and got["phases"]["resplit"]["calls"] == 2


@pytest.mark.parametrize("cut", [0, 1, 3, 8, 12, 19])
def test_summarize_of_a_prefix_matches_reference(cut):
    assert report.summarize(EVENTS[:cut], {}) == jreport.summarize(EVENTS[:cut], {})


def test_load_events_skips_blank_and_truncated_lines(tmp_path):
    path = tmp_path / "sink.jsonl"
    path.write_text(json.dumps(EVENTS[0]) + "\n\n" + json.dumps(EVENTS[3]) + "\n{\"ts\": 1,")
    assert report.load_events(str(path)) == jreport.load_events(str(path)) == \
        [EVENTS[0], EVENTS[3]]


def test_live_summary_and_sink_replay_agree(tmp_path, recording):
    sink = tmp_path / "run.jsonl"
    telemetry.enable(str(sink))
    x = htt.array(np.arange(40, dtype=np.float32).reshape(10, 4), split=0)
    htt.resplit(x, 1)
    A = htt.sparse.csr_from_dense(np.eye(6, dtype=np.float32))
    htt.sparse.spmv(A, htt.ones(6))
    telemetry.disable()
    live = report.summarize()
    offline = report.summarize(report.load_events(str(sink)), dict(recording.watermarks))
    assert live["phases"] == offline["phases"]
    assert live["sparse"] == offline["sparse"] == {"from_dense": 1, "spmv": 1}
    assert sorted(live["phases"]) == ["resplit", "sparse.spmv"]


def test_bench_fields():
    telemetry.disable()
    assert report.bench_fields() == {}
    telemetry.enable()
    try:
        assert set(report.bench_fields()) == {"telemetry"}
    finally:
        telemetry.disable()
        telemetry.get_registry().clear()


def test_the_package_exports_the_reference_names():
    import heat_tpu.telemetry as jt

    for name in ("collectives", "hlo", "memory", "report", "trace", "cluster", "op_cost",
                 "export_trace", "SLO", "summarize_cluster", "span", "trace_event",
                 "CompileWatcher", "measure_compile", "enable", "disable", "flush"):
        assert hasattr(jt, name) and hasattr(telemetry, name), name
