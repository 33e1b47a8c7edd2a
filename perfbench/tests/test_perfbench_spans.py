"""``perfbench/spans.py``: the program's spans read from a traced window's
Chrome trace, on a synthetic trace and on a tiny traced run on the CPU."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from perfbench import harness  # noqa: E402
from perfbench import spans  # noqa: E402
from perfbench import trace as tracing  # noqa: E402


def _trace():
    def ev(cat, name, ts, dur, tid=1, **args):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid,
                "args": args}

    return {"traceEvents": [
        ev("user_annotation", tracing.WINDOW, 0.0, 1000.0),
        ev("cpu_op", "htt.fit", 10.0, 600.0),
        ev("cpu_op", "htt.pass", 20.0, 200.0),
        ev("cpu_op", "aten::mm", 25.0, 10.0),
        ev("cuda_runtime", "cudaLaunchKernel", 30.0, 5.0, correlation=1),
        ev("kernel", "gemm", 100.0, 100.0, correlation=1),
        ev("user_annotation", "htt.read", 205.0, 10.0),
        ev("cuda_runtime", "cudaLaunchKernel", 400.0, 5.0, correlation=2),
        ev("kernel", "reduce", 450.0, 100.0, correlation=2),
        ev("cuda_runtime", "cudaLaunchKernel", 700.0, 5.0, tid=2, correlation=3),
        ev("kernel", "other", 800.0, 50.0, correlation=3),
        ev("cpu_op", "htt.fit", -100.0, 50.0),  # before the window
        ev("cpu_op", "htt.pass", 1100.0, 10.0),  # after it
    ]}


def test_span_reduction():
    s = spans.summarize(_trace())
    assert sorted(s) == ["fit", "pass", "read"]
    assert [s[k]["count"] for k in ("fit", "pass", "read")] == [1, 1, 1]
    assert s["fit"]["host_s"] == pytest.approx(600e-6)
    assert s["fit"]["self_s"] == pytest.approx(400e-6)  # less its child pass
    assert s["pass"]["self_s"] == pytest.approx(190e-6)  # less its child read
    # by launch: the gemm inside pass, the reduce inside fit alone, the other
    # kernel launched on a thread without spans
    assert s["pass"]["device_s"] == pytest.approx(100e-6)
    assert s["fit"]["device_s"] == pytest.approx(100e-6)
    assert s["fit"]["device_all_s"] == pytest.approx(200e-6)
    # idle [0, 100) before the gemm: fit 10-20, pass 20-100; [200, 450)
    # before the reduce: pass 200-205 and 215-220, read 205-215, fit 220-450;
    # [550, 800) before a launch on thread 2, and the window's end: nobody's
    assert s["pass"]["idle_s"] == pytest.approx(90e-6)
    assert s["read"]["idle_s"] == pytest.approx(10e-6)
    assert s["fit"]["idle_s"] == pytest.approx(240e-6)
    assert s["fit"]["idle_all_s"] == pytest.approx(340e-6)
    assert s["pass"]["idle_all_s"] == pytest.approx(100e-6)


def test_a_trace_without_spans_or_window():
    events = _trace()["traceEvents"]
    assert spans.summarize({"traceEvents": events[:1]}) == {}
    with pytest.raises(ValueError):
        spans.summarize({"traceEvents": events[1:]})


@pytest.mark.parametrize("name,sizes,per_op", [
    ("kmeans.higgs", {"rows": 20000},
     {"kmeans.fit": 1, "kmeans.init": 1, "kmeans.label": 1, "lloyd.pass": 30, "lloyd.update": 30,
      "lloyd.read": 30}),
    ("cdist_block.susy-160k", {"rows": 2000}, {"cdist": 1}),
])
def test_a_traced_run_on_the_cpu_writes_its_spans(tmp_path, name, sizes, per_op):
    out = tmp_path / "spans.json"
    argv = [sys.executable, str(ROOT / "perfbench" / "spans.py"), str(out), "--workload", name,
            "--seed", str(2 ** 31 + 11), "--seconds", "0.3", "--trace", "1", "--rank", "0",
            "--world", "1", "--port", str(harness.free_port()), "--device", "cpu", "--sizes",
            json.dumps(sizes)]
    run = subprocess.run(argv, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
    result = json.loads(run.stdout.splitlines()[-1])
    s = json.loads(out.read_text())
    assert result["correct"] and set(s) == set(per_op)
    assert {k: s[k]["count"] / result["attempted"] for k in per_op} == per_op
    assert all(v["host_s"] >= v["self_s"] > 0 for v in s.values())


def test_without_a_trace_it_says_so(tmp_path):
    argv = [sys.executable, str(ROOT / "perfbench" / "spans.py"), str(tmp_path / "s.json"),
            "--workload", "cdist_block.susy-160k", "--seed", "7", "--seconds", "0.1", "--trace",
            "0", "--rank", "0", "--world", "1", "--port", str(harness.free_port()), "--device",
            "cpu", "--sizes", json.dumps({"rows": 2000})]
    run = subprocess.run(argv, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert run.returncode == 2 and "no traced window" in run.stderr
