"""Each cell's traffic run once on the CPU at a tiny size, the references,
the roofline counts, the trace reduction, and the check that nothing the
benchmark loads is JAX or the JAX package."""

import ast
import json
import math
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from perfbench import harness  # noqa: E402
from perfbench.reference import cdist as ref_cdist  # noqa: E402
from perfbench.reference import kmeans as ref_kmeans  # noqa: E402
from perfbench.roofline import counts  # noqa: E402
from perfbench import trace as tracing  # noqa: E402

# tiny sizes of each cell for the CPU: the configuration's keys, the traffic's keys
TINY = {
    "kmeans.higgs": ({"rows": 40000}, {}),
    "cdist_block.susy-160k": ({"rows": 3000}, {"query_rows": 800}),
    "cdist.susy-160k.x4": ({"rows": 3000}, {}),
}


def tiny_cell(name):
    cell = harness.load_cell(name)
    cfg, traffic = TINY[name]
    cell["config"].update(cfg)
    cell["traffic"].update(traffic)
    return cell


@pytest.mark.parametrize("name", ["kmeans.higgs", "cdist_block.susy-160k"])
@pytest.mark.parametrize("trace", [False, True])
def test_one_card_cell_runs_on_cpu(name, trace):
    out = harness.run_rank(tiny_cell(name), 2 ** 31 + 5, 0.3, trace, device="cpu")
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert list(out)[-1] == "checks"
    kind = "per_layer" if trace else "end_to_end"
    reported = set(out["metrics"])
    assert reported <= {m["name"] for m in tiny_cell(name)[kind]}
    if not trace:
        suffix = "" if name == "kmeans.higgs" else ".block"
        # the 95th percentile needs two ops, which a slow CPU may not finish
        assert {"op_ms" + suffix, "setup_s", "peak_mem_gib"} <= reported
    else:
        assert out["device"]["window_s"] > 0 and "breakdown" in out
    assert out["forbidden"] == []


def test_four_rank_cell_runs_on_gloo():
    argv = [sys.executable, str(ROOT / "perfbench" / "run.py"), "--workload",
            "cdist.susy-160k.x4", "--seed", str(2 ** 31 + 9), "--seconds", "0.5", "--trace",
            "0", "--world", "4", "--port", str(harness.free_port()), "--device", "cpu",
            "--sizes", json.dumps(TINY["cdist.susy-160k.x4"][0])]
    lines = harness.launch(argv, 4, 240)
    assert lines, "a rank failed"
    out = json.loads(lines[-1])
    assert out["correct"] and out["device"]["count"] == 4
    assert {"op_ms.x4", "setup_s", "peak_mem_gib"} == set(out["metrics"])


def test_seed_gives_the_same_inputs():
    cfg = tiny_cell("kmeans.higgs")["config"]
    from perfbench.generator import make_table

    a = make_table(cfg, 2 ** 33 + 1, torch.device("cpu"))
    b = make_table(cfg, 2 ** 33 + 1, torch.device("cpu"))
    c = make_table(cfg, 2 ** 33 + 2, torch.device("cpu"))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_cdist_reference_agrees_with_the_program():
    import heat_tpu_torch as ht

    ht.use_device("cpu")
    g = torch.Generator().manual_seed(3)
    x = torch.randn(300, 18, generator=g)
    y = torch.randn(500, 18, generator=g)
    got = ht.spatial.cdist(ht.array(x), ht.array(y), quadratic_expansion=True).larray
    ref = ref_cdist.distances(x, y)
    assert torch.allclose(got, ref, atol=1e-4)
    assert ref_cdist.dist_gap(x, y, lambda s, e: got[s:e]) < 1e-6
    assert math.isnan(ref_cdist.dist_gap(x, y, lambda s, e: got[s:e, :-1]))  # wrong shape


def test_kmeans_reference_agrees_with_the_program():
    import heat_tpu_torch as ht

    ht.use_device("cpu")
    g = torch.Generator().manual_seed(4)
    x = torch.randn(5000, 6, generator=g) + 3 * torch.randn(4, 6, generator=g)[
        torch.randint(0, 4, (5000,), generator=g)]
    init = x[:4].clone()
    fit = lambda p: ht.cluster.KMeans(n_clusters=4, init=ht.array(init), max_iter=p,  # noqa
                                      tol=-1.0).fit(ht.array(x))
    km = fit(10)
    ref_c, ref_l = ref_kmeans.lloyd_fit(x, init, 10)
    assert torch.allclose(km.cluster_centers_.larray, ref_c, atol=1e-4)
    assert torch.equal(km.labels_.larray, ref_l)
    got = ref_kmeans.judge_fit(x, init, fit(1).cluster_centers_.larray,
                               fit(9).cluster_centers_.larray, km.cluster_centers_.larray,
                               km.labels_.larray, km.n_iter_, 10)
    assert got["label_gap"] < 1e-7 and got["first_gap"] < 1e-5 and got["last_gap"] < 1e-5
    assert got["iter_gap"] == 0


def test_roofline_counts_at_the_cells_shapes():
    h100 = counts.peaks("NVIDIA H100 80GB HBM3")
    fit = counts.kmeans_fit(11_000_000, 28, 8, 30)
    assert fit["bytes"] == 31 * 11_000_000 * 28 * 4 + 8 * 11_000_000
    assert fit["flops"] == 2 * 11_000_000 * 8 * 28 * 31
    assert counts.least_seconds(fit["flops"], fit["bytes"], h100) == pytest.approx(
        fit["bytes"] / 3.35e12)  # bound by reading the rows: 11.4 ms
    block = counts.cdist(40_000, 160_000, 18)
    assert block["bytes"] == 4 * 200_000 * 18 + 4 * 40_000 * 160_000
    assert block["flops"] == 2 * 40_000 * 160_000 * 18
    assert counts.least_seconds(block["flops"], block["bytes"], h100) == pytest.approx(
        7.6461e-3, rel=1e-4)  # bound by writing the 25.6 GB block
    assert counts.peaks("some other card") is None


def test_trace_reduction():
    def ev(cat, name, ts, dur, **args):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": 1,
                "args": args}

    trace = {"traceEvents": [
        ev("user_annotation", tracing.WINDOW, 0.0, 1000.0),
        ev("cpu_op", "aten::mm", 10.0, 20.0),
        ev("cuda_runtime", "cudaLaunchKernel", 15.0, 5.0, correlation=1),
        ev("kernel", "gemm", 100.0, 300.0, correlation=1),
        ev("cuda_runtime", "cudaLaunchKernel", 500.0, 5.0, correlation=2),
        ev("kernel", "ncclDevKernel_AllGather", 600.0, 100.0, correlation=2),
        ev("kernel", "gemm", 650.0, 100.0, correlation=3),
        ev("cuda_runtime", "cudaLaunchKernel", 720.0, 5.0, correlation=4),
        ev("kernel", "fill", 800.0, 50.0, correlation=4),
        ev("kernel", "outside", 2000.0, 100.0),
    ]}
    s = tracing.summarize(trace)
    assert s["window_s"] == pytest.approx(1e-3)
    assert s["busy_s"] == pytest.approx(500e-6)  # 100-400, 600-750 and 800-850
    assert s["nccl_s"] == pytest.approx(100e-6) and s["compute_s"] == pytest.approx(450e-6)
    assert s["kernels"] == 4
    assert s["device_ops"][0] == ["gemm", pytest.approx(400e-6)]
    gaps = dict(s["idle_gaps"])
    assert gaps["aten::mm_before_gemm"] == pytest.approx(100e-6)  # launched inside aten::mm
    assert gaps["python_before_ncclDevKernel_AllGather"] == pytest.approx(200e-6)
    assert gaps["wait_before_fill"] == pytest.approx(50e-6)  # launched before the gap began
    assert gaps["window_end"] == pytest.approx(150e-6)


def test_metric_readers_leave_out_what_they_cannot_read():
    rec = {"world": 1, "ops": 4, "window_s": 0.2, "op_walls": [0.05] * 4, "event_op_s": [],
           "setup_s": 1.0, "peak_bytes": 2 ** 30, "peaks": None,
           "ranks": [{"trace": None, "work": {"flops": 1.0, "bytes": 1.0},
                      "registry_misses": 0}]}
    assert harness.reader("op_ms")(rec) == pytest.approx(50.0)
    assert harness.reader("peak_mem_gib")(rec) == 1.0
    for name in ("lloyd_roofline", "cdist_roofline.x4", "nccl_ms_per_op.x4",
                 "op_p95_ms.x4", "device_idle_pct", "launches_per_op"):
        assert harness.reader(name)(rec) is None


@pytest.mark.parametrize("metric,path", [
    ("op_ms", "op_ms.py"),
    ("op_ms.block", "op_ms.py"),  # the cell's qualifier after the dot
    ("op_p95_ms.x4", "op_p95_ms.x4.py"),  # a file of the whole name comes first
    ("device_idle_pct.x4", "device_idle_pct.py"),
    ("lloyd_roofline", "roofline.py"),  # the kernel's word before the quantity
    ("cdist_roofline.x4", "roofline.py"),
])
def test_a_metric_is_read_by_the_file_of_its_quantity(metric, path):
    assert harness.reader_path(metric) == ROOT / "perfbench" / "metrics" / path


def test_a_metric_without_a_reader_is_refused():
    with pytest.raises(harness.CellError):
        harness.reader_path("no_such.metric")


def test_an_op_is_loaded_by_name_and_an_unknown_one_refused():
    from perfbench import generator

    assert generator.op_class("cdist").__module__ == "perfbench_op_cdist"
    with pytest.raises(ValueError, match="no ops/moments_nowhere.py"):
        generator.op_class("moments_nowhere")


def test_the_traffic_options_reach_the_entry_point(monkeypatch):
    import heat_tpu_torch as ht

    cell = tiny_cell("cdist_block.susy-160k")
    cell["traffic"]["options"] = {"quadratic_expansion": True, "ring": True}
    seen = []
    orig = ht.spatial.cdist

    def cdist(x, y=None, **kw):
        seen.append(kw)
        return orig(x, y, **kw)

    monkeypatch.setattr(ht.spatial, "cdist", cdist)
    out = harness.run_rank(cell, 2 ** 31 + 6, 0.1, False, device="cpu")
    assert out["correct"] and seen and all(kw == cell["traffic"]["options"] for kw in seen)


def test_a_kmeans_mix_with_the_programs_own_seeding_is_data_only():
    # k-means++ seeding from the seed: the judge's first pass starts from
    # the program's fit of 0 passes
    cell = tiny_cell("kmeans.higgs")
    cell["traffic"]["init"] = "probability_based"
    a = harness.run_rank(cell, 2 ** 31 + 7, 0.2, False, device="cpu")
    assert a["correct"], a["checks"]


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted((ROOT / "perfbench").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax_or_the_jax_package(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & set(harness.FORBIDDEN)
    assert "benchmarks" not in tops
    if "reference" in path.parts:
        assert "heat_tpu_torch" not in tops


def test_a_dry_run_loads_no_jax():
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r})\n"
            "from perfbench import harness\n"
            "cell = harness.load_cell('cdist_block.susy-160k')\n"
            "cell['config']['rows'] = 2000\n"
            "cell['traffic']['query_rows'] = 500\n"
            "out = harness.run_rank(cell, 7, 0.1, False, device='cpu')\n"
            "print(harness.forbidden_modules(), out['forbidden'])\n")
    done = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=180, cwd=ROOT)
    assert done.returncode == 0, done.stderr[-2000:]
    assert done.stdout.strip().splitlines()[-1] == "[] []"


def test_emit_refuses_a_run_that_loaded_jax(capsys):
    out = {"correct": True, "forbidden": ["jax.numpy"], "cards": {}, "checks": {}}
    assert harness.emit(out) != 0
    assert capsys.readouterr().out == ""


def test_no_card_no_result(capsys):
    from perfbench import run

    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal without one cannot be seen here")
    assert run.main(["--workload", "kmeans.higgs", "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""
