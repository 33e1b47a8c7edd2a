"""The port's runtime substrate against heat_tpu: the knob registry,
telemetry, the memory budget and the checkpoints.

- Knobs: every name the port registers that the JAX package also registers
  has its type and default; the port reads no ``HEAT_TPU_*`` variable
  outside ``_knobs.py``, and each read happens at call time.
- ``memory_guard``: budget parsing and ``temp_budget`` equal to heat_tpu's
  on a table of strings.
- Telemetry: counters, watermarks, spans and the JSONL sink.
- Checkpoints: a flipped byte raises ``CheckpointCorruptError``, a
  truncated manifest ``CheckpointError``; the directory swap leaves the
  older checkpoint whole and reaps stale siblings; a checkpoint of either
  package loads in the other; a split DNDarray written by three gloo ranks
  restores on one rank and on three, and one written by one rank restores
  on three, bit for bit.
- ``KMeans(checkpoint_every=)``: the checkpointed fit and a fit killed
  after 8 iterations then resumed equal the uninterrupted fit bit for bit
  (as tests/test_resilience.py holds heat_tpu's), and the uninterrupted
  fit equals heat_tpu's (labels and ``n_iter`` exactly, centers within
  1e-5 on separated blobs).
"""

import json
import os
import re
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import heat_tpu as ht_tpu
from heat_tpu import _knobs as jax_knobs
from heat_tpu.resilience import memory_guard as jax_memory_guard

import heat_tpu_torch as htt
from heat_tpu_torch import _knobs, resilience, telemetry
from heat_tpu_torch.resilience import checkpoint, memory_guard

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def on_cpu():
    htt.use_device("cpu")
    yield
    htt.use_device(None)


# -- knobs ---------------------------------------------------------------------


def test_shared_knobs_have_the_jax_type_and_default():
    shared = [name for name in _knobs.REGISTRY if name in jax_knobs.REGISTRY]
    assert len(shared) == len(_knobs.REGISTRY)
    for name in shared:
        mine, theirs = _knobs.REGISTRY[name], jax_knobs.REGISTRY[name]
        assert (mine.type, mine.default) == (theirs.type, theirs.default), name


@pytest.mark.parametrize("name,raw", [
    ("HEAT_TPU_RING_OVERLAP", "0"), ("HEAT_TPU_RING_OVERLAP", "off"),
    ("HEAT_TPU_RING_OVERLAP", "yes"), ("HEAT_TPU_TELEMETRY", "1"),
    ("HEAT_TPU_TELEMETRY", "nope"), ("HEAT_TPU_STREAM_CHUNK_ROWS", "4096"),
    ("HEAT_TPU_STREAM_CHUNK_ROWS", "x"), ("HEAT_TPU_STREAM_DRAIN_TIMEOUT", "2.5"),
    ("HEAT_TPU_SPARSE_DENSE_THRESHOLD", "0.5"), ("HEAT_TPU_SPARSE_SPMV_PREC", "BF16"),
    ("HEAT_TPU_SPARSE_SPMV_PREC", "int8"), ("HEAT_TPU_CDIST_PREC", "highest"),
])
def test_get_parses_as_the_jax_registry_at_call_time(monkeypatch, name, raw):
    monkeypatch.delenv(name, raising=False)
    assert _knobs.get(name) == jax_knobs.get(name)
    monkeypatch.setenv(name, raw)
    assert _knobs.get(name) == jax_knobs.get(name)


def test_unregistered_knob_raises():
    with pytest.raises(KeyError):
        _knobs.raw("HEAT_TPU_NOT_A_KNOB")


def test_the_port_reads_heat_tpu_variables_only_through_the_registry():
    reads = re.compile(r"os\.environ\.get\(|os\.environ\[|os\.getenv\(")
    offenders = [str(path.relative_to(REPO)) for path in (REPO / "heat_tpu_torch").rglob("*.py")
                 if path.name != "_knobs.py" and reads.search(path.read_text())]
    assert offenders == []


def test_rerouted_reads_follow_the_environment(monkeypatch):
    from heat_tpu_torch.core.communication import ring_overlap
    from heat_tpu_torch.sparse.ops import spmv_wire
    from heat_tpu_torch.spatial.cuda_cdist import cdist_precision

    monkeypatch.setenv("HEAT_TPU_RING_OVERLAP", "0")
    assert ring_overlap() is False
    monkeypatch.setenv("HEAT_TPU_RING_OVERLAP", "1")
    assert ring_overlap() is True
    monkeypatch.setenv("HEAT_TPU_CDIST_PREC", "default")
    assert cdist_precision() == "DEFAULT"
    monkeypatch.setenv("HEAT_TPU_SPARSE_SPMV_PREC", "bf16")
    assert spmv_wire(htt.float32) == "bf16"
    monkeypatch.setenv("HEAT_TPU_SPARSE_SPMV_PREC", "fp8")
    with pytest.raises(ValueError):
        spmv_wire(htt.float32)


# -- memory_guard ----------------------------------------------------------------

BUDGETS = ["", "1024", "512M", "8G", "8GiB", "1.5g", "2t", "64k", "64KB", "1_000_000",
           "0", "-1", "lots", "  256 m  ", "3.0"]


@pytest.mark.parametrize("raw", BUDGETS)
def test_budget_parsing_and_temp_budget_match_jax(monkeypatch, raw):
    monkeypatch.setenv("HEAT_TPU_HBM_BUDGET", raw)
    assert memory_guard.budget_bytes() == jax_memory_guard.budget_bytes()
    assert memory_guard.temp_budget() == jax_memory_guard.temp_budget()
    assert memory_guard.temp_budget(1 << 20) == jax_memory_guard.temp_budget(1 << 20)
    budget, live = memory_guard.headroom()
    assert budget == memory_guard.budget_bytes() and live == 0


def test_temp_budget_rule(monkeypatch):
    monkeypatch.delenv("HEAT_TPU_HBM_BUDGET", raising=False)
    assert memory_guard.temp_budget() == 1 << 28
    monkeypatch.setenv("HEAT_TPU_HBM_BUDGET", "1G")
    assert memory_guard.temp_budget() == 256 << 20
    monkeypatch.setenv("HEAT_TPU_HBM_BUDGET", "64G")
    assert memory_guard.temp_budget() == 1 << 28  # the cap, even on a large card
    monkeypatch.setenv("HEAT_TPU_HBM_BUDGET", "1M")
    assert memory_guard.temp_budget() == 1 << 20  # the floor


def test_memory_error_hierarchy():
    assert issubclass(resilience.HeatTpuMemoryError, resilience.HeatTpuRuntimeError)
    assert issubclass(resilience.HeatTpuRuntimeError, RuntimeError)
    e = resilience.HeatTpuMemoryError("over", site="stream", hints=["raise the budget"])
    assert e.site == "stream" and "raise the budget" in str(e)


# -- telemetry --------------------------------------------------------------------


def test_telemetry_counters_watermarks_and_sink(tmp_path):
    sink = tmp_path / "events.jsonl"
    reg = telemetry.get_registry()
    reg.clear()
    assert telemetry.span("off") is telemetry.span("also off")  # the shared no-op
    telemetry.enable(str(sink))
    try:
        assert telemetry.enabled()
        reg.add("a.b", 2)
        reg.add("a.b")
        reg.high_water("w", 5.0)
        reg.high_water("w", 3.0)
        with telemetry.span("outer", bytes=64) as sp:
            sp.output(torch.ones(3))
            with telemetry.span("inner"):
                pass
        telemetry.trace_event("allreduce", bytes=8)
        final = telemetry.flush("test")
        snap = reg.snapshot()
    finally:
        telemetry.disable()
        reg.clear()
    assert snap["counters"]["a.b"] == 3.0 and snap["watermarks"]["w"] == 5.0
    assert snap["counters"]["span.outer.count"] == 1 and snap["counters"]["span.outer.bytes"] == 64
    assert snap["counters"]["traced.allreduce"] == 1 and snap["sink"] == str(sink)
    assert final["counters"]["a.b"] == 3.0
    lines = [json.loads(ln) for ln in sink.read_text().splitlines()]
    assert [(ev["kind"], ev["name"]) for ev in lines] == [
        ("span", "inner"), ("span", "outer"), ("collective_trace", "allreduce"),
        ("final", "test")]
    assert lines[0]["parent"] == "outer" and lines[1]["depth"] == 0
    assert not telemetry.enabled() and telemetry.flush() is None


def test_telemetry_clear_by_kind():
    reg = telemetry.Telemetry()
    reg.emit("span", "a")
    reg.emit("compile", "b")
    reg.add("c")
    reg.clear(kinds=("span",))
    assert [e["kind"] for e in reg.events] == ["compile"] and reg.counters["c"] == 1
    reg.clear()
    assert reg.snapshot()["n_events"] == 0 and not reg.counters


# -- checkpoints ------------------------------------------------------------------


def _state():
    rng = np.random.default_rng(3)
    return {"centers": rng.standard_normal((5, 3)).astype(np.float32),
            "x": htt.array(rng.standard_normal((7, 2)).astype(np.float32), split=0),
            "step": 4, "lr": 0.5, "name": "k", "none": None,
            "t": torch.arange(6, dtype=torch.int64).reshape(2, 3)}


def test_roundtrip_with_like_and_extra(tmp_path):
    state = _state()
    path = str(tmp_path / "ck")
    assert checkpoint.save_checkpoint(state, path, extra={"n_iter": 3}) == path
    assert checkpoint.exists(path)
    back, extra = checkpoint.load_checkpoint(path, like=state, with_extra=True)
    assert extra == {"n_iter": 3}
    np.testing.assert_array_equal(back["centers"].numpy(), state["centers"])
    np.testing.assert_array_equal(back["x"].numpy(), state["x"].numpy())
    assert back["x"].split == 0 and back["x"].dtype == htt.float32
    assert (back["step"], back["lr"], back["name"], back["none"]) == (4, 0.5, "k", None)
    assert torch.equal(back["t"], state["t"])
    with pytest.raises(checkpoint.CheckpointError, match="leaves"):
        checkpoint.load_checkpoint(path, like=[1, 2])


def test_crc_corruption_is_detected(tmp_path):
    path = tmp_path / "ck"
    checkpoint.save_checkpoint([np.arange(100.0)], str(path))
    blob = path / "leaf00000.npy"
    raw = bytearray(blob.read_bytes())
    raw[-5] ^= 0x40
    blob.write_bytes(bytes(raw))
    with pytest.raises(checkpoint.CheckpointCorruptError, match="leaf00000.npy"):
        checkpoint.load_checkpoint(str(path))
    with pytest.raises(ht_tpu.resilience.CheckpointCorruptError):
        ht_tpu.resilience.load_checkpoint(str(path))


def test_truncated_or_missing_manifest(tmp_path):
    path = tmp_path / "ck"
    checkpoint.save_checkpoint([1.0], str(path))
    (path / "manifest.json").write_text('{"format": "heat_tpu.checkp')
    with pytest.raises(checkpoint.CheckpointError, match="truncated"):
        checkpoint.load_checkpoint(str(path))
    with pytest.raises(checkpoint.CheckpointError, match="no manifest"):
        checkpoint.load_manifest(str(tmp_path / "nothing"))
    assert not checkpoint.exists(str(tmp_path / "nothing"))


def test_atomic_swap_and_stale_siblings(tmp_path):
    path = tmp_path / "ck"
    checkpoint.save_checkpoint([np.zeros(3)], str(path), extra={"v": 1})
    # debris of crashed earlier saves (other pids), one of them complete
    stale_tmp = tmp_path / "ck.tmp.999999"
    stale_old = tmp_path / "ck.old.888888"
    stale_tmp.mkdir()
    checkpoint.save_checkpoint([np.ones(3)], str(stale_old), extra={"v": 0})
    checkpoint.save_checkpoint([np.full(3, 2.0)], str(path), extra={"v": 2})
    assert not stale_tmp.exists() and not stale_old.exists()
    assert sorted(os.listdir(tmp_path)) == ["ck"]
    _, extra = checkpoint.load_checkpoint(str(path), with_extra=True)
    assert extra == {"v": 2}
    # a save killed between its two renames: only a committed sibling is left
    os.rename(path, tmp_path / "ck.old.777777")
    assert checkpoint.exists(str(path))
    with pytest.warns(UserWarning, match="recovering"):
        leaves, extra = checkpoint.load_checkpoint(str(path), with_extra=True)
    assert extra == {"v": 2} and torch.equal(leaves[0], torch.full((3,), 2.0, dtype=torch.float64))


def test_a_failed_save_leaves_the_previous_checkpoint(tmp_path):
    path = tmp_path / "ck"
    checkpoint.save_checkpoint([np.arange(3.0)], str(path))
    with pytest.raises(checkpoint.CheckpointError, match="cannot checkpoint"):
        checkpoint.save_checkpoint([np.arange(3.0), object()], str(path))
    assert torch.equal(checkpoint.load_checkpoint(str(path))[0], torch.arange(3.0,
                                                                               dtype=torch.float64))
    assert sorted(os.listdir(tmp_path)) == ["ck"]


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_checkpoints_cross_between_the_packages(tmp_path, direction):
    rng = np.random.default_rng(5)
    a = rng.standard_normal((6, 4))
    b = rng.integers(0, 9, 5).astype(np.int32)
    x = rng.standard_normal((11, 3)).astype(np.float32)
    path = str(tmp_path / "ck")
    extra = {"algo": "test", "n": 2}
    if direction == "port_to_jax":
        checkpoint.save_checkpoint([a, b, 1.5, htt.array(x, split=0)], path, extra=extra)
        leaves, got = ht_tpu.resilience.load_checkpoint(path, with_extra=True)
        np.testing.assert_array_equal(leaves[3].numpy(), x)
        assert leaves[3].split == 0
    else:
        ht_tpu.resilience.save_checkpoint([a, b, 1.5, ht_tpu.array(x, split=0)], path, extra=extra)
        leaves, got = checkpoint.load_checkpoint(path, with_extra=True)
        np.testing.assert_array_equal(leaves[3].numpy(), x)
        assert leaves[3].split == 0 and leaves[3].lshape == (11, 3)
    assert got == extra
    np.testing.assert_array_equal(np.asarray(leaves[0]), a)
    np.testing.assert_array_equal(np.asarray(leaves[1]), b)
    assert np.asarray(leaves[1]).dtype == np.int32 and leaves[2] == 1.5


# -- DNDarray leaves across world sizes (three gloo ranks) --------------------------

_WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    rank, world, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    import heat_tpu_torch as ht
    ht.use_device("cpu")
    from heat_tpu_torch.resilience import checkpoint
    rng = np.random.default_rng(0)
    x7 = rng.standard_normal((7, 3)).astype(np.float32)
    x2 = rng.standard_normal((2, 5)).astype(np.float64)
    state = [ht.array(x7, split=0), ht.array(x2, split=1), ht.array(x7, split=None),
             np.arange(4), 2.5]
    checkpoint.save_checkpoint(state, f"{out}/by3", extra={"world": world})
    back = checkpoint.load_checkpoint(f"{out}/by3")
    one = checkpoint.load_checkpoint(f"{out}/by1")
    res = {}
    for name, leaves in (("by3", back), ("by1", one)):
        for i in range(3):
            res[f"{name}_{i}_local"] = leaves[i].larray.numpy()
            res[f"{name}_{i}_global"] = leaves[i].numpy()
            res[f"{name}_{i}_split"] = np.array(-1 if leaves[i].split is None else leaves[i].split)
    # a save that fails on one rank raises on every rank
    try:
        checkpoint.save_checkpoint([ht.array(x7, split=0), object() if rank == 1 else 1.0],
                                   f"{out}/bad")
        res["failed"] = np.array(0)
    except checkpoint.CheckpointError:
        res["failed"] = np.array(1)
    np.savez(f"{out}/rank{rank}.npz", **res)
    dist.barrier()
    dist.destroy_process_group()
""")


def _spawn(tmp_path, world, worker):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, "-c", worker, str(r), str(world), str(port),
                               str(tmp_path)], cwd=REPO, env=dict(os.environ),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=300)[0])
        finally:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    return [np.load(tmp_path / f"rank{r}.npz") for r in range(world)]


def test_dndarray_leaves_across_world_sizes(tmp_path):
    rng = np.random.default_rng(0)
    x7 = rng.standard_normal((7, 3)).astype(np.float32)
    x2 = rng.standard_normal((2, 5)).astype(np.float64)
    checkpoint.save_checkpoint([htt.array(x7, split=0), htt.array(x2, split=1),
                                htt.array(x7), np.arange(4), 2.5], str(tmp_path / "by1"))
    ranks = _spawn(tmp_path, 3, _WORKER)
    # three ranks' checkpoint: one blob a rank for the split leaves, with its index
    manifest = checkpoint.load_manifest(str(tmp_path / "by3"))
    assert [len(rec.get("shards", [])) for rec in manifest["leaves"]] == [3, 3, 1, 0, 0]
    assert [s["index"][0] for s in manifest["leaves"][0]["shards"]] == [[0, 3], [3, 6], [6, 7]]
    assert manifest["extra"] == {"world": 3}
    # ... restored on one rank (here), and by heat_tpu
    here = checkpoint.load_checkpoint(str(tmp_path / "by3"))
    jax = ht_tpu.resilience.load_checkpoint(str(tmp_path / "by3"))
    for i, want in enumerate((x7, x2, x7)):
        np.testing.assert_array_equal(here[i].numpy(), want)
        np.testing.assert_array_equal(jax[i].numpy(), want)
    assert [here[i].split for i in range(3)] == [0, 1, None]
    np.testing.assert_array_equal(here[3].numpy(), np.arange(4))
    # ... and on three, as is the one rank's checkpoint
    for r, res in enumerate(ranks):
        for name in ("by3", "by1"):
            for i, (want, split) in enumerate(((x7, 0), (x2, 1), (x7, None))):
                np.testing.assert_array_equal(res[f"{name}_{i}_global"], want)
                assert int(res[f"{name}_{i}_split"]) == (-1 if split is None else split)
                sl = tuple(htt.core.communication.chunk(want.shape, split, r, 3)[2])
                np.testing.assert_array_equal(res[f"{name}_{i}_local"], want[sl])
        assert int(res["failed"]) == 1
    assert not (tmp_path / "bad").exists()


# -- KMeans(checkpoint_every=) ---------------------------------------------------------


def _blobs():
    rng = np.random.default_rng(11)
    protos = (rng.standard_normal((4, 6)) * 10).astype(np.float32)
    x = (protos[rng.integers(0, 4, 240)] + rng.standard_normal((240, 6))).astype(np.float32)
    c0 = (protos + 0.7 * rng.standard_normal((4, 6))).astype(np.float32)
    return x, c0


def _same_fit(a, b):
    assert a.n_iter_ == b.n_iter_
    assert torch.equal(a.cluster_centers_.larray, b.cluster_centers_.larray)
    assert torch.equal(a.labels_.larray, b.labels_.larray)
    assert a.inertia_ == b.inertia_


@pytest.mark.parametrize("split", [None, 0])
def test_kmeans_checkpointed_equals_uninterrupted(tmp_path, split):
    x = htt.random.randn(120, 6, split=split)
    base = htt.cluster.KMeans(n_clusters=3, max_iter=30, random_state=2).fit(x)
    ck = htt.cluster.KMeans(n_clusters=3, max_iter=30, random_state=2, checkpoint_every=4,
                            checkpoint_path=str(tmp_path / "km")).fit(x)
    _same_fit(base, ck)
    _, extra = checkpoint.load_checkpoint(str(tmp_path / "km"), with_extra=True)
    assert extra["algo"] == "kmeans" and extra["n_iter"] == base.n_iter_


def test_kmeans_killed_run_resumes_identically(tmp_path):
    path = str(tmp_path / "km")
    x = htt.random.randn(120, 6, split=0)
    base = htt.cluster.KMeans(n_clusters=3, max_iter=30, tol=0.0, random_state=2).fit(x)
    # "killed" after 8 iterations: a budget-truncated first run
    htt.cluster.KMeans(n_clusters=3, max_iter=8, tol=0.0, random_state=2, checkpoint_every=4,
                       checkpoint_path=path).fit(x)
    assert checkpoint.load_checkpoint(path, with_extra=True)[1]["n_iter"] == 8
    resumed = htt.cluster.KMeans(n_clusters=3, max_iter=30, tol=0.0, random_state=2,
                                 checkpoint_every=4, checkpoint_path=path, resume=True).fit(x)
    _same_fit(base, resumed)


def test_kmeans_resumes_from_the_jax_packages_checkpoint(tmp_path):
    """heat_tpu's checkpointed fit killed after 8 iterations; the port
    resumes it and ends where heat_tpu's uninterrupted fit ends."""
    x, c0 = _blobs()
    path = str(tmp_path / "km")
    ht_tpu.cluster.KMeans(n_clusters=4, init=ht_tpu.array(c0), max_iter=2, tol=0.0,
                          checkpoint_every=1, checkpoint_path=path).fit(ht_tpu.array(x, split=0))
    want = ht_tpu.cluster.KMeans(n_clusters=4, init=ht_tpu.array(c0), max_iter=20,
                                 tol=0.0).fit(ht_tpu.array(x, split=0))
    got = htt.cluster.KMeans(n_clusters=4, init=htt.array(c0), max_iter=20, tol=0.0,
                             checkpoint_every=3, checkpoint_path=path,
                             resume=True).fit(htt.array(x, split=0))
    assert got.n_iter_ == int(want.n_iter_)
    np.testing.assert_array_equal(got.labels_.numpy(), want.labels_.numpy())
    np.testing.assert_allclose(got.cluster_centers_.numpy(), want.cluster_centers_.numpy(),
                               rtol=0, atol=1e-5)


def test_kmeans_checkpoint_arguments():
    with pytest.raises(ValueError, match="checkpoint_path"):
        htt.cluster.KMeans(checkpoint_every=2)
    with pytest.raises(ValueError, match="positive"):
        htt.cluster.KMeans(checkpoint_every=0, checkpoint_path="p")
    with pytest.raises(ValueError, match="requires checkpoint_every"):
        htt.cluster.KMeans(resume=True)


def test_kmeans_resume_refuses_another_algorithms_checkpoint(tmp_path):
    path = str(tmp_path / "ck")
    checkpoint.save_checkpoint([np.zeros((3, 6), np.float32)], path, extra={"algo": "other"})
    with pytest.raises(checkpoint.CheckpointError, match="not kmeans"):
        htt.cluster.KMeans(n_clusters=3, checkpoint_every=2, checkpoint_path=path,
                           resume=True).fit(htt.random.randn(20, 6))
