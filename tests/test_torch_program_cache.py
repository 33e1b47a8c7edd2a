"""``heat_tpu_torch.core.program_cache``, the guarded dispatch and the
fault injector, against heat_tpu's on the CPU.

- The registry: hits, misses and reuse per ``(site, comm, key)``, a build
  per input signature (the first call on the CPU, reported to
  ``CompileWatcher`` as the JAX package's ``backend_compile_duration``),
  the LRU bound ``HEAT_TPU_PROGRAM_CACHE``, ``site_stats``, ``reset``, the
  telemetry counters and events, ``measure_compile``; the program's
  ``program_bytes`` (its registered analytic bytes on the CPU) and the
  memory preflight; ``enable_persistent_cache`` names the kernel build
  directory. The capture of CUDA graphs is held on the card
  (``tests/test_torch_cuda.py -k program_cache``).
- The injector: ``faults._draw`` equal to heat_tpu's bit for bit over a
  table of seeds, sites and indices; a ``p=`` rule fires at the same call
  indices in both packages; ``parse_spec`` gives heat_tpu's rules and
  refuses what it refuses.
- ``classify``: heat_tpu's verdict on the shared cases; torch's
  ``OutOfMemoryError`` transient; a sticky CUDA error (illegal memory
  access, device-side assert, unspecified launch failure, misaligned
  address) permanent, even where its text holds a transient marker.
- ``guarded_call``: a transient fault retried with the same result, an
  exhausted one escalated to ``HeatTpuRuntimeError`` with every attempt,
  a first-attempt permanent error unchanged, ``nan`` poisoning the output.
"""

import numpy as np
import pytest
import torch

from heat_tpu.resilience import faults as jax_faults
from heat_tpu.resilience import guard as jax_guard

import heat_tpu_torch as htt
from heat_tpu_torch import _build, resilience, telemetry
from heat_tpu_torch.core import program_cache as pc
from heat_tpu_torch.resilience import faults, guard, memory_guard


@pytest.fixture(autouse=True)
def clean(monkeypatch):
    htt.use_device("cpu")
    for name in ("HEAT_TPU_RETRIES", "HEAT_TPU_HBM_BUDGET", "HEAT_TPU_PROGRAM_CACHE"):
        monkeypatch.delenv(name, raising=False)
    pc.reset()
    resilience.clear_faults()
    yield
    resilience.clear_faults()
    monkeypatch.undo()
    resilience.refresh()
    pc.reset()
    htt.use_device(None)


def _add():
    return lambda a, b: a + b


# -- the registry ------------------------------------------------------------------


def test_hits_misses_and_reuse():
    p1 = pc.cached_program("t.add", ("f32",), _add)
    p2 = pc.cached_program("t.add", ("f32",), _add)
    p3 = pc.cached_program("t.add", ("f64",), _add)
    assert p1 is p2 and p1 is not p3
    st = pc.stats()
    assert (st["hits"], st["misses"], st["size"]) == (1, 2, 2)
    assert st["sites"]["t.add"] == {"hits": 1, "misses": 2}
    assert pc.site_stats("t.") == {"hits": 1, "misses": 2}
    assert pc.site_stats("serve.") == {"hits": 0, "misses": 0}
    comm = object()
    assert pc.cached_program("t.add", ("f32",), _add, comm=comm) is not p1
    pc.reset()
    assert pc.stats()["size"] == 0 and pc.stats()["hits"] == 0


def test_parameter_sets_are_shared_by_params_key():
    progs = [pc.cached_program("t.p", ("b", b), _add, params_from=1, params_key="w")
             for b in (1, 2, 4)]
    other = pc.cached_program("t.p", ("b", 8), _add, params_from=1, params_key="v")
    plain = pc.cached_program("t.p", ("b", 16), _add)
    shared = {id(p.__wrapped__.shared) for p in progs}
    assert len(shared) == 1 and id(other.__wrapped__.shared) not in shared
    assert id(plain.__wrapped__.shared) not in shared | {id(other.__wrapped__.shared)}
    assert progs[0].__wrapped__.params_from == 1 and plain.__wrapped__.params_from is None
    assert progs[0].__wrapped__.param_bytes() == 0  # nothing on the card
    torch.testing.assert_close(progs[1](torch.ones(2), torch.ones(2)), torch.full((2,), 2.0))
    pc.reset()
    again = pc.cached_program("t.p", ("b", 1), _add, params_from=1, params_key="w")
    assert id(again.__wrapped__.shared) not in shared


def test_host_tensors_are_never_skipped_by_version():
    static, last = [torch.zeros(3)], [None]
    a = torch.from_numpy(np.zeros(3, np.float32))
    pc._copy_into(static, last, (a,))
    a.numpy()[:] = 5.0  # a write the version counter does not see
    pc._copy_into(static, last, (a,))
    assert last == [None] and static[0].tolist() == [5.0, 5.0, 5.0]
    for wrong in (torch.zeros(1), torch.zeros(3, dtype=torch.float64)):
        with pytest.raises(ValueError, match="does not fit"):  # no broadcast, no cast
            pc._copy_into(static, last, (wrong,))


def test_build_counts_once_per_signature():
    prog = pc.cached_program("t.sig", 1, _add)
    a3, a4 = torch.ones(3), torch.ones(4)
    with telemetry.CompileWatcher() as cw:
        assert torch.equal(prog(a3, a3), 2 * a3)
        prog(a3, a3)
        prog(a4, a4)
        prog(a4.double(), a4.double())
        prog(a3, a3)
    assert cw.backend_compiles == 3
    assert cw.backend_seconds >= 0 and cw.events == 3
    assert prog.__wrapped__.builds == 3
    with telemetry.CompileWatcher() as cw2:
        prog(a4, a4)
    assert cw2.backend_compiles == 0
    with pytest.raises(TypeError, match="tensors"):
        prog(a3, 1.0)


def test_lru_bound_from_the_knob(monkeypatch):
    monkeypatch.setenv("HEAT_TPU_PROGRAM_CACHE", "2")
    first = pc.cached_program("t.lru", 0, _add)
    pc.cached_program("t.lru", 1, _add)
    pc.cached_program("t.lru", 0, _add)  # 0 is now the most recent
    pc.cached_program("t.lru", 2, _add)  # evicts 1
    st = pc.stats()
    assert (st["size"], st["maxsize"], st["evictions"]) == (2, 2, 1)
    assert pc.cached_program("t.lru", 0, _add) is first
    assert pc.stats()["evictions"] == 1
    pc.cached_program("t.lru", 1, _add)  # rebuilt: a miss
    assert pc.stats()["misses"] == 4
    monkeypatch.setenv("HEAT_TPU_PROGRAM_CACHE", "junk")
    assert pc.stats()["maxsize"] == pc.DEFAULT_MAXSIZE


def test_telemetry_counters_and_events():
    reg = telemetry.get_registry()
    was = telemetry.enabled()
    telemetry.enable()
    try:
        reg.clear()
        prog = pc.cached_program("t.tel", "k", _add)
        pc.cached_program("t.tel", "k", _add)
        prog(torch.ones(2), torch.ones(2))
        assert reg.counters["program_cache.misses"] == 1
        assert reg.counters["program_cache.hits"] == 1
        assert reg.counters["program_cache.retrace.t.tel"] == 1
        kinds = [(e["kind"], e["name"]) for e in reg.events]
        assert ("program_cache", "t.tel") in kinds
        assert ("compile", "backend_compile") in kinds
        assert reg.counters["compile.backend_compile_duration"] > 0
    finally:
        reg.clear()
        if not was:
            telemetry.disable()


def test_measure_compile_and_program_bytes():
    dt, prog = telemetry.measure_compile(lambda a: a * 2, torch.ones(5))
    assert dt >= 0 and isinstance(prog, pc.Program) and prog.builds == 1
    wrapped = pc.cached_program("t.bytes", 0, _add, cost_bytes=1234)
    args = (torch.ones(2), torch.ones(2))
    assert memory_guard.program_bytes(wrapped, args) == 1234
    assert memory_guard.program_bytes(wrapped.__wrapped__, args) == 1234
    assert memory_guard.program_bytes(lambda *a: None, args) == 0


def test_preflight_raises_past_the_budget(monkeypatch):
    monkeypatch.setenv("HEAT_TPU_HBM_BUDGET", "1K")
    assert resilience.refresh()
    big = pc.cached_program("t.big", 0, _add, cost_bytes=4096)
    small = pc.cached_program("t.small", 0, _add, cost_bytes=64)
    a = torch.ones(3)
    assert torch.equal(small(a, a), 2 * a)
    with pytest.raises(resilience.HeatTpuMemoryError, match="t.big") as ei:
        big(a, a)
    assert isinstance(ei.value, resilience.HeatTpuRuntimeError)
    assert ei.value.site == "t.big" and ei.value.hints
    assert resilience.stats()["hbm_budget"] == 1024


def test_persistent_cache_is_the_kernel_build_directory():
    assert pc.persistent_cache_dir() == str(_build.BUILD_DIR)
    assert "build directory" in pc.enable_persistent_cache.__doc__
    assert _build.compiled_count() == 0  # nothing is compiled on the CPU


# -- the injector -------------------------------------------------------------------


def test_draw_is_the_jax_packages():
    sites = ["serve.km", "relayout", "collective.psum", "", "s" * 40, "ü"]
    for seed in (0, 1, 7, 2**31 - 1):
        for site in sites:
            for index in (1, 2, 3, 17, 1000, 123457):
                assert faults._draw(seed, site, index) == jax_faults._draw(seed, site, index)


def test_probability_rule_fires_at_the_jax_indices():
    spec = "serve.*:kind=latency:delay=0:p=0.3:seed=11;other:calls=2,5:kind=nan"
    mine, theirs = faults.parse_spec(spec), jax_faults.parse_spec(spec)
    assert [r.describe() for r in mine] == [r.describe() for r in theirs]
    fired = {"mine": [], "theirs": []}
    for label, rules in (("mine", mine), ("theirs", theirs)):
        for i in range(200):
            for site in ("serve.a", "serve.b", "other"):
                for r in rules:
                    if r.matches(site) and r.should_fire(site) is not None:
                        fired[label].append((site, i, r.kind))
    assert fired["mine"] == fired["theirs"] and len(fired["mine"]) > 50


@pytest.mark.parametrize("spec", ["kind=resource", ":calls=1", "x:calls", "x:bogus=1",
                                  "x:kind=explode"])
def test_malformed_specs_are_refused_as_in_jax(spec):
    with pytest.raises(ValueError):
        jax_faults.parse_spec(spec)
    with pytest.raises(ValueError):
        faults.parse_spec(spec)


def test_times_caps_and_stats():
    rule = resilience.inject("t.*", kind="reset", times=2)
    assert resilience.armed()
    for _ in range(2):
        with pytest.raises(faults.InjectedConnectionReset):
            faults.check("t.x")
    assert faults.check("t.x") is None and rule.fired == 2
    assert faults.stats()["injected"] == {"t.x": 2}
    resilience.clear_faults()
    assert not resilience.armed() and faults.stats() == {"rules": [], "injected": {}}


# -- classify ------------------------------------------------------------------------


@pytest.mark.parametrize("exc", [
    RuntimeError("RESOURCE_EXHAUSTED: out of memory while allocating"),
    RuntimeError("connection reset by peer"),
    RuntimeError("DEADLINE_EXCEEDED: rpc"),
    ConnectionResetError("peer"),
    ValueError("shapes (3,) and (4,) do not match"),
    RuntimeError("Array has been deleted"),
    RuntimeError("the buffer was donated"),
    OSError("socket closed"),
    KeyError("resource exhausted"),
])
def test_classify_agrees_with_jax(exc):
    assert guard.classify(exc) == jax_guard.classify(exc)


def test_classify_torch_oom_is_transient():
    oom = torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB (GPU 0; 79.11 GiB total capacity)")
    assert guard.classify(oom) == "transient"
    assert guard.classify(faults.InjectedResourceExhausted("x")) == "transient"


@pytest.mark.parametrize("msg", [
    "CUDA error: an illegal memory access was encountered",
    "CUDA error: device-side assert triggered\nCUDA kernel errors might be asynchronously "
    "reported; the service is unavailable",
    "CUDA error: unspecified launch failure (aborted)",
    "CUDA error: misaligned address",
    "CUDA error: an illegal instruction was encountered",
])
def test_classify_sticky_cuda_errors_are_permanent(msg):
    assert guard.classify(RuntimeError(msg)) == "permanent"


# -- guarded_call --------------------------------------------------------------------


def test_guarded_retry_replays_with_the_same_result(monkeypatch):
    monkeypatch.setenv("HEAT_TPU_RETRIES", "2")
    monkeypatch.setenv("HEAT_TPU_RETRY_BASE", "0.001")
    prog = pc.cached_program("t.retry", 0, _add)
    a = torch.arange(4.0)
    with telemetry.CompileWatcher() as cw:
        clean = prog(a, a)
    resilience.inject("t.retry", kind="resource", calls=[1])
    with telemetry.CompileWatcher() as cw2:
        again = prog(a, a)
    assert torch.equal(again, clean)
    assert cw.backend_compiles == 1 and cw2.backend_compiles == 0


def test_exhausted_transient_escalates(monkeypatch):
    monkeypatch.setenv("HEAT_TPU_RETRIES", "1")
    monkeypatch.setenv("HEAT_TPU_RETRY_BASE", "0")
    resilience.inject("t.fail", kind="reset")
    with pytest.raises(resilience.HeatTpuRuntimeError) as ei:
        guard.guarded_call("t.fail", lambda: 1)
    assert ei.value.site == "t.fail"
    assert [a["classification"] for a in ei.value.attempts] == ["transient", "transient"]
    assert "HEAT_TPU_RETRIES" in str(ei.value)


def test_permanent_first_attempt_error_is_unchanged():
    with pytest.raises(ZeroDivisionError):
        guard.guarded_call("t.perm", lambda: 1 / 0)


def test_nan_directive_poisons_floats_only():
    resilience.inject("t.nan", kind="nan", calls=[1])
    out = guard.guarded_call("t.nan", lambda: (torch.ones(2), torch.arange(2)))
    assert torch.isnan(out[0]).all() and torch.equal(out[1], torch.arange(2))
    assert torch.equal(guard.guarded_call("t.nan", lambda: torch.ones(2)), torch.ones(2))


def test_env_spec_arms_at_refresh(monkeypatch):
    monkeypatch.setenv("HEAT_TPU_FAULTS", "serve.*:kind=reset:calls=1")
    assert faults.env_spec() == "serve.*:kind=reset:calls=1"
    faults.install_spec(faults.env_spec())
    assert resilience.refresh()
    with pytest.raises(faults.InjectedConnectionReset):
        faults.check("serve.x")
    stats = resilience.stats()
    assert stats["armed"] and stats["faults"]["rules"][0]["pattern"] == "serve.*"
    np.testing.assert_equal(stats["faults"]["injected"], {"serve.x": 1})
