"""``heat_tpu_torch.core.fusion`` against ``heat_tpu.core.fusion`` on the CPU.

Each seeded numpy input goes through the JAX package on its 8-device CPU
mesh (fusion on, its default) and through the port; the port's fused result
equals its own ``HEAT_TPU_FUSION=0`` result bit for bit (``torch.equal``)
and the JAX package's within the stated tolerance (float64: rtol 1e-12;
float32: rtol 1e-6, the moments 1e-5).

- One program per chain signature: a 5-op chain defers and flushes as one
  ``fusion`` registry entry; a second chain of the same signature builds
  nothing (``CompileWatcher``) and hits; float scalars are runtime
  arguments (``x * 2.0`` and ``x * 3.0`` share the program), integer ones
  baked in (``x ** 3`` bit for bit).
- The chain battery over splits None/0/1, replicated operands beside split
  ones, mixed scalar kinds, ``-0.0``, int and bool chains.
- Padded tails across ranks: one gloo world of three ranks (rows 7 as
  3, 3, 1) runs the battery, the reductions across the split axis and the
  moments graft fused and with ``HEAT_TPU_FUSION=0``; every rank's bits
  agree, and equal the world of one.
- The depth cap windows a 9-op chain; ``fusing``/``fuse``; fallbacks of
  closures; metadata queries (``nbytes``, ``live_bytes``) without a flush.
- Through-reduction absorption (``fusion_reduce``) for the reduction
  family, the moments graft (``fusion_moments``) against the JAX package's
  ``statistics._pallas_moments_fused(..., interpret=True)``, the matmul
  epilogue (``dense`` as one program, every activation, a pending chain in
  front of the product).
- The mutation hazard: a chain whose leaf is then written by setitem,
  ``lloc``, ``fill_diagonal`` or ``out=`` keeps the value from before the
  write; so does a chain that consumed a pending intermediate which is
  then computed (read, reduced) and written, against
  ``HEAT_TPU_FUSION=0``; a write from outside the package raises at the
  flush instead of reading the new values; ``larray =`` drops a pending
  chain.
- The memory guard's first rung and the telemetry ``fusion`` block.
(On the card, ``tests/test_torch_cuda.py -k fusion`` holds a flush inside a
CUDA graph capture.)
"""

import numpy as np
import pytest
import torch

import heat_tpu as jht
from heat_tpu.core import statistics as jax_statistics

import heat_tpu_torch as ht
from heat_tpu_torch import _knobs, resilience, telemetry
from heat_tpu_torch.core import fusion
from heat_tpu_torch.core import program_cache as pc

from tests.torch_spmd import spawn


@pytest.fixture(autouse=True)
def on_cpu():
    ht.use_device("cpu")
    fusion.reset_stats()
    yield


def _site(name):
    return dict(pc.stats()["sites"].get(name, {"hits": 0, "misses": 0}))


def _chain(m, a, b):
    """exp -> sub -> mul -> clip -> add, in either package ``m``."""
    return m.clip(m.exp(a) - b * 2.0, -1.0, 50.0) + 0.5


def _eager(fn):
    with _knobs.overlay({"HEAT_TPU_FUSION": "0"}):
        return fn()


def _same(x, y):
    assert torch.equal(torch.as_tensor(x), torch.as_tensor(y))


# -- one program per chain --------------------------------------------------------------


def test_chain_is_one_cached_program():
    rng = np.random.default_rng(0)
    an, bn = rng.standard_normal((13, 4)), rng.standard_normal((13, 4))
    pc.reset()
    r = _chain(ht, ht.array(an), ht.array(bn))
    assert r._fused_node() is not None
    got = r.numpy()
    st = fusion.stats()
    assert st["deferred"] >= 4 and st["flushes"] == 1 and st["fallbacks"] == 0
    assert _site("fusion") == {"hits": 0, "misses": 1}
    with telemetry.CompileWatcher() as w:
        again = _chain(ht, ht.array(an + 1), ht.array(bn)).numpy()
    assert w.backend_compiles == 0
    assert _site("fusion") == {"hits": 1, "misses": 1}
    want = _chain(jht, jht.array(an), jht.array(bn)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12)
    _same(got, _eager(lambda: _chain(ht, ht.array(an), ht.array(bn)).numpy()))
    _same(again, _eager(lambda: _chain(ht, ht.array(an + 1), ht.array(bn)).numpy()))


def test_float_scalars_share_a_program_and_int_scalars_fold():
    an = np.arange(11.0)
    a = ht.array(an)
    (a * 2.0).numpy()
    s0 = _site("fusion")
    _same((a * 3.0).numpy(), an * 3.0)
    assert _site("fusion")["misses"] == s0["misses"]
    xn = (np.abs(np.random.default_rng(11).standard_normal(1001)) + 0.5).astype(np.float32)
    fused = ((ht.array(xn) ** 3) * 1.0).numpy()
    _same(fused, _eager(lambda: ((ht.array(xn) ** 3) * 1.0).numpy()))


_BATTERY = {
    "chain": lambda m, a, b: _chain(m, a, b),
    "replicated_operand": lambda m, a, b: m.sqrt(m.abs(a)) * b - 1,
    "mixed_scalars": lambda m, a, b: (a + 2) * 0.5 - np.float32(1.25),
    "negative_zero": lambda m, a, b: m.copysign(a + 0.0, -0.0),
    "trig": lambda m, a, b: m.sin(a) * m.cos(b) + m.tanh(a - b),
    "compare": lambda m, a, b: m.where(a > b, a, b * 3.0),
    "int_bool": lambda m, a, b: ((m.floor(a * 4) % 3 == 0) & (b > 0)),
    "maximum": lambda m, a, b: m.maximum(m.exp(a), 1.5) + m.minimum(b, 0.0),
}


@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("case", sorted(_BATTERY))
def test_chain_battery_fused_equals_eager_and_the_jax_package(case, split):
    rng = np.random.default_rng(42)
    an, bn = rng.standard_normal((7, 5)), rng.standard_normal((7, 5))
    b_split = None if case == "replicated_operand" else split
    fn = _BATTERY[case]
    fused = fn(ht, ht.array(an, split=split), ht.array(bn, split=b_split))
    eager = _eager(lambda: fn(ht, ht.array(an, split=split), ht.array(bn, split=b_split)))
    assert eager._fused_node() is None
    _same(fused.larray, eager.larray)
    assert fused.dtype == eager.dtype and fused.split == eager.split
    want = fn(jht, jht.array(an, split=split), jht.array(bn, split=b_split)).numpy()
    got = fused.numpy()
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


# -- padded tails across ranks ------------------------------------------------------------

_RANKS = """
from heat_tpu_torch import _knobs
from heat_tpu_torch.core import fusion

def chains(ht, an, bn, split):
    a, b = ht.array(an, split=split), ht.array(bn, split=split)
    rep = ht.array(bn)  # replicated: cut to the chunk as a narrow node
    out = {}
    out["chain"] = ht.clip(ht.exp(a) - b * 2.0, -1.0, 50.0) + 0.5
    out["rep"] = ht.sqrt(ht.abs(a)) * rep - 1
    z = a * 2.0 + 1.0
    out["sum0"] = ht.sum(z, axis=0)
    out["sum1"] = ht.sum(z * z, axis=1)
    out["max"] = ht.max(ht.exp(a) - b, axis=0)
    out["prod"] = ht.prod(a * 0.5 + 1.0, axis=0, keepdims=True)
    out["all"] = ht.sum(z)
    if split in (None, 0):
        zz = a * 2.0 + 1.0
        out["mean"] = ht.mean(zz, axis=0)
        out["var"] = ht.var(zz, axis=0)
    return out

def run(ht, rank, world):
    rng = np.random.default_rng(9)
    an = rng.standard_normal((7, 5)).astype(np.float32)
    bn = rng.standard_normal((7, 5)).astype(np.float32)
    res = {}
    for split in (None, 0, 1):
        fusion.reset_stats()
        fused = {k: v.numpy() for k, v in chains(ht, an, bn, split).items()}
        res[f"absorbed_{split}"] = np.array(fusion.stats()["reductions_absorbed"])
        with _knobs.overlay({"HEAT_TPU_FUSION": "0"}):
            eager = {k: v.numpy() for k, v in chains(ht, an, bn, split).items()}
        for k in fused:
            res[f"f_{split}_{k}"] = fused[k]
            res[f"e_{split}_{k}"] = eager[k]
    return res
"""


def test_padded_tails_across_ranks_fused_equals_eager(tmp_path):
    ranks = spawn(tmp_path, 3, _RANKS)
    ns = {}
    exec(_RANKS, ns)
    rng = np.random.default_rng(9)
    an = rng.standard_normal((7, 5)).astype(np.float32)
    bn = rng.standard_normal((7, 5)).astype(np.float32)
    for split in (None, 0, 1):
        one = {k: v.numpy() for k, v in ns["chains"](ht, an, bn, split).items()}
        for res in ranks:
            # sum0, sum1, max and prod absorb; the last sum reads z's kept value
            assert int(res[f"absorbed_{split}"]) >= 4
            for k, v in one.items():
                fused, eager = res[f"f_{split}_{k}"], res[f"e_{split}_{k}"]
                assert fused.tobytes() == eager.tobytes(), (split, k)
                if k not in ("chain", "rep"):  # reductions merge across ranks in their order
                    np.testing.assert_allclose(fused, v, rtol=1e-5, atol=1e-6)
                else:
                    assert fused.tobytes() == v.tobytes(), (split, k)
    jz = jht.array(an, split=0) * 2.0 + 1.0
    np.testing.assert_allclose(ranks[0]["f_0_var"], jht.var(jz, axis=0).numpy(), rtol=1e-5)


# -- caps, switches, fallbacks ----------------------------------------------------------------


def test_depth_cap_flushes_in_windows(monkeypatch):
    monkeypatch.setenv("HEAT_TPU_FUSION_DEPTH", "4")
    assert fusion.depth_cap() == 4 and fusion.node_cap() == 16
    an = np.arange(10.0)
    r = ht.array(an, split=0)
    for _ in range(9):
        r = r + 1.0
    _same(r.numpy(), an + 9.0)
    assert fusion.stats()["flushes"] == 3  # two windows of four, then the read
    monkeypatch.delenv("HEAT_TPU_FUSION_DEPTH")
    assert fusion.depth_cap() == fusion.DEFAULT_DEPTH


def test_fusing_context_and_the_fuse_decorator(monkeypatch):
    an = np.arange(4.0)
    monkeypatch.setenv("HEAT_TPU_FUSION", "0")
    a = ht.array(an)
    with ht.fusing():
        r = a + 1
        assert r._fused_node() is not None
    _same(r.numpy(), an + 1)
    monkeypatch.delenv("HEAT_TPU_FUSION")
    with ht.fusing(False):
        assert (a + 1)._fused_node() is None

    @ht.fuse
    def step(x):
        return ht.exp(x) * 0.5 - 1

    out = step(ht.array(an))
    assert out._fused_node() is None
    _same(out.numpy(), _eager(lambda: step.__wrapped__(ht.array(an)).numpy()))


def test_closures_fall_back_and_shape_queries_do_not_flush():
    a = ht.array(np.arange(6.0).reshape(2, 3), split=0)
    r = ht.local_op(lambda t: t * 2, a)
    assert r._fused_node() is None and fusion.stats()["fallbacks"] == 1
    _same(r.numpy(), np.arange(6.0).reshape(2, 3) * 2)
    p = ht.exp(a) + 1
    assert (p.shape, p.lshape, p.ndim, p.size, p.split) == ((2, 3), (2, 3), 2, 6, 0)
    assert p.dtype == ht.float64 and p._fused_node() is not None
    assert (p.nbytes, p.lnbytes) == (48, 48)
    assert telemetry.memory.live_bytes()["arrays"] >= 2  # p counted, not computed
    assert fusion.stats()["flushes"] == 0


def test_shared_subchain_is_computed_once():
    an = np.arange(1.0, 7.0)
    t = ht.log(ht.array(an))
    u, v = t + 1, t * 2
    _same(u.numpy(), np.log(an) + 1)
    _same(v.numpy(), np.log(an) * 2)
    # the second consumer materialized t once: t, u and v each one program
    assert fusion.stats()["flushes"] == 3
    _same(t.numpy(), np.log(an))
    assert fusion.stats()["flushes"] == 3


# -- absorption and grafts ----------------------------------------------------------------------


@pytest.mark.parametrize("op", ["sum", "prod", "max", "min", "nansum", "any", "all"])
@pytest.mark.parametrize("axis,keepdims", [(None, False), (0, False), (1, True)])
def test_reduction_absorbs_the_chain(op, axis, keepdims):
    rng = np.random.default_rng(3)
    an = rng.standard_normal((6, 4))
    an[1, 2] = np.nan if op == "nansum" else an[1, 2]

    def run(m):
        x = m.array(an)
        z = x * 0.5 + 0.25 if op not in ("any", "all") else (x > 0.1)
        return getattr(m, op)(z, axis=axis, keepdims=keepdims)

    fused = run(ht)
    if op not in ("any", "all"):
        assert fusion.stats()["reductions_absorbed"] == 1
        assert _site("fusion_reduce")["misses"] + _site("fusion_reduce")["hits"] >= 1
    eager = _eager(lambda: run(ht))
    _same(fused.larray, eager.larray)
    np.testing.assert_allclose(fused.numpy(), run(jht).numpy(), rtol=1e-12)


def test_moments_graft_against_the_jax_packages_fused_program():
    rng = np.random.default_rng(15)
    xn = rng.standard_normal((43, 6)).astype(np.float32)
    pc.reset()
    z = ht.array(xn) * 2.0 + 1.0
    mu, v = ht.mean(z, axis=0), ht.var(z, axis=0)
    st = fusion.stats()
    assert st["reductions_absorbed"] == 1  # mean absorbed; var read the kept value
    assert _site("fusion_moments")["misses"] == 1
    jz = jht.array(xn, split=0) * 2.0 + 1.0
    jmu = jax_statistics._pallas_moments_fused(jz, "mean", interpret=True)
    jz2 = jht.array(xn, split=0) * 2.0 + 1.0
    jv = jax_statistics._pallas_moments_fused(jz2, "var", ddof=0, interpret=True)
    np.testing.assert_allclose(mu.numpy(), np.asarray(jmu), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-6)
    emu, ev = _eager(lambda: (ht.mean(ht.array(xn) * 2.0 + 1.0, axis=0),
                              ht.var(ht.array(xn) * 2.0 + 1.0, axis=0)))
    _same(mu.larray, emu.larray)
    _same(v.larray, ev.larray)


@pytest.mark.parametrize("act", [None, "relu", "tanh", "sigmoid"])
def test_dense_is_one_program_for_every_activation(act):
    rng = np.random.default_rng(4)
    xn, wn, bn = (rng.standard_normal(s).astype(np.float32) for s in ((16, 8), (8, 4), (4,)))
    pc.reset()

    def run(m):
        return m.nn.functional.dense(m.array(xn), m.array(wn), bias=m.array(bn), activation=act)

    with telemetry.CompileWatcher() as w:
        got = run(ht).numpy()
    assert _site("fusion")["misses"] == 1 and w.backend_compiles == 1
    assert fusion.stats()["epilogues_grafted"] == 1
    _same(got, _eager(lambda: run(ht).numpy()))
    np.testing.assert_allclose(got, run(jht).numpy(), rtol=1e-5, atol=1e-6)


def test_pending_chain_grafts_in_front_of_the_product():
    rng = np.random.default_rng(6)
    an, bn = rng.standard_normal((9, 5)), rng.standard_normal((5, 3))

    def run(m):
        a = m.array(an)
        return m.matmul(m.exp(a) * 0.5, m.array(bn)) + 1.0

    got = run(ht)
    assert got._fused_node() is not None and got._fused_node().nnodes == 4
    _same(got.numpy(), _eager(lambda: run(ht).numpy()))
    np.testing.assert_allclose(got.numpy(), run(jht).numpy(), rtol=1e-12)


# -- the mutation hazard --------------------------------------------------------------------------


def test_a_chain_keeps_its_leaf_values_across_in_place_writes():
    an = np.arange(6.0).reshape(2, 3)
    a = ht.array(an)
    r1 = a * 10
    a[0, 0] = 99.0
    r2 = a + 1
    a.lloc[1, 1] = -5.0
    b = ht.array(np.ones((3, 3)))
    r3 = b * 2
    b.fill_diagonal(7.0)
    c = ht.array(an)
    r4 = c - 1
    ht.add(ht.array(np.zeros((2, 3))), 3.0, out=c)
    _same(r1.numpy(), an * 10)
    want2 = an + 1
    want2[0, 0] = 100.0
    _same(r2.numpy(), want2)
    _same(r3.numpy(), np.full((3, 3), 2.0))
    _same(r4.numpy(), an - 1)
    _same(c.numpy(), np.full((2, 3), 3.0))


def _write_set(x):
    x[0, 0] = 100.0


def _write_lloc(x):
    x.lloc[1, 2] = -7.0


def _write_out(x):
    ht.add(ht.array(np.full((2, 3), 5.0)), 1.0, out=x)


def _write_after_absorb(x):
    ht.sum(x, axis=0)  # computes x's chain as the reduction's program
    x[0, 0] = 100.0


@pytest.mark.parametrize("write", [_write_set, _write_lloc, _write_out, _write_after_absorb])
def test_a_consumer_of_a_pending_intermediate_keeps_its_value_across_writes(write):
    # y consumed x's chain while it was pending; computing x and then
    # writing it must not reach y
    an = np.arange(6.0).reshape(2, 3)

    def run():
        a = ht.array(an)
        x = a * 2.0
        y = x + 1.0
        z = ht.exp(y) * 0.5
        write(x)
        return x.larray.clone(), y.larray, z.larray

    got, want = run(), _eager(run)
    for g, w in zip(got, want):
        _same(g, w)
    _same(got[1], an * 2.0 + 1.0)


def test_an_outside_write_to_a_computed_intermediate_raises():
    x = ht.array(np.arange(4.0)) * 2.0
    y = x + 1.0
    x.larray.add_(1)  # behind the package's back, after x's chain computed
    with pytest.raises(RuntimeError, match="written in place"):
        y.numpy()


def test_an_outside_write_raises_instead_of_reading_new_values():
    a = ht.array(np.arange(4.0))
    r = a * 2
    a.larray.add_(1)  # behind the package's back
    with pytest.raises(RuntimeError, match="written in place"):
        r.numpy()
    p = ht.array(np.arange(3.0)) + 1
    p.larray = torch.zeros(3, dtype=torch.float64)
    assert p._fused_node() is None
    _same(p.numpy(), np.zeros(3))


def test_memory_pressure_narrows_the_fusion_window(monkeypatch):
    class Big:
        def program_bytes(self, args):
            return 10 << 20

    monkeypatch.setenv("HEAT_TPU_HBM_BUDGET", "1M")
    try:
        with pytest.raises(resilience.memory_guard.HeatTpuMemoryError):
            resilience.memory_guard.preflight("test", Big(), ())
        assert fusion.pressure_cap() == 1 and fusion.depth_cap() == 1
        r = ht.array(np.arange(3.0)) + 1
        assert r._fused_node() is None  # a window of one op
        Big.program_bytes = lambda self, args: 1
        resilience.memory_guard.preflight("test", Big(), ())
        assert fusion.pressure_cap() is None
    finally:
        fusion.set_pressure_cap(None)


def test_telemetry_summary_has_the_fusion_block():
    was = telemetry.enabled()
    telemetry.enable()
    reg = telemetry.get_registry()
    reg.clear()
    try:
        fusion.reset_stats()
        a = ht.array(np.arange(8.0).reshape(2, 4))
        ht.sum(ht.exp(a) * 2, axis=0).numpy()
        (ht.exp(a) + 1).numpy()
        block = telemetry.report.summarize()["fusion"]
        assert block["flushes"] == 2 and block["reductions_absorbed"] == 1
        assert block["nodes_per_flush"] == 2.0
        assert reg.counters["fusion.deferred"] == 4
    finally:
        reg.clear()
        if not was:
            telemetry.disable()
