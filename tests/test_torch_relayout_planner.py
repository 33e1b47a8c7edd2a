"""``heat_tpu_torch.core.relayout_planner`` against
``heat_tpu.core.relayout_planner`` on the CPU.

- ``plan()`` equals the JAX package's (kind, chunk count, every stage's
  block, collective and bytes, the predicted wire and temporary bytes, the
  reason) over a grid of shapes, splits, world sizes, budgets, live bytes
  and the four ``HEAT_TPU_RELAYOUT_PLAN`` values; ``monolithic_need``,
  ``chunk_stage_need`` and the sparse transpose's slab rule agree too.
- On gloo worlds of three and four ranks, ``resplit`` under ``monolithic``,
  ``alltoall`` and ``chunked`` (forced, and chosen by ``auto`` under a
  budget that monolithic does not fit) gives the same bits on every rank as
  the world of one; each chunk stage's audited wire bytes equal its
  planned cost with no drift; a budgeted sparse ``transpose`` runs in
  several stages and equals the one-stage transpose.
"""

import itertools

import numpy as np
import pytest

from heat_tpu.core import relayout_planner as jax_planner

from heat_tpu_torch import _knobs
from heat_tpu_torch.core import relayout_planner as planner

from tests.torch_spmd import spawn


def _key(p):
    return (p.kind, p.gshape, p.itemsize, p.src_split, p.dst_split, p.chunk_axis,
            tuple((s.lo, s.hi, s.cost.kind, s.cost.bytes, s.temp_bytes) for s in p.stages),
            p.predicted_bytes, p.temp_bytes, p.reason)


_SHAPES = [(1000, 256), (7, 5), (64, 33, 3), (1, 8), (4096, 64)]
_BUDGETS = [None, 1 << 10, 1 << 14, 1 << 17, 1 << 20, 1 << 26]


@pytest.mark.parametrize("mode", ["auto", "monolithic", "chunked", "alltoall"])
@pytest.mark.parametrize("nproc", [1, 2, 3, 4, 8])
def test_plan_equals_the_jax_packages_over_a_grid(mode, nproc, monkeypatch):
    monkeypatch.delenv("HEAT_TPU_HBM_BUDGET", raising=False)
    n = 0
    for gshape, item, budget, live in itertools.product(_SHAPES, (4, 8), _BUDGETS, (0, 3000)):
        splits = [None] + list(range(len(gshape)))
        for src, dst in itertools.product(splits, splits):
            mine = planner.plan(gshape, item, src, dst, nproc, budget=budget, live=live,
                                plan_mode=mode)
            theirs = jax_planner.plan(gshape, item, src, dst, nproc, budget=budget, live=live,
                                      plan_mode=mode)
            assert _key(mine) == _key(theirs), (gshape, item, src, dst, budget, live)
            assert mine.summary() == theirs.summary()
            n += 1
    assert n > 500


@pytest.mark.parametrize("raw", ["", "256M", "8G", "1K"])
def test_forced_chunk_width_follows_the_temp_budget_alike(raw, monkeypatch):
    monkeypatch.setenv("HEAT_TPU_HBM_BUDGET", raw)
    for gshape, nproc in itertools.product(_SHAPES[:3], (2, 3, 8)):
        mine = planner.plan(gshape, 4, 0, 1, nproc, plan_mode="chunked")
        theirs = jax_planner.plan(gshape, 4, 0, 1, nproc, plan_mode="chunked")
        assert _key(mine) == _key(theirs)


def test_need_models_and_the_sparse_slab_rule(monkeypatch):
    for gshape, item, nproc in itertools.product(_SHAPES, (2, 4, 8), (1, 2, 3, 5)):
        for src, dst in itertools.product([None, 0, 1], repeat=2):
            assert planner.monolithic_need(gshape, item, src, dst, nproc) == \
                jax_planner.monolithic_need(gshape, item, src, dst, nproc)
        for width in (1, 3, 17):
            assert planner.chunk_stage_need(gshape, item, 0, 1, width, nproc) == \
                jax_planner.chunk_stage_need(gshape, item, 0, 1, width, nproc)
    monkeypatch.delenv("HEAT_TPU_HBM_BUDGET", raising=False)
    assert planner.sparse_slab(500, 4, 4) == 500
    monkeypatch.setenv("HEAT_TPU_HBM_BUDGET", "1M")
    # the JAX package's rule: temp_budget() // (3 * p * (8 + itemsize))
    assert planner.sparse_slab(10 ** 6, 4, 4) == (1 << 20) // (3 * 4 * 12)
    assert planner.sparse_slab(7, 4, 4) == 7


def test_fast_path_plans_nothing(monkeypatch):
    monkeypatch.delenv("HEAT_TPU_HBM_BUDGET", raising=False)
    monkeypatch.delenv("HEAT_TPU_RELAYOUT_PLAN", raising=False)
    assert not planner.active()
    with _knobs.overlay({"HEAT_TPU_RELAYOUT_PLAN": "chunked"}):
        assert planner.active() and planner.mode() == "chunked"
    assert planner.mode() == "auto"
    monkeypatch.setenv("HEAT_TPU_RELAYOUT_PLAN", "bogus")
    assert planner.mode() == "auto" == jax_planner.mode()


_RESPLIT = """
import os
from heat_tpu_torch import _knobs
from heat_tpu_torch.core import relayout_planner
from heat_tpu_torch import telemetry

def run(ht, rank, world):
    rng = np.random.default_rng(7)
    out = {}
    for shape, src, dst in [((37, 23), 0, 1), ((37, 23), 1, 0), ((11, 6, 9), 2, 0),
                            ((5, 40), 1, 0)]:
        a = rng.standard_normal(shape).astype(np.float32)
        x = ht.array(a, split=src)
        tag = f"{'x'.join(map(str, shape))}_{src}{dst}"
        for plan in ("monolithic", "alltoall", "chunked"):
            with _knobs.overlay({"HEAT_TPU_RELAYOUT_PLAN": plan}):
                y = x.resplit(dst)
            assert y.split == dst
            out[f"{tag}_{plan}"] = y.larray.numpy()
        # auto under a budget that the monolithic relayout does not fit
        need = relayout_planner.monolithic_need(shape, 4, src, dst, world)
        with _knobs.overlay({"HEAT_TPU_HBM_BUDGET": str(need - 1)}):
            p = relayout_planner.maybe_plan(shape, 4, src, dst, x.comm)
            y = x.resplit(dst, audit=True)
        out[f"{tag}_autokind"] = np.array(p.kind)
        out[f"{tag}_auto"] = y.larray.numpy()
        # the stage audits: each stage's issued bytes equal its plan
        with _knobs.overlay({"HEAT_TPU_RELAYOUT_PLAN": "chunked"}):
            p = relayout_planner.maybe_plan(shape, 4, src, dst, x.comm)
            before = len(telemetry.hlo.recent())
            relayout_planner.run(p, x.larray, x.comm, audit=True)
            recs = telemetry.hlo.recent()[before:]
        out[f"{tag}_stages"] = np.array([[s.cost.bytes, r.audit.total_wire(),
                                          int(r.report.ok)] for s, r in zip(p.stages, recs)])
        out[f"{tag}_nstages"] = np.array(len(p.stages))
    # the sparse transpose: a budget splits it into stages, the same bits
    # enough stored elements a rank that the 1 MiB floor of the temporary
    # budget still cuts the capacity axis into stages
    d = np.where(rng.random((600, 200)) < 0.3, rng.standard_normal((600, 200)), 0.0)
    A = ht.sparse.csr_from_dense(ht.array(d.astype(np.float32), split=0))
    t1 = ht.sparse.transpose(A)
    with _knobs.overlay({"HEAT_TPU_HBM_BUDGET": "3K"}):
        tk = ht.sparse.transpose(A)
        out["sp_slab"] = np.array(relayout_planner.sparse_slab(A.capacity, 4, world))
    for name, t in (("one", t1), ("staged", tk)):
        out[f"sp_{name}_ip"] = t.indptr.numpy()
        out[f"sp_{name}_ix"] = t.indices.numpy()
        out[f"sp_{name}_v"] = t.values.numpy()
    out["sp_cap"] = np.array(A.capacity)
    return out
"""


@pytest.mark.parametrize("world", [3, 4])
def test_resplit_gives_the_same_bits_under_every_plan(tmp_path, world):
    ranks = spawn(tmp_path, world, _RESPLIT)
    rng = np.random.default_rng(7)
    for shape, src, dst in [((37, 23), 0, 1), ((37, 23), 1, 0), ((11, 6, 9), 2, 0),
                            ((5, 40), 1, 0)]:
        a = rng.standard_normal(shape).astype(np.float32)
        tag = f"{'x'.join(map(str, shape))}_{src}{dst}"
        c = -(-shape[dst] // world)
        for r, res in enumerate(ranks):
            want = np.take(a, np.arange(min(r * c, shape[dst]), min((r + 1) * c, shape[dst])),
                           axis=dst)
            for plan in ("monolithic", "alltoall", "chunked", "auto"):
                assert res[f"{tag}_{plan}"].tobytes() == want.tobytes(), (tag, plan, r)
            assert str(res[f"{tag}_autokind"]) == "chunked"
            stages = res[f"{tag}_stages"]
            # at least one stage a destination chunk that holds columns
            assert len(stages) == int(res[f"{tag}_nstages"]) >= -(-shape[dst] // c)
            assert (stages[:, 0] == stages[:, 1]).all() and stages[:, 2].all(), stages
    for res in ranks:
        assert int(res["sp_slab"]) < int(res["sp_cap"])  # the budget made several stages
        for part in ("ip", "ix", "v"):
            np.testing.assert_array_equal(res[f"sp_one_{part}"], res[f"sp_staged_{part}"])
