"""``heat_tpu_torch.autotune`` against ``heat_tpu.autotune`` on the CPU.

The cases of ``tests/test_autotune.py``, merged where they repeat, each
still a case of its own:

- the knob overlay every tuned value rides, and the tunable metadata;
- the lattice (``candidates``, ``default_config``, ``exact_variant``,
  ``is_lossy_shift``) equal to the JAX package's for the same knobs,
  budget and environment;
- the three cost functions (``relayout_cost_fn``, ``fsdp_cost_fn``,
  ``pipeline_cost_fn``) giving the JAX package's numbers on the same
  signatures and configs, and the pruning that sits on them;
- the trial machinery (``robust_median``; ``digest`` exact to the bit and
  to the dtype over numpy arrays, tensors, bfloat16 tensors and DNDarrays;
  ``max_rel_err``);
- the database: keys, the round trip, the rejection of corrupt and foreign
  records (another world size, another backend: a CPU record is never
  adopted on the card), read-only consults that create nothing;
- the protocol: never worse than the default, zero trials on a database
  hit, a caller's tighter budget, an unopenable database, the module lock,
  the budget refusing lossy modes, a budgeted lossy pick, the exact pins
  beating a tuned overlay, a broken candidate disqualified, the live and
  the offline summaries agreeing, the trace's track, the warm start at a
  registry miss and at a Server's construction, and the autotuner off
  leaving dispatch bit for bit unchanged (no database read, no counter,
  no build past the first);
- a second process pointed at the database adopts the pick with zero
  trials and builds nothing in its steady state.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from heat_tpu import _knobs as jax_knobs
from heat_tpu.autotune import cost as jax_cost
from heat_tpu.autotune import space as jax_space

import heat_tpu_torch as ht
from heat_tpu_torch import _knobs as knobs
from heat_tpu_torch import autotune as at
from heat_tpu_torch import telemetry as tm
from heat_tpu_torch.autotune import cost, db, space, trials
from heat_tpu_torch.core import collective_prec
from heat_tpu_torch.core import program_cache as pc
from heat_tpu_torch.telemetry import collectives as cost_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SEARCH_PLAN = ["HEAT_TPU_RELAYOUT_PLAN"]
SEARCH_PREC = ["HEAT_TPU_COLLECTIVE_PREC"]


@pytest.fixture(autouse=True)
def _clean():
    ht.use_device("cpu")
    at.reset()
    knobs.clear_overrides()
    jax_knobs.clear_overrides()
    yield
    at.reset()
    knobs.clear_overrides()
    jax_knobs.clear_overrides()
    tm.disable()
    tm.get_registry().clear()
    ht.use_device(None)


def _resplit_workload(n=256, f=32, seed=0):
    rng = np.random.default_rng(seed)
    x = ht.array(rng.standard_normal((n, f)).astype(np.float32), split=0)
    return x, (lambda: ht.resplit(x, 1).larray)


# -- the knob overlay (the adoption mechanism) ---------------------------------------------


def test_override_wins_over_env_and_restores(monkeypatch):
    monkeypatch.setenv("HEAT_TPU_FUSION_DEPTH", "32")
    assert knobs.get("HEAT_TPU_FUSION_DEPTH") == 32
    with knobs.overlay({"HEAT_TPU_FUSION_DEPTH": "8"}):
        assert knobs.get("HEAT_TPU_FUSION_DEPTH") == 8
        assert knobs.raw("HEAT_TPU_FUSION_DEPTH") == "8"
    assert knobs.get("HEAT_TPU_FUSION_DEPTH") == 32


def test_overlay_nests_and_restores_absence():
    assert knobs.raw("HEAT_TPU_RELAYOUT_PLAN") is None
    with knobs.overlay({"HEAT_TPU_RELAYOUT_PLAN": "chunked"}):
        with knobs.overlay({"HEAT_TPU_RELAYOUT_PLAN": "alltoall"}):
            assert knobs.get("HEAT_TPU_RELAYOUT_PLAN") == "alltoall"
        assert knobs.get("HEAT_TPU_RELAYOUT_PLAN") == "chunked"
    assert knobs.raw("HEAT_TPU_RELAYOUT_PLAN") is None


def test_unregistered_override_rejected():
    with pytest.raises(KeyError):
        knobs.set_override("HEAT_TPU_NOT_A_KNOB", "1")


def test_every_consumer_sees_tuned_values():
    from heat_tpu_torch.core import fusion, relayout_planner

    with knobs.overlay({"HEAT_TPU_RELAYOUT_PLAN": "monolithic",
                        "HEAT_TPU_FUSION_DEPTH": "4",
                        "HEAT_TPU_COLLECTIVE_PREC": "bf16"}):
        assert relayout_planner.mode() == "monolithic"
        assert fusion.depth_cap() == 4
        assert collective_prec.mode() == "bf16"


# -- tunable metadata ------------------------------------------------------------------------


def test_declared_search_spaces_are_sane():
    tun = knobs.tunables()
    assert len(tun) >= 12
    for name, k in tun.items():
        t = k.tunable
        assert t.kind in ("exact", "lossy", "neutral"), name
        assert t.values and all(isinstance(v, str) and v for v in t.values), name
        if t.kind == "lossy":
            assert t.exact_value in t.values, name
        if k.type == "enum":
            assert set(t.values) <= set(k.choices), name


def test_lossy_classes_cover_the_accuracy_frontier_knobs():
    for name in ("HEAT_TPU_COLLECTIVE_PREC", "HEAT_TPU_CDIST_PREC", "HEAT_TPU_SERVE_EXACT"):
        assert knobs.REGISTRY[name].tunable.kind == "lossy", name
    for name in ("HEAT_TPU_RELAYOUT_PLAN", "HEAT_TPU_FUSION_DEPTH", "HEAT_TPU_RING_OVERLAP"):
        assert knobs.REGISTRY[name].tunable.kind == "exact", name


@pytest.mark.parametrize("name", ["HEAT_TPU_AUTOTUNE", "HEAT_TPU_TUNE_DB",
                                  "HEAT_TPU_AUTOTUNE_TRIALS", "HEAT_TPU_AUTOTUNE_BUDGET"])
def test_autotune_knobs_registered_as_in_the_jax_package(name):
    mine, theirs = knobs.REGISTRY[name], jax_knobs.REGISTRY[name]
    assert (mine.type, mine.default) == (theirs.type, theirs.default)
    assert knobs.get("HEAT_TPU_AUTOTUNE") is False  # off by default


# -- the lattice, equal to the JAX package's --------------------------------------------------

_LATTICES = [
    (SEARCH_PLAN, None, {}),
    (SEARCH_PLAN + SEARCH_PREC, None, {}),
    (SEARCH_PLAN + SEARCH_PREC, 0.01, {}),
    (["HEAT_TPU_FUSION_DEPTH"], None, {"HEAT_TPU_FUSION_DEPTH": "12"}),
    (["HEAT_TPU_CDIST_PREC"], 1e-3, {}),
    (["HEAT_TPU_CDIST_PREC"], None, {"HEAT_TPU_CDIST_PREC": "high"}),
    (["HEAT_TPU_FSDP_PREFETCH", "HEAT_TPU_FSDP_PREC"], 0.05, {}),
    (["HEAT_TPU_PIPELINE_SCHEDULE", "HEAT_TPU_PIPELINE_MICROBATCHES",
      "HEAT_TPU_FSDP_PREFETCH"], None, {}),
    (["HEAT_TPU_SERVE_MAX_BATCH", "HEAT_TPU_SERVE_EXACT"], 1e-4, {}),
]


@pytest.mark.parametrize("names,budget,env", _LATTICES)
def test_lattice_equals_the_jax_packages(names, budget, env, monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    mine = space.candidates(names, error_budget=budget)
    assert mine == jax_space.candidates(names, error_budget=budget)
    assert mine[0] == space.default_config(names) == jax_space.default_config(names)
    for cfg in mine:
        assert space.exact_variant(cfg) == jax_space.exact_variant(cfg)
        assert space.is_lossy_shift(cfg, mine[0]) == jax_space.is_lossy_shift(cfg, mine[0])


def test_default_config_is_candidate_zero():
    cfgs = space.candidates(SEARCH_PLAN)
    assert cfgs[0] == {"HEAT_TPU_RELAYOUT_PLAN": "auto"}
    assert len(cfgs) == 4


def test_lossy_pinned_without_budget():
    assert all(c["HEAT_TPU_COLLECTIVE_PREC"] == "off"
               for c in space.candidates(SEARCH_PLAN + SEARCH_PREC))
    assert {c["HEAT_TPU_COLLECTIVE_PREC"] for c in space.candidates(
        SEARCH_PLAN + SEARCH_PREC, error_budget=0.01)} == {"off", "bf16", "int8", "blockwise"}


def test_env_value_joins_the_lattice(monkeypatch):
    monkeypatch.setenv("HEAT_TPU_FUSION_DEPTH", "12")
    cfgs = space.candidates(["HEAT_TPU_FUSION_DEPTH"])
    assert cfgs[0] == {"HEAT_TPU_FUSION_DEPTH": "12"}
    assert {c["HEAT_TPU_FUSION_DEPTH"] for c in cfgs} == {"12", "4", "8", "16", "32", "64"}


def test_exact_variant_and_lossy_shift():
    base = space.default_config(SEARCH_PREC + SEARCH_PLAN)
    assert space.exact_variant(base)["HEAT_TPU_COLLECTIVE_PREC"] == "off"
    assert space.is_lossy_shift(dict(base, HEAT_TPU_COLLECTIVE_PREC="int8"), base)
    assert not space.is_lossy_shift(dict(base, HEAT_TPU_RELAYOUT_PLAN="chunked"), base)


def test_untunable_knob_rejected():
    with pytest.raises(ValueError, match="tunable"):
        space.candidates(["HEAT_TPU_TELEMETRY"])


# -- the cost functions, equal to the JAX package's ------------------------------------------


def _same_numbers(mine, theirs, configs):
    for cfg in configs:
        a, b = mine(cfg), theirs(cfg)
        assert a == b or (np.isinf(a) and np.isinf(b)), (cfg, a, b)


_RELAYOUT_SIGS = [((4096, 256), 4, 0, 1, 4, None), ((1000, 256), 4, 1, 0, 8, None),
                  ((1_000_000, 256), 4, 0, 1, 4, 1 << 28), ((7, 5), 8, 0, None, 3, None),
                  ((4096, 256), 4, 0, 1, 4, 1)]


@pytest.mark.parametrize("sig", _RELAYOUT_SIGS)
@pytest.mark.parametrize("hier", [False, True])
def test_relayout_cost_fn_equals_the_jax_packages(sig, hier, monkeypatch):
    gshape, item, src, dst, p, budget = sig
    monkeypatch.setenv("HEAT_TPU_TOPOLOGY", "2x2" if p == 4 else "")
    names = SEARCH_PLAN + SEARCH_PREC + (["HEAT_TPU_HIERARCHICAL"] if hier else [])
    cfgs = space.candidates(names, error_budget=0.01)
    _same_numbers(cost.relayout_cost_fn(gshape, item, src, dst, p, budget=budget),
                  jax_cost.relayout_cost_fn(gshape, item, src, dst, p, budget=budget), cfgs)


@pytest.mark.parametrize("numels,item,p", [([1024 * 1024, 1024, 3 * 1024 * 1024], 2, 4),
                                           ([13 * 3, 3], 4, 8), ([100_000], 4, 2)])
def test_fsdp_cost_fn_equals_the_jax_packages(numels, item, p):
    cfgs = space.candidates(["HEAT_TPU_FSDP_PREFETCH", "HEAT_TPU_FSDP_PREC"], error_budget=0.05)
    cfgs += [dict(c, HEAT_TPU_HIERARCHICAL=h) for c in cfgs[:4] for h in ("0", "1")]
    _same_numbers(cost.fsdp_cost_fn(numels, item, p), jax_cost.fsdp_cost_fn(numels, item, p),
                  cfgs)


@pytest.mark.parametrize("args,kw", [
    (([64 * 64, 64], 8, 16, 64, 4, 4), {}),
    (([1024 * 1024], 12, 32, 1024, 2, 4), {"budget": 1 << 20}),
    (([100], 6, 12, 10, 4, 6), {"n_stages": 3}),
])
def test_pipeline_cost_fn_equals_the_jax_packages(args, kw):
    cfgs = space.candidates(["HEAT_TPU_PIPELINE_SCHEDULE", "HEAT_TPU_PIPELINE_MICROBATCHES",
                             "HEAT_TPU_FSDP_PREFETCH"])
    _same_numbers(cost.pipeline_cost_fn(*args, **kw), jax_cost.pipeline_cost_fn(*args, **kw),
                  cfgs)


def test_pruning_order_matches_the_analytic_model():
    gshape, itemsize, p = (4096, 256), 4, 4
    fn = cost.relayout_cost_fn(gshape, itemsize, 0, 1, p)
    modes = ("off", "bf16", "int8", "blockwise")
    cfgs = [{"HEAT_TPU_RELAYOUT_PLAN": "alltoall", "HEAT_TPU_COLLECTIVE_PREC": m} for m in modes]
    ranked = cost.rank(cfgs, fn)
    want = sorted(modes, key=lambda m: cost_model.relayout_cost(
        gshape, itemsize, 0, 1, p, precision=m).bytes)
    assert [cfg["HEAT_TPU_COLLECTIVE_PREC"] for _, _, cfg in ranked] == want
    for c, _, cfg in ranked:
        assert c == cost_model.relayout_cost(gshape, itemsize, 0, 1, p,
                                             precision=cfg["HEAT_TPU_COLLECTIVE_PREC"]).bytes


def test_prune_always_keeps_default_first():
    fn = cost.relayout_cost_fn((4096, 256), 4, 0, 1, 4)
    cfgs = space.candidates(SEARCH_PREC + SEARCH_PLAN, error_budget=0.01)
    kept = cost.prune(cfgs, fn, keep=3)
    assert kept[0] == cfgs[0] and len(kept) == 3


def test_temp_model_marks_infeasible():
    fn = cost.relayout_cost_fn((4096, 256), 4, 0, 1, 4, budget=1)
    assert fn({"HEAT_TPU_RELAYOUT_PLAN": "monolithic",
               "HEAT_TPU_COLLECTIVE_PREC": "off"}) == float("inf")


def test_no_model_measures_everything():
    cfgs = space.candidates(SEARCH_PLAN)
    assert cost.prune(cfgs, None, keep=2) == cfgs


# -- trials ------------------------------------------------------------------------------------


def test_robust_median_rejects_outliers():
    assert trials.robust_median([1.0, 1.01, 0.99, 1.0, 50.0]) == 1.0
    assert trials.robust_median([2.0]) == 2.0


@pytest.mark.parametrize("make", [
    lambda a: a,
    lambda a: torch.from_numpy(a),
    lambda a: ht.array(a, split=0),
])
def test_digest_is_bit_and_dtype_exact(make):
    a = np.arange(6, dtype=np.float32)
    assert trials.digest(make(a)) == trials.digest(make(a.copy()))
    assert trials.digest(make(a)) != trials.digest(make(a.astype(np.float64)))
    assert trials.digest(make(a)) != trials.digest(make(a.reshape(2, 3)))
    b = a.copy()
    b[3] = np.nextafter(b[3], np.inf)
    assert trials.digest(make(a)) != trials.digest(make(b))


def test_digest_hashes_bfloat16_as_its_bits():
    a = torch.tensor([1.0, 1.0078125, -2.0], dtype=torch.bfloat16)
    b = a.clone()
    b.view(torch.int16)[1] += 1  # the next bfloat16 above 1.0078125
    assert trials.digest(a) == trials.digest(a.clone())
    assert trials.digest(a) != trials.digest(b)
    assert trials.digest(a) != trials.digest(a.view(torch.int16))  # the dtype counts
    assert trials.digest(a) != trials.digest(a.float())


def test_max_rel_err():
    ref = np.array([0.0, 2.0, -4.0])
    out = ref + np.array([0.0, 0.0, 0.04])
    assert trials.max_rel_err(out, ref) == pytest.approx(0.01)
    assert trials.max_rel_err(torch.from_numpy(out), ref) == pytest.approx(0.01)
    assert trials.max_rel_err(np.zeros(2), np.zeros(3)) == float("inf")


# -- the database -------------------------------------------------------------------------------


def _record(key, site="resplit", mesh=None, **extra):
    rec = {"schema": db.SCHEMA, "key": key, "site": site, "signature": "sig",
           "mesh": mesh or db.mesh_fingerprint(),
           "config": {"HEAT_TPU_RELAYOUT_PLAN": "alltoall"},
           "baseline_wall": 1.0, "tuned_wall": 0.5, "created": 0.0}
    rec.update(extra)
    return rec


def test_fingerprint_names_the_backend_card_world_and_topology():
    mesh = db.mesh_fingerprint()
    assert mesh == {"devices": 1, "backend": "cpu", "device_kind": "cpu",
                    "topology": ["flat"]}


def test_key_is_stable_and_signature_sensitive():
    mesh = db.mesh_fingerprint()
    k1 = db.tune_key("resplit", ((256, 32), 0, 1), mesh)
    assert k1 == db.tune_key("resplit", ((256, 32), 0, 1), mesh)
    assert k1 != db.tune_key("resplit", ((256, 33), 0, 1), mesh)
    assert k1 != db.tune_key("resplit", ((256, 32), 0, 1), dict(mesh, devices=2))
    assert k1 != db.tune_key("resplit", ((256, 32), 0, 1), dict(mesh, backend="cuda"))


def test_round_trip(tmp_path):
    d = db.TuneDB(str(tmp_path / "db"))
    key = db.tune_key("resplit", "sig")
    path = d.store(_record(key))
    assert os.path.basename(path) == f"{key}.json"
    rec = d.lookup(key)
    assert rec is not None and rec["site"] == "resplit"
    assert [r["key"] for r in d.records()] == [key]


def test_corrupt_record_cleanly_rejected(tmp_path):
    d = db.TuneDB(str(tmp_path / "db"))
    os.makedirs(d.path)
    key = db.tune_key("resplit", "sig")
    with open(os.path.join(d.path, f"{key}.json"), "w") as f:
        f.write('{"schema": 1, "key": TRUNCATED')
    assert d.lookup(key) is None
    assert list(d.records()) == []


@pytest.mark.parametrize("foreign", ["world", "backend", "card", "topology", "schema", "key"])
def test_foreign_records_cleanly_rejected(foreign, tmp_path):
    d = db.TuneDB(str(tmp_path / "db"))
    os.makedirs(d.path)
    mesh = db.mesh_fingerprint()
    other = {"world": dict(mesh, devices=2), "backend": dict(mesh, backend="cuda"),
             "card": dict(mesh, device_kind="NVIDIA H100 80GB HBM3"),
             "topology": dict(mesh, topology=["hier", "2", "2", ""])}.get(foreign, mesh)
    key = db.tune_key("resplit", "sig", other)
    rec = _record(key, mesh=other)
    if foreign == "schema":
        rec["schema"] = db.SCHEMA + 1
    name = db.tune_key("serve", "sig") if foreign == "key" else key
    with open(os.path.join(d.path, f"{name}.json"), "w") as f:
        json.dump(rec, f)
    assert d.lookup(name) is None
    assert list(d.records()) == []


def test_store_refuses_unregistered_config_knobs(tmp_path):
    d = db.TuneDB(str(tmp_path / "db"))
    rec = _record(db.tune_key("resplit", "sig"))
    rec["config"] = {"HEAT_TPU_NOT_A_KNOB": "1"}
    with pytest.raises(ValueError, match="invalid tuning record"):
        d.store(rec)


def test_open_db_env(tmp_path, monkeypatch):
    monkeypatch.delenv("HEAT_TPU_TUNE_DB", raising=False)
    assert db.open_db() is None
    monkeypatch.setenv("HEAT_TPU_TUNE_DB", str(tmp_path / "envdb"))
    d = db.open_db()
    assert d is not None and d.path == str(tmp_path / "envdb")


def test_readonly_consults_never_create_the_db_dir(tmp_path):
    path = str(tmp_path / "nonexistent_db")
    d = db.open_db(path)
    assert d.lookup(db.tune_key("resplit", "sig")) is None
    assert list(d.records()) == [] and d.count() == 0
    assert not os.path.exists(path)
    d.store(_record(db.tune_key("resplit", "sig")))
    assert os.path.isdir(path) and d.count() == 1


# -- the tuner ---------------------------------------------------------------------------------


def test_winner_never_worse_than_default(tmp_path):
    x, work = _resplit_workload()
    res = at.tune("resplit", work, signature=("r", x.shape, 0, 1), search=SEARCH_PLAN,
                  trials_per_config=2, db_dir=str(tmp_path / "db"),
                  cost_fn=cost.relayout_cost_fn(x.shape, 4, 0, 1, ht.get_comm().size))
    assert not res.from_db and res.trials_run > 0
    rec = res.record
    assert rec["tuned_wall"] <= rec["baseline_wall"]
    assert rec["validation"] == "digest" and rec["max_rel_err"] == 0.0
    assert at.adopted()["resplit"] == res.config


def test_db_hit_skips_trials_and_adopts(tmp_path):
    x, work = _resplit_workload()
    kwargs = dict(signature=("r", x.shape, 0, 1), search=SEARCH_PLAN, trials_per_config=2,
                  db_dir=str(tmp_path / "db"))
    first = at.tune("resplit", work, **kwargs)
    at.reset()
    second = at.tune("resplit", work, **kwargs)
    assert second.from_db and second.trials_run == 0
    assert second.config == first.config
    assert at.adopted()["resplit"] == first.config


def _quantizing_workload():
    """A result that a lossy HEAT_TPU_COLLECTIVE_PREC moves, as the wire does
    across ranks (a world of one moves nothing)."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(512).astype(np.float32))

    def work():
        mode = knobs.get("HEAT_TPU_COLLECTIVE_PREC")
        return x if mode == "off" else x.to(torch.bfloat16).float()

    return x, work


def test_db_hit_respects_callers_tighter_budget(tmp_path):
    budget = 1.05 / 127
    x, work = _quantizing_workload()
    sig = ("rh", tuple(x.shape), 0, 1)
    mesh = db.mesh_fingerprint()
    key = db.tune_key("resplit", sig, mesh)
    d = db.TuneDB(str(tmp_path / "db"))
    d.store(_record(key, signature=repr(sig), config={"HEAT_TPU_COLLECTIVE_PREC": "int8"},
                    default_config={"HEAT_TPU_COLLECTIVE_PREC": "off"}, error_budget=budget,
                    max_rel_err=0.004, validation="allclose"))
    kwargs = dict(signature=sig, search=SEARCH_PREC, trials_per_config=2, db_dir=d.path)
    first = at.tune("resplit", work, error_budget=budget, **kwargs)
    assert first.from_db and first.trials_run == 0
    assert first.config == {"HEAT_TPU_COLLECTIVE_PREC": "int8"}
    at.reset()
    second = at.tune("resplit", work, error_budget=1e-12, persist=False, **kwargs)
    assert not second.from_db and second.trials_run > 0
    assert second.record["validation"] == "digest"
    at.reset()
    third = at.tune("resplit", work, persist=False, **kwargs)
    assert not third.from_db and third.record["validation"] == "digest"


@pytest.mark.parametrize("budget", [None, np.float32(1.05 / 127)])
def test_unopenable_db_keeps_the_measured_winner(budget, tmp_path):
    blocker = tmp_path / "blocker"
    blocker.write_text("not a directory")
    x, work = _resplit_workload()
    res = at.tune("resplit", work, signature=("ro", x.shape, 0, 1),
                  search=SEARCH_PLAN if budget is None else SEARCH_PREC, trials_per_config=2,
                  error_budget=budget, db_dir=str(blocker / "db"))
    assert not res.from_db and res.trials_run > 0
    assert at.adopted()["resplit"] == res.config
    if budget is not None:  # a numpy budget is coerced before json sees it
        assert isinstance(res.record["error_budget"], float)


def test_concurrent_tunes_serialize_on_the_module_lock(tmp_path):
    x, work = _resplit_workload()
    seen = []

    def spying_work():
        seen.append(at._TUNE_LOCK.locked())
        return work()

    res = at.tune("resplit", spying_work, signature=("rs", x.shape, 0, 1), search=SEARCH_PLAN,
                  trials_per_config=2, db_dir=str(tmp_path / "db"))
    assert not res.from_db
    assert seen and all(seen)


def test_error_budget_refuses_lossy_modes(tmp_path):
    """A lossy candidate that moves the result past a budget is rejected."""
    reg = tm.enable()
    reg.clear()
    _, work = _quantizing_workload()
    res = at.tune("rb", work, signature="rb", search=SEARCH_PREC, error_budget=1e-12,
                  trials_per_config=2, db_dir=str(tmp_path / "db"))
    assert res.config["HEAT_TPU_COLLECTIVE_PREC"] == "off"
    assert reg.counters["autotune.rejected_budget"] >= 1
    assert res.record["validation"] == "digest"


def test_budgeted_lossy_pick_is_within_budget(tmp_path):
    budget = 1.05 / 127
    x, work = _resplit_workload()
    res = at.tune("resplit", work, signature=("rl", x.shape, 0, 1), search=SEARCH_PREC,
                  error_budget=budget, trials_per_config=2, db_dir=str(tmp_path / "db"))
    rec = res.record
    assert rec["tuned_wall"] <= rec["baseline_wall"]
    assert rec["max_rel_err"] <= budget and rec["error_budget"] == budget


def test_exact_site_pin_beats_tuned_overlay():
    x = ht.array(np.random.default_rng(3).standard_normal((64, 8)).astype(np.float32), split=0)

    def digests():
        vals, idx = ht.sort(x, axis=0)
        return trials.digest((vals, idx)), trials.digest(ht.mean(x, axis=0))

    ref = digests()
    at._adopt("resplit", {"HEAT_TPU_COLLECTIVE_PREC": "int8"})
    assert collective_prec.mode() == "int8"
    assert collective_prec.resolve("off") == "off"
    assert digests() == ref


def test_broken_candidate_is_disqualified_not_fatal(tmp_path):
    reg = tm.enable()
    reg.clear()

    def work():
        if knobs.get("HEAT_TPU_RELAYOUT_PLAN") == "chunked":
            raise RuntimeError("boom")
        return np.ones(3)

    res = at.tune("flaky", work, signature="f", search=SEARCH_PLAN, trials_per_config=2,
                  db_dir=str(tmp_path / "db"))
    assert res.config["HEAT_TPU_RELAYOUT_PLAN"] != "chunked"
    assert reg.counters["autotune.rejected_error"] == 1


# -- telemetry -----------------------------------------------------------------------------------


def test_live_and_offline_summaries_agree(tmp_path):
    reg = tm.enable()
    reg.clear()
    x, work = _resplit_workload()
    kwargs = dict(signature=("rt", x.shape, 0, 1), search=SEARCH_PLAN, trials_per_config=2,
                  db_dir=str(tmp_path / "db"))
    at.tune("resplit", work, **kwargs)
    at.reset()
    at.tune("resplit", work, **kwargs)
    live = tm.report.summarize()["autotune"]
    offline = tm.report.summarize(list(reg.events))["autotune"]
    assert live == offline
    for key in ("trials", "picks", "stores", "db_misses", "db_hits", "adopted"):
        assert live.get(key, 0) >= 1, (key, live)


def test_trace_gets_an_autotune_track():
    reg = tm.enable()
    reg.clear()
    at._emit("resplit", "pick", config={"k": "v"})
    rows = tm.trace.to_trace_events(reg.events)
    marks = [r for r in rows if r.get("cat") == "autotune"]
    assert marks and marks[0]["ph"] == "i"
    names = [r for r in rows if r.get("name") == "thread_name" and r["tid"] == marks[0]["tid"]]
    assert names and names[0]["args"]["name"] == "autotune"


def test_untuned_summary_shape_unchanged():
    reg = tm.enable()
    reg.clear()
    assert "autotune" not in tm.report.summarize()


# -- dispatch ------------------------------------------------------------------------------------


def test_autotune_off_leaves_dispatch_bit_for_bit_unchanged(monkeypatch):
    monkeypatch.delenv("HEAT_TPU_AUTOTUNE", raising=False)

    def boom(*a, **k):
        raise AssertionError("tuning database consulted while the autotuner is off")

    monkeypatch.setattr(at.db, "open_db", boom)
    reg = tm.enable()
    reg.clear()
    pc.reset()
    x, work = _resplit_workload(seed=7)
    first = work()
    with tm.CompileWatcher() as cw:
        again = work()
    assert cw.backend_compiles == 0
    assert torch.equal(first, again)
    assert not any(c.startswith("autotune.") for c in reg.counters)
    assert not any(e.get("kind") == "autotune" for e in reg.events)


def test_warm_start_gates_lossy_records_on_ambient_budget(tmp_path):
    budget = 1.05 / 127
    d = db.TuneDB(str(tmp_path / "db"))
    d.store(_record(db.tune_key("resplit", "sig"), config={"HEAT_TPU_COLLECTIVE_PREC": "int8"},
                    error_budget=budget, max_rel_err=0.004, validation="allclose"))
    at.enable(d.path)
    assert at.warm_start(force=True) == 0
    assert "resplit" not in at.adopted()
    assert knobs.raw("HEAT_TPU_COLLECTIVE_PREC") is None
    knobs.set_override("HEAT_TPU_AUTOTUNE_BUDGET", str(budget))
    assert at.warm_start(force=True) == 1
    assert at.adopted()["resplit"] == {"HEAT_TPU_COLLECTIVE_PREC": "int8"}
    at.reset()
    knobs.set_override("HEAT_TPU_AUTOTUNE_BUDGET", "1e-12")
    assert at.warm_start(force=True) == 0
    assert "resplit" not in at.adopted()


def test_program_miss_warm_starts_from_db(tmp_path):
    d = db.TuneDB(str(tmp_path / "db"))
    d.store(_record(db.tune_key("resplit", "sig")))
    at.enable(d.path)
    pc.reset()
    pc.cached_program("t_at", "k", lambda: (lambda v: v), inline=True)
    assert at.adopted()["resplit"] == {"HEAT_TPU_RELAYOUT_PLAN": "alltoall"}
    assert knobs.get("HEAT_TPU_RELAYOUT_PLAN") == "alltoall"


def test_a_registry_hit_never_consults_the_tuner(tmp_path, monkeypatch):
    pc.reset()
    pc.cached_program("t_hit", "k", lambda: (lambda v: v), inline=True)
    at.enable(str(tmp_path / "db"))
    monkeypatch.setattr(at, "on_program_miss", lambda site: pytest.fail("consulted on a hit"))
    pc.cached_program("t_hit", "k", lambda: (lambda v: v), inline=True)


def test_server_constructs_tuned(tmp_path):
    d = db.TuneDB(str(tmp_path / "db"))
    d.store(_record(db.tune_key("serve", "sig"), site="serve",
                    config={"HEAT_TPU_SERVE_MAX_BATCH": "16",
                            "HEAT_TPU_SERVE_MAX_WAIT_MS": "0.5"}))
    at.enable(d.path)
    server = ht.serve.Server()
    try:
        assert server.max_batch == 16
        assert server.ladder[-1] == 16
        assert server.max_wait == pytest.approx(0.5e-3)
    finally:
        server.close()


def test_bench_field_reports_the_database_and_adoptions(tmp_path):
    d = db.TuneDB(str(tmp_path / "db"))
    d.store(_record(db.tune_key("resplit", "sig")))
    at.enable(d.path)
    at.warm_start(force=True)
    row = at.bench_field()
    assert row["enabled"] is True and row["db"] == d.path and row["db_records"] == 1
    assert row["adopted"] == {"resplit": {"HEAT_TPU_RELAYOUT_PLAN": "alltoall"}}


# -- a second process ------------------------------------------------------------------------


def test_second_process_zero_trials_zero_steady_builds(tmp_path):
    tune_db = str(tmp_path / "db")
    x, work = _resplit_workload(n=128, f=16, seed=1)
    first = at.tune("resplit", work, signature=("sp", (128, 16), 0, 1), search=SEARCH_PLAN,
                    trials_per_config=2, db_dir=tune_db)
    assert not first.from_db
    env = dict(os.environ, HEAT_TPU_AUTOTUNE="1", HEAT_TPU_TUNE_DB=tune_db,
               CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    script = (
        "import numpy as np\n"
        "import heat_tpu_torch as ht\n"
        "from heat_tpu_torch import autotune as at\n"
        "ht.use_device('cpu')\n"
        "x = ht.array(np.random.default_rng(1).standard_normal((128, 16)).astype(np.float32),\n"
        "             split=0)\n"
        "work = lambda: ht.resplit(x, 1).larray\n"
        "res = at.tune('resplit', work, signature=('sp', (128, 16), 0, 1),\n"
        "              search=['HEAT_TPU_RELAYOUT_PLAN'], trials_per_config=2)\n"
        "assert res.from_db and res.trials_run == 0, (res.from_db, res.trials_run)\n"
        "work()\n"
        "with ht.telemetry.CompileWatcher() as cw:\n"
        "    work()\n"
        "assert cw.backend_compiles == 0, cw.backend_compiles\n"
        "print('TUNED', res.config)\n"
    )
    r = subprocess.run([sys.executable, "-c", script], env=env, cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "TUNED" in r.stdout and str(first.config) in r.stdout


# -- a world of several ranks agrees on one pick ---------------------------------------

_RANKS_TUNE = """
import os
import time

def run(ht, rank, world):
    from heat_tpu_torch import _knobs, autotune

    x = ht.array(np.arange(12 * 5, dtype=np.float32).reshape(12, 5), split=0)
    # alone, ranks 0 and 2 would pick monolithic; rank 1 gets other bits
    # under it (a digest rejection there only) and alone would pick alltoall
    fast = {0: "monolithic", 1: "alltoall", 2: "monolithic"}[rank]

    def work():
        plan = _knobs.raw("HEAT_TPU_RELAYOUT_PLAN")
        time.sleep(0.0 if plan == fast else 0.02)
        out = ht.resplit(x, 1).larray
        return out + 1 if (rank == 1 and plan == "monolithic") else out

    kwargs = dict(signature=("ranks", (12, 5), 0, 1), search=["HEAT_TPU_RELAYOUT_PLAN"],
                  trials_per_config=2)
    first = autotune.tune("resplit", work, **kwargs)
    adopted = _knobs.raw("HEAT_TPU_RELAYOUT_PLAN")
    autotune.reset()
    second = autotune.tune("resplit", work, **kwargs)
    return {"pick": first.config["HEAT_TPU_RELAYOUT_PLAN"], "adopted": adopted,
            "from_db": [first.from_db, second.from_db], "trials": second.trials_run,
            "again": second.config["HEAT_TPU_RELAYOUT_PLAN"],
            "walls": [first.record["baseline_wall"], first.record["tuned_wall"]]}
"""


def test_ranks_that_time_candidates_differently_adopt_one_pick(tmp_path):
    """Three gloo ranks tune one resplit: each would pick its own plan alone,
    and one rejects a plan the others find fastest. Every rank adopts and
    stores the same pick, never the rejected plan, with the same walls;
    the second tune is a database hit on every rank."""
    from tests.torch_spmd import spawn

    ranks = spawn(tmp_path / "out", 3, _RANKS_TUNE,
                  env={"HEAT_TPU_TUNE_DB": str(tmp_path / "db")})
    picks = {str(r["pick"]) for r in ranks}
    assert len(picks) == 1 and picks != {"monolithic"}
    assert {str(r["adopted"]) for r in ranks} == picks == {str(r["again"]) for r in ranks}
    for r in ranks:
        assert r["from_db"].tolist() == [False, True] and int(r["trials"]) == 0
        np.testing.assert_array_equal(r["walls"], ranks[0]["walls"])
