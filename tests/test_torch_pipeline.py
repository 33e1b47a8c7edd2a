"""heat_tpu_torch's pipeline parallelism (parallel/schedule.py, parallel/pipeline.py,
nn/pipeline.py) against heat_tpu's.

The pure-Python parts bit for bit against the JAX package's: the schedule
tables (every tick of ``gpipe`` and ``1f1b``, the bubble accounting, the
steady window, the stash depth, the validation), ``build_schedule`` and
``plan_stages`` under the knobs, and the chunked layout (``plan_pipeline``,
each rank's rows of ``shard_pipeline_params``).

Training is held to sequential stage application (the JAX package's
``_ref_loss_grads`` form: the same microbatch loop and ``loss / M``
grouping, ``jax.value_and_grad`` and optax's Adam; the JAX package's own
pipeline step does not trace under this jax) within 1e-5 relative and
1e-6 absolute, and across layouts bit for bit: a world of one, a spawned
world of two (S = 2, M = 4) and one of four (S = 4, and S = 2 x local 2 under
``HEAT_TPU_TOPOLOGY=2x2 HEAT_TPU_HIERARCHICAL=1``) give the same bits, 1f1b
the same bits as gpipe. The four-stage step's hops and loss sum are audited
against ``pipeline_hop_cost`` (no drift); a checkpoint written by four ranks
after two steps resumes on a world of one and continues bit for bit as the
four ranks did.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from heat_tpu.core.communication import MeshCommunication
from heat_tpu.parallel import pipeline as jpl
from heat_tpu.parallel import schedule as jsch

import heat_tpu_torch as htt
from heat_tpu_torch import interop
from heat_tpu_torch.core.communication import TorchCommunication
from heat_tpu_torch.parallel import pipeline as tpl
from heat_tpu_torch.parallel import schedule as tsch

from .torch_spmd import spawn

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def on_cpu():
    htt.use_device("cpu")
    yield
    htt.use_device(None)


def _cells(table):
    return [[None if a is None else (a.kind, a.mb) for a in row] for row in table.ticks]


def _accounting(table):
    return (table.name, table.n_stages, table.n_microbatches, table.train, table.n_ticks,
            _cells(table), table.action_arrays(), table.describe(), table.busy_cells(),
            table.bubble_cells(), table.bubble_fraction(), table.steady_window(),
            table.steady_bubble_ticks(), table.stash_depth(),
            [table.phase_of(t) for t in range(table.n_ticks)])


@pytest.mark.parametrize("name", ["gpipe", "1f1b", "forward"])
@pytest.mark.parametrize("S", [1, 2, 3, 4, 5])
def test_schedule_tables_match(name, S):
    for M in (1, 2, 3, 4, 8):
        if name == "forward":
            got, want = tsch.gpipe_schedule(S, M, train=False), jsch.gpipe_schedule(S, M, False)
        elif name == "gpipe":
            got, want = tsch.gpipe_schedule(S, M), jsch.gpipe_schedule(S, M)
        else:
            got, want = tsch.one_f1b_schedule(S, M), jsch.one_f1b_schedule(S, M)
        assert _accounting(got) == _accounting(want)


def test_one_f1b_beats_gpipe_in_the_steady_window():
    for S, M in ((4, 8), (3, 4), (4, 4)):
        assert tsch.one_f1b_schedule(S, M).steady_bubble_ticks() < \
            tsch.gpipe_schedule(S, M).steady_bubble_ticks()
        assert tsch.one_f1b_schedule(S, M).stash_depth() == min(S, M)


def test_validation_and_names_match(monkeypatch):
    for package in (tsch, jsch):
        bad = package.ScheduleTable("bad", 1, 2, True, tuple(
            (package.Action(kind, mb),) for kind, mb in (("F", 1), ("F", 0), ("B", 0),
                                                         ("B", 1))))
        with pytest.raises(ValueError, match="forward order"):
            bad.validate()
        with pytest.raises(ValueError, match="at least one"):
            package.gpipe_schedule(0, 2)
        with pytest.raises(ValueError, match="unknown pipeline schedule"):
            package.resolve_schedule_name("interleaved")
    for raw in ("gpipe", "1F1B", "bogus"):
        monkeypatch.setenv("HEAT_TPU_PIPELINE_SCHEDULE", raw)
        assert tsch.resolve_schedule_name() == jsch.resolve_schedule_name()
        assert _accounting(tsch.build_schedule(3, 4)) == _accounting(jsch.build_schedule(3, 4))
        assert _accounting(tsch.build_schedule(3, 4, train=False)) == \
            _accounting(jsch.build_schedule(3, 4, train=False))


@pytest.mark.parametrize("env", [{}, {"HEAT_TPU_PIPELINE_STAGES": "2"},
                                 {"HEAT_TPU_HIERARCHICAL": "1"},
                                 {"HEAT_TPU_HIERARCHICAL": "1", "HEAT_TPU_TOPOLOGY": "4x2"}])
def test_plan_stages_matches(monkeypatch, env):
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    for p in (4, 8):
        got, want = tsch.plan_stages(p), jsch.plan_stages(p)
        assert (got.p, got.n_stages, got.local, got.groups(), got.fwd_perm(), got.bwd_perm(),
                got.describe()) == (want.p, want.n_stages, want.local, want.groups(),
                                    want.fwd_perm(), want.bwd_perm(), want.describe())
    with pytest.raises(ValueError, match="do not divide"):
        tsch.plan_stages(6, 4)


def _layers(n, d=8, seed=0):
    rng = np.random.default_rng(seed)
    return [{"w": (rng.standard_normal((d, d)) * 0.3).astype(np.float32),
             "b": (rng.standard_normal(d) * 0.1).astype(np.float32)} for _ in range(n)]


@pytest.mark.parametrize("p,S,wire", [(4, 2, "off"), (8, 4, "bf16"), (8, 2, "int8"),
                                      (3, 3, "blockwise")])
def test_layout_and_rows_match(p, S, wire):
    layers = _layers(6 if S == 3 else 8, d=5)
    want = jpl.plan_pipeline([{k: jnp.asarray(v) for k, v in lay.items()} for lay in layers],
                             jsch.StageMapping(p, S), wire)
    got = tpl.plan_pipeline(interop.pipeline_params_from_flax(layers), tsch.StageMapping(p, S),
                            wire)
    assert (got.local, got.layers_per_stage, got.wire) == (want.local, want.layers_per_stage,
                                                           want.wire)
    # the JAX package's leaves are in sorted-key order, the port's by name
    names = sorted(layers[0])
    assert dict(zip(got.names, zip(got.shapes, got.dtypes))) == dict(
        zip(names, zip(want.shapes, want.dtypes)))
    assert got.bytes_per_device() == want.bytes_per_device()
    assert {(p,) + r for r in got.row_shapes()} == want.row_shapes()
    rows = jpl.shard_pipeline_params([{k: jnp.asarray(v) for k, v in lay.items()}
                                      for lay in layers], want,
                                     MeshCommunication(devices=jax.devices()[:p]))
    comm = TorchCommunication()
    for rank in range(p):
        comm.rank, comm.size = rank, p
        mine = tpl.shard_pipeline_params(interop.pipeline_params_from_flax(layers), got, comm)
        for k in ("w", "b"):
            np.testing.assert_array_equal(mine[k].numpy(), np.asarray(rows[k])[rank])


# -- training ------------------------------------------------------------------------------

_MODEL = """
def mse(out, y):
    return ((out - y) ** 2).mean()


class Layer(torch.nn.Module):
    def __init__(self, d=8):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(d, d))
        self.b = torch.nn.Parameter(torch.zeros(d))

    def forward(self, h):
        return torch.tanh(h @ self.w + self.b)


def data():
    rng = np.random.default_rng(1)
    return (torch.from_numpy(rng.standard_normal((8, 8)).astype(np.float32)),
            torch.from_numpy(rng.standard_normal((8, 8)).astype(np.float32)))


def train(ht, layers, schedule, n_stages, steps, ck=None, resume=None, remat=False):
    pipe = ht.nn.Pipeline(Layer(), 4, optimizer=lambda ps: torch.optim.Adam(ps, lr=1e-2),
                          loss_fn=mse, n_stages=n_stages, n_microbatches=4, schedule=schedule,
                          prefetch=1, remat=remat)
    if resume is not None:
        params, state, _ = pipe.resume(resume, layers)
    else:
        params = pipe.shard_params(layers)
        state = pipe.init_opt_state(params)
    step = pipe.make_train_step()
    x, y = data()
    losses = []
    for i in range(steps):
        params, state, loss = step(params, state, x, y)
        losses.append(float(loss))
        if ck is not None and i == 1:
            pipe.save_checkpoint(ck, params, state, step=2)
    out = {"losses": np.array(losses), "forward": pipe(params, x).numpy(),
           "bytes": np.array(pipe.param_bytes_per_device())}
    for j, layer in enumerate(pipe.unshard_params(params)):
        for k, v in layer.items():
            out[f"{j}_{k}"] = v
    return out
"""

_SCRIPT = _MODEL + """
import os
from heat_tpu_torch.telemetry import collectives as costs, hlo


def run(ht, rank, world):
    init = np.load(f"{out}/init.npz")
    layers = [{k: torch.from_numpy(init[f"{j}_{k}"]) for k in ("w", "b")} for j in range(4)]
    res = {}
    for schedule in ("gpipe", "1f1b"):
        ck = f"{out}/pipe_ck" if (world == 4 and schedule == "1f1b") else None
        for key, v in train(ht, layers, schedule, world, 3, ck=ck).items():
            res[f"{schedule}_{key}"] = v
    if world == 4:
        pipe = ht.nn.Pipeline(Layer(), 4, optimizer=lambda ps: torch.optim.Adam(ps, lr=1e-2),
                              loss_fn=mse, n_stages=4, n_microbatches=4)
        params = pipe.shard_params(layers)
        state = pipe.init_opt_state(params)
        step = pipe.make_train_step()
        x, y = data()
        table = pipe._table(True)
        hops = 2 * (table.n_ticks - 1)
        predicted = costs.CollectiveCost(
            "ppermute-ring+all-reduce",
            hops * costs.pipeline_hop_cost(1, 2 * 8, 4, world).bytes + 2 * 4 * (world - 1))
        _, rec = hlo.audit_call("pipeline.step", lambda: step(params, state, x, y),
                                predicted=predicted)
        res["audit"] = np.array([rec.report.ok, rec.report.emitted_bytes,
                                 rec.report.predicted_bytes])
        os.environ["HEAT_TPU_TOPOLOGY"], os.environ["HEAT_TPU_HIERARCHICAL"] = "2x2", "1"
        for key, v in train(ht, layers, "gpipe", None, 3).items():
            res[f"tiered_{key}"] = v
    return res
"""

_ns = {"np": np, "torch": torch}
exec(_MODEL, _ns)


def _init(tmp):
    layers = _layers(4)
    np.savez(tmp / "init.npz", **{f"{j}_{k}": v for j, lay in enumerate(layers)
                                  for k, v in lay.items()})
    return layers


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp2, tmp4 = tmp_path_factory.mktemp("pipe2"), tmp_path_factory.mktemp("pipe4")
    _init(tmp2)
    layers = _init(tmp4)
    one = {}
    torch_layers = interop.pipeline_params_from_flax(layers)
    htt.use_device("cpu")
    for schedule in ("gpipe", "1f1b"):
        for key, v in _ns["train"](htt, torch_layers, schedule, 1, 3).items():
            one[f"{schedule}_{key}"] = v
    for key, v in _ns["train"](htt, torch_layers, "gpipe", 1, 3, remat=True).items():
        one[f"remat_{key}"] = v
    return {"layers": layers, "one": one, "two": spawn(tmp2, 2, _SCRIPT),
            "four": spawn(tmp4, 4, _SCRIPT), "tmp4": tmp4}


def _sequential(layers, steps=3, M=4):
    """The JAX package's sequential reference: the microbatch loop,
    ``loss / M`` each, optax's Adam."""
    x, y = (np.asarray(t) for t in _ns["data"]())
    mx, my = jnp.asarray(x).reshape(M, -1, 8), jnp.asarray(y).reshape(M, -1, 8)

    def f(params):
        tot = jnp.zeros((), jnp.float32)
        for m in range(M):
            h = mx[m]
            for w in params:
                h = jnp.tanh(h @ w["w"] + w["b"])
            tot = tot + jnp.mean((h - my[m]) ** 2) / M
        return tot

    params = [{k: jnp.asarray(v) for k, v in lay.items()} for lay in layers]
    opt = optax.adam(1e-2)
    state = opt.init(params)
    losses = []
    for _ in range(steps):
        loss, grads = jax.value_and_grad(f)(params)
        updates, state = opt.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        losses.append(float(loss))
    return params, losses


def test_world_of_one_matches_sequential_application(worlds):
    want, want_losses = _sequential(worlds["layers"])
    one = worlds["one"]
    np.testing.assert_allclose(one["gpipe_losses"], want_losses, rtol=RTOL, atol=ATOL)
    for j, lay in enumerate(want):
        for k in ("w", "b"):
            np.testing.assert_allclose(one[f"gpipe_{j}_{k}"], np.asarray(lay[k]), rtol=RTOL,
                                       atol=ATOL)
    h = _ns["data"]()[0]
    with torch.no_grad():
        for j in range(4):
            h = torch.tanh(h @ torch.from_numpy(one[f"gpipe_{j}_w"]) +
                           torch.from_numpy(one[f"gpipe_{j}_b"]))
    np.testing.assert_allclose(one["gpipe_forward"], h.numpy(), rtol=RTOL, atol=ATOL)


def test_layer_checkpoints_keep_the_bits(worlds):
    # remat=True checkpoints each layer inside the backward tick's recompute
    one = worlds["one"]
    for key in [k for k in one if k.startswith("gpipe_")]:
        np.testing.assert_array_equal(one["remat_" + key[len("gpipe_"):]], one[key],
                                      err_msg=key)


@pytest.mark.parametrize("world", ["two", "four"])
def test_every_layout_gives_the_world_of_ones_bits(worlds, world):
    one = worlds["one"]
    for r in worlds[world]:
        for key, v in one.items():
            if key.endswith("bytes"):
                continue
            for prefix in (("gpipe_", "1f1b_", "tiered_") if world == "four"
                           else ("gpipe_", "1f1b_")):
                if key.startswith("gpipe_"):
                    got = r[prefix + key[len("gpipe_"):]]
                    np.testing.assert_array_equal(got, v, err_msg=prefix + key)
        assert r["gpipe_bytes"] * (2 if world == "two" else 4) == one["gpipe_bytes"]


def test_four_stage_step_audit(worlds):
    for r in worlds["four"]:
        ok, emitted, predicted = r["audit"]
        assert ok and emitted == predicted


def test_checkpoint_of_four_ranks_resumes_on_a_world_of_one(worlds):
    layers = interop.pipeline_params_from_flax(worlds["layers"])
    resumed = _ns["train"](htt, layers, "gpipe", 1, 1, resume=str(worlds["tmp4"] / "pipe_ck"))
    for key, v in resumed.items():
        if key[0].isdigit():
            np.testing.assert_array_equal(v, worlds["four"][0][f"1f1b_{key}"], err_msg=key)
    np.testing.assert_array_equal(resumed["losses"], worlds["four"][0]["1f1b_losses"][2:])


def test_pipeline_apply_matches_the_stages_in_turn():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((8, 8)).astype(np.float32))
    stacked = {"w": torch.from_numpy(rng.standard_normal((1, 8, 8)).astype(np.float32))}
    out = tpl.pipeline_apply(lambda p, h: torch.tanh(h @ p["w"]), stacked, x,
                             comm=htt.get_comm(), n_microbatches=4)
    np.testing.assert_array_equal(out.numpy(), torch.tanh(x @ stacked["w"][0]).numpy())
    with pytest.raises(ValueError, match="exactly one stage"):
        tpl.pipeline_apply(lambda p, h: h, {"w": torch.zeros(2, 3)}, x, comm=htt.get_comm(),
                           n_microbatches=4)


def test_refusals(tmp_path):
    with pytest.raises(ValueError, match="do not divide"):
        tpl.plan_pipeline(interop.pipeline_params_from_flax(_layers(3)), tsch.StageMapping(2, 2))
    bad = interop.pipeline_params_from_flax(_layers(2))
    bad[1]["w"] = torch.zeros(3, 3)
    with pytest.raises(ValueError, match="not homogeneous"):
        tpl.plan_pipeline(bad, tsch.StageMapping(1, 1))
    pipe = htt.nn.Pipeline(_ns["Layer"](), 4, optimizer=lambda ps: torch.optim.SGD(ps, lr=0.1),
                           loss_fn=_ns["mse"], n_microbatches=4)
    params = pipe.shard_params(pipe.init())
    htt.resilience.save_checkpoint({"w": np.zeros(2)}, str(tmp_path / "ck"),
                                   extra={"algo": "zero"})
    with pytest.raises(htt.resilience.CheckpointError, match="not pipeline"):
        pipe.resume(str(tmp_path / "ck"), pipe.init())
    pipe.save_checkpoint(str(tmp_path / "pk"), params, pipe.init_opt_state(params))
    other = htt.nn.Pipeline(_ns["Layer"](), 2, optimizer=lambda ps: torch.optim.SGD(ps, lr=0.1))
    with pytest.raises(htt.resilience.CheckpointError, match="layers"):
        other.resume(str(tmp_path / "pk"), other.init())


# -- weights carried across ------------------------------------------------------------------


def _tree_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], dict):
            _tree_equal(a[k], b[k])
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


def test_flax_blocks_carry_into_the_pipeline_and_back():
    """A flax TransformerBlock's variables into the port's block (the same
    forward within 1e-5), the JAX Pipeline's per-layer list into the port's
    (each layer's logical parameters), and back: ``to_flax_params`` returns
    the flax tree bit for bit."""
    from heat_tpu import nn as jnn

    x = np.random.default_rng(4).standard_normal((2, 8, 16)).astype(np.float32)
    ref = jnn.TransformerBlock(4)
    variables = [jax.tree.map(np.asarray, ref.init(jax.random.PRNGKey(j), jnp.asarray(x)))
                 for j in range(3)]
    block = interop.transformer_block_from_flax(variables[0], num_heads=4, d_model=16)
    with torch.no_grad():
        got = block(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(ref.apply(variables[0], jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)
    _tree_equal(interop.to_flax_params(block), variables[0]["params"])
    layers = interop.pipeline_params_from_flax(variables, htt.nn.TransformerBlock(4, d_model=16))
    pipe = htt.nn.Pipeline(htt.nn.TransformerBlock(4, d_model=16), 3, n_microbatches=2)
    assert pipe.plan(layers).names == tuple(layers[0])
    for layer, want in zip(layers, variables):
        carried = htt.nn.TransformerBlock(4, d_model=16)
        carried.load_state_dict(layer)
        _tree_equal(interop.to_flax_params(carried), want["params"])
