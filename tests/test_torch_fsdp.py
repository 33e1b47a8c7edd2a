"""heat_tpu_torch's FSDP layouts and wrapper (parallel/fsdp.py, nn/fsdp.py) against heat_tpu's.

The rules bit for bit against the JAX package's: ``flat_chunk``,
``PartitionRules`` (``match``, ``repr``/``parse``, its refusals) and
``plan_partition`` (every leaf's placement, wire and chunk, the ambiguous-
plan refusal) on the same named tree.

Training is held to the JAX package's replicated twin (``FSDP`` with
``HEAT_TPU_FSDP=0``, its DataParallel step) on four devices: its sharded
step does not trace under this jax (its gather's custom VJP returns an
unvarying gradient for a varying input), so it is no oracle here. One
spawned world of four gloo ranks trains three stages (flax ``Dense``
weights carried by ``interop.fsdp_params_from_flax``) for three Adam steps:

* sharded (prefetch 0 and 1) against the JAX twin within 1e-5 relative and
  1e-6 absolute (the f32 tolerance of ``tests/test_torch_dp.py``; the
  reduce-scatter sums in another order than the all-reduce, the JAX
  package's own documented bound for that is 1e-6), and against the port's
  own replicated twin likewise;
* prefetch 0 and 1 bit for bit (pure scheduling);
* parameter and optimizer bytes a rank strictly below the replicated run's;
* the forward's gathers audited against ``fsdp_gather_cost`` (no drift);
* the logical checkpoint written by four ranks restored on a world of one:
  the parameters and the optimizer state bit for bit.

On a world of one the LM's stages (embedding, blocks, head) train bit for
bit as ``DataParallel`` does, with SGD and AdamW.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import flax.linen as fnn
import jax
import jax.numpy as jnp
import optax

from heat_tpu.core.communication import MeshCommunication
from heat_tpu.nn.fsdp import FSDP as JFSDP
from heat_tpu.parallel import fsdp as jfsdp

import heat_tpu_torch as htt
from heat_tpu_torch import interop
from heat_tpu_torch.core.communication import TorchCommunication
from heat_tpu_torch.parallel import fsdp as tfsdp

from .torch_spmd import spawn

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def on_cpu():
    htt.use_device("cpu")
    yield
    htt.use_device(None)


def _comm_of(p):
    """A world-of-one communicator that reports ``p`` ranks (the plan only
    reads the size)."""
    comm = TorchCommunication()
    comm.size, comm._hosts = p, 1
    return comm


@pytest.mark.parametrize("wire", ["off", "bf16", "int8", "blockwise"])
def test_flat_chunk_matches(wire):
    for numel in (1, 7, 100, 128, 129, 1000, 4097):
        for p in (1, 3, 4, 8):
            for block in (1, 64, 128):
                assert tfsdp.flat_chunk(numel, p, wire, block) == \
                    jfsdp.flat_chunk(numel, p, wire, block)


RULES = [
    ((".*", "fsdp"),),
    (("ln|bias", "replicate"), ("attn/(query|key)", "fsdp", "bf16"), ("emb", "fsdp", "int8"),
     (".*", "fsdp")),
    (("block0", "replicate"),),
    (("scale$", "fsdp", "blockwise"), ("nothing", "replicate")),
]

_TREE = {"emb": (10, 8), "block0": {"attn": {"query": (8, 8), "key": (8, 8), "value": (8, 3)},
                                     "ln": {"scale": (8,), "bias": (8,)}},
         "block1": {"w": (5, 7), "bias": (7,)}, "step": ()}


def _trees():
    rng = np.random.default_rng(0)

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        return rng.standard_normal(node).astype(np.float32)

    arrays = build(_TREE)
    to = lambda f, n: {k: to(f, v) if isinstance(v, dict) else f(v)  # noqa: E731
                       for k, v in n.items()}
    return to(jnp.asarray, arrays), to(torch.from_numpy, arrays)


@pytest.mark.parametrize("rules", range(len(RULES)))
@pytest.mark.parametrize("p", [1, 4, 8])
def test_plan_partition_matches(rules, p):
    jtree, ttree = _trees()
    jrules, trules = jfsdp.PartitionRules(RULES[rules]), tfsdp.PartitionRules(RULES[rules])
    assert repr(trules) == repr(jrules)
    assert tfsdp.PartitionRules.parse(repr(trules)) == trules
    jcomm = MeshCommunication(devices=jax.devices()[:p])
    want = jfsdp.plan_partition(jtree, jrules, jcomm)
    got = tfsdp.plan_partition(ttree, trules, _comm_of(p))
    key = lambda lf: (lf.path, lf.shape, lf.dtype, lf.sharded, lf.wire, lf.chunk,  # noqa: E731
                      lf.rule)
    assert sorted(map(key, got.leaves)) == sorted(map(key, want.leaves))
    for path, _ in tfsdp.leaf_paths(ttree):
        assert trules.match(path) == jrules.match(path)


def test_rule_refusals_match():
    for bad in ([("(", "fsdp")], [("x", "shard")], [("x", "fsdp", "fp8")], [("x",)]):
        for package in (tfsdp, jfsdp):
            with pytest.raises(Exception):
                package.PartitionRules(bad)
    # a replicated leaf shaped like a sharded leaf's (p, chunk) row is refused
    tree_j = {"a": jnp.zeros((8, 8)), "b": jnp.zeros((4, 16))}
    tree_t = {"a": torch.zeros(8, 8), "b": torch.zeros(4, 16)}
    rules = [("a", "fsdp"), ("b", "replicate")]
    with pytest.raises(ValueError, match="ambiguous"):
        jfsdp.plan_partition(tree_j, jfsdp.PartitionRules(rules),
                             MeshCommunication(devices=jax.devices()[:4]))
    with pytest.raises(ValueError, match="ambiguous"):
        tfsdp.plan_partition(tree_t, tfsdp.PartitionRules(rules), _comm_of(4))


def test_shard_unshard_and_flat_rows_roundtrip():
    _, tree = _trees()
    plan = tfsdp.plan_partition(tree, None, htt.get_comm())
    rows = tfsdp.fsdp_shard(tree, plan)
    back = tfsdp.fsdp_unshard(rows, plan)
    for (path, a), (_, b) in zip(tfsdp.leaf_paths(tree), tfsdp.leaf_paths(back)):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=path)
    flat = tfsdp.flat_shard_pytree(tree, wire="blockwise", block=4)
    emb = flat["emb"]
    assert emb.shape == (1, tfsdp.flat_chunk(80, 1, "blockwise", 4)) and emb.split == 0
    np.testing.assert_array_equal(tfsdp.flat_unshard_leaf(emb, (10, 8)), tree["emb"].numpy())
    assert tfsdp.bytes_per_device(rows) == sum(t.numel() * 4 for t in tfsdp._leaves(tree))
    split = tfsdp.shard_pytree(tree, min_size=16)
    assert split["emb"].split == 0 and split["block0"]["ln"]["scale"].split is None
    whole = tfsdp.replicate_pytree(split)
    np.testing.assert_array_equal(whole["emb"].numpy(), tree["emb"].numpy())


# -- the world of one: the LM's stages -------------------------------------------------------


def _lm():
    return htt.nn.TransformerLM(50, 32, 4, 2, max_len=16, attn_impl="local",
                                generator=torch.Generator().manual_seed(0))


def _ce(logits, tokens):
    return F.cross_entropy(logits[:, :-1].float().reshape(-1, 50), tokens[:, 1:].reshape(-1))


@pytest.mark.parametrize("make_opt", [lambda ps: torch.optim.SGD(ps, lr=0.1),
                                      lambda ps: torch.optim.AdamW(ps, lr=1e-2)],
                         ids=["sgd", "adamw"])
def test_world_of_one_lm_stages_train_as_data_parallel(monkeypatch, make_opt):
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 50, (4, 16)))
    ref = _lm()
    opt = make_opt(ref.parameters())
    dp = htt.nn.DataParallel(ref, optimizer=opt, blocking_parameter_updates=True)
    step = dp.make_train_step(lambda m, t: _ce(m(t), t))
    for _ in range(3):
        step(ref, opt, tokens)
    want = dict(ref.named_parameters())
    monkeypatch.setenv("HEAT_TPU_FSDP", "1")
    for prefetch in (0, 1, 3):
        lm = _lm()
        model = htt.nn.FSDP(lm.stages(), optimizer=make_opt, prefetch=prefetch)
        params = model.shard_params(model.init())
        state = model.init_opt_state(params)
        fstep = model.make_train_step(_ce)
        for _ in range(3):
            params, state, _ = fstep(params, state, tokens, tokens)
        logical = model.unshard_params(params)
        for k, stage in enumerate(logical):
            prefix = f"blocks.{k - 1}." if 0 < k < len(logical) - 1 else ""
            for name, value in stage.items():
                np.testing.assert_array_equal(value, want[prefix + name].detach().numpy(),
                                              err_msg=prefix + name)


# -- the world of four -------------------------------------------------------------------------

STAGES = (fnn.Dense(24), fnn.Dense(24), fnn.Dense(4))


def _data():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((8, 8)).astype(np.float32),
            rng.standard_normal((8, 4)).astype(np.float32))


_SCRIPT = """
import os
from heat_tpu_torch.optim.zero_optimizer import logical_state
from heat_tpu_torch.telemetry import collectives as costs, hlo


def mse(out, y):
    return ((out - y) ** 2).mean()


def run(ht, rank, world):
    init = np.load(f"{out}/init.npz")
    x, y = torch.from_numpy(init["x"]), torch.from_numpy(init["y"])
    res = {}
    for enabled, prefetch in (("1", 0), ("1", 1), ("0", 0)):
        os.environ["HEAT_TPU_FSDP"] = enabled
        stages = [torch.nn.Linear(8, 24), torch.nn.Linear(24, 24), torch.nn.Linear(24, 4)]
        model = ht.nn.FSDP(stages, optimizer=lambda ps: torch.optim.Adam(ps, lr=1e-2),
                           prefetch=prefetch)
        logical = [{n: torch.from_numpy(init[f"{k}_{n}"]) for n in ("weight", "bias")}
                   for k in range(3)]
        params = model.shard_params(logical)
        state = model.init_opt_state(params)
        step = model.make_train_step(mse)
        xb, yb = model.shard_batch(x, y)
        tag = f"{enabled}{prefetch}"
        if enabled == "1" and prefetch == 0:
            plan = model._plan
            predicted = costs.CollectiveCost("all-gather", sum(
                costs.fsdp_gather_cost(lf.chunk, 4, 1, world).bytes for lf in plan.leaves
                if lf.sharded))
            with torch.no_grad():
                _, rec = hlo.audit_call("fsdp_forward", lambda: model(params, x),
                                        predicted=predicted)
            res["audit"] = np.array([rec.report.ok, rec.report.emitted_bytes,
                                     rec.report.predicted_bytes])
        losses = []
        for _ in range(3):
            params, state, loss = step(params, state, xb, yb)
            losses.append(float(loss))
        res[f"losses_{tag}"] = np.array(losses)
        for k, stage in enumerate(model.unshard_params(params)):
            for n, v in stage.items():
                res[f"p{tag}_{k}_{n}"] = v
        res[f"bytes_{tag}"] = np.array([model.param_bytes_per_device(params), sum(
            v.numel() * 4 for st in state.state.values() for v in st.values()
            if torch.is_tensor(v) and v.dim() > 0)])
        if tag == "11":
            model.save_checkpoint(f"{out}/fsdp_ck", params, state)
            for key, v in logical_state(state, model._specs(params), model.comm).items():
                res["state_" + key] = np.asarray(v)
    return res
"""


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fsdp")
    x, y = _data()
    variables = JFSDP(list(STAGES)).init(jax.random.PRNGKey(0), jnp.asarray(x))
    logical = [jax.tree.map(np.asarray, v) for v in variables]
    stages = [torch.nn.Linear(8, 24), torch.nn.Linear(24, 24), torch.nn.Linear(24, 4)]
    carried = interop.fsdp_params_from_flax(logical, stages)
    np.savez(tmp / "init.npz", x=x, y=y, **{f"{k}_{n}": v.numpy() for k, stage in
                                            enumerate(carried) for n, v in stage.items()})
    return tmp, logical, spawn(tmp, 4, _SCRIPT)


def _jax_replicated(monkeypatch, logical):
    """The JAX package's replicated twin (HEAT_TPU_FSDP=0) on four devices,
    three Adam steps: its logical parameters and losses."""
    monkeypatch.setenv("HEAT_TPU_FSDP", "0")
    x, y = _data()
    model = JFSDP(list(STAGES), comm=MeshCommunication(devices=jax.devices()[:4]),
                  optimizer=optax.adam(1e-2))
    params = model.shard_params(tuple(jax.tree.map(jnp.asarray, v) for v in logical))
    state = model.init_opt_state(params)
    step = model.make_train_step(lambda out, t: jnp.mean((out - t) ** 2))
    xb, yb = model.shard_batch(jnp.asarray(x), jnp.asarray(y))
    losses = []
    for _ in range(3):
        params, state, loss = step(params, state, xb, yb)
        losses.append(float(loss))
    return model.unshard_params(params), losses


@pytest.mark.parametrize("tag", ["10", "11", "00"])
def test_world_of_four_trains_as_the_replicated_twin(four, monkeypatch, tag):
    _, logical, ranks = four
    want, want_losses = _jax_replicated(monkeypatch, logical)
    for r in ranks:
        np.testing.assert_allclose(r[f"losses_{tag}"], want_losses, rtol=RTOL, atol=ATOL)
        for k, stage in enumerate(want):
            p = stage["params"]
            np.testing.assert_allclose(r[f"p{tag}_{k}_weight"], np.asarray(p["kernel"]).T,
                                       rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(r[f"p{tag}_{k}_bias"], np.asarray(p["bias"]), rtol=RTOL,
                                       atol=ATOL)
            # against the port's own replicated twin
            for n in ("weight", "bias"):
                np.testing.assert_allclose(r[f"p{tag}_{k}_{n}"], r[f"p00_{k}_{n}"], rtol=RTOL,
                                           atol=ATOL)


def test_world_of_four_prefetch_is_pure_scheduling(four):
    _, _, ranks = four
    for r in ranks:
        for key in r:
            if key.startswith("p10_") or key.startswith("losses_10"):
                np.testing.assert_array_equal(r[key], r[key.replace("10", "11", 1)], err_msg=key)


def test_world_of_four_bytes_and_audit(four):
    _, _, ranks = four
    for r in ranks:
        (p_sharded, s_sharded), (p_full, s_full) = r["bytes_10"], r["bytes_00"]
        assert p_sharded < p_full and s_sharded < s_full
        assert 4 * p_sharded >= p_full
        ok, emitted, predicted = r["audit"]
        assert ok and emitted == predicted


def test_world_of_four_checkpoint_restores_on_a_world_of_one(four, monkeypatch):
    tmp, _, ranks = four
    monkeypatch.setenv("HEAT_TPU_FSDP", "1")
    stages = [torch.nn.Linear(8, 24), torch.nn.Linear(24, 24), torch.nn.Linear(24, 4)]
    model = htt.nn.FSDP(stages, optimizer=lambda ps: torch.optim.Adam(ps, lr=1e-2))
    params, state = model.load_checkpoint(str(tmp / "fsdp_ck"), model.init())
    for k, stage in enumerate(model.unshard_params(params)):
        for n, v in stage.items():
            np.testing.assert_array_equal(v, ranks[0][f"p11_{k}_{n}"])
    from heat_tpu_torch.optim.zero_optimizer import logical_state

    restored = logical_state(state, model._specs(params), model.comm)
    assert set(restored) == {k[6:] for k in ranks[0] if k.startswith("state_")}
    for key, value in restored.items():
        np.testing.assert_array_equal(np.asarray(value), ranks[0]["state_" + key], err_msg=key)
    htt.resilience.save_checkpoint({"w": np.zeros(2)}, str(tmp / "other"), extra={"algo": "zero"})
    with pytest.raises(htt.resilience.CheckpointError, match="not fsdp"):
        model.load_checkpoint(str(tmp / "other"), model.init())


def test_flax_stages_carry_into_fsdp_and_back():
    """The JAX FSDP's logical per-stage params (flax Dense stages) into the
    port's Linear stages and back, bit for bit; the carried stages compute
    the flax stages' forward within 1e-6."""
    x, _ = _data()
    variables = JFSDP(list(STAGES)).init(jax.random.PRNGKey(3), jnp.asarray(x))
    logical = [jax.tree.map(np.asarray, v) for v in variables]
    stages = [torch.nn.Linear(8, 24), torch.nn.Linear(24, 24), torch.nn.Linear(24, 4)]
    carried = interop.fsdp_params_from_flax(logical, stages)
    assert [set(s) for s in carried] == [{"weight", "bias"}] * 3
    h, want = torch.from_numpy(x), jnp.asarray(x)
    for stage, module, flax_stage in zip(logical, stages, STAGES):
        back = interop.to_flax_params(module)
        for k in ("kernel", "bias"):
            np.testing.assert_array_equal(back[k], stage["params"][k])
        with torch.no_grad():
            h = module(h)
        want = flax_stage.apply(stage, want)
    np.testing.assert_allclose(h.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
