"""heat_tpu_torch's ZeroOptimizer (optim/zero_optimizer.py) against heat_tpu's replicated twin.

The JAX package's own ZeRO train step does not trace under this jax (its
``tests/test_zero_optimizer.py`` fails there), so the port is held to the
JAX package's replicated twin, ``DataParallel`` with the same optax
optimizer, and to its own ``DataParallel``:

* a world of one: bit for bit ``DataParallel``'s trajectory with SGD and
  AdamW (the chunk update is the elementwise update of those elements);
* one spawned world of four gloo ranks, three Adam steps of the MLP: within
  1e-5 relative and 1e-6 absolute of the JAX twin and of the port's
  ``DataParallel`` (the reduce-scatter sums in another order), every rank
  bit for bit the same; the optimizer-state bytes a rank strictly below the
  replicated optimizer's; the compressed gradient wires (bf16, int8,
  blockwise) within ``quant_error_bound`` of the gradients at ``p + 1`` hops
  (times the learning rate, over three steps) of the exact run; the tiered
  reduce-scatter (``HEAT_TPU_TOPOLOGY=2x2 HEAT_TPU_HIERARCHICAL=1``) within
  the same f32 tolerance of the flat one; the ``step`` form on averaged
  gradients equal to ``DataParallelOptimizer``'s step; the blockwise state
  chunks rounded to whole blocks;
* the logical checkpoint written by four ranks restored on a world of one:
  parameters and optimizer state bit for bit; a checkpoint of another
  algorithm refused.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from heat_tpu.core.communication import MeshCommunication
from heat_tpu.nn import DataParallel as JDataParallel

import heat_tpu_torch as htt
from heat_tpu_torch.core import collective_prec as cp
from heat_tpu_torch.optim.zero_optimizer import logical_state
from heat_tpu_torch.parallel import fsdp as tfsdp

from .torch_spmd import spawn

RTOL, ATOL = 1e-5, 1e-6

_MODEL = """
def make_data(n, d=8, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    y = (x @ rng.standard_normal((d, 1)).astype(np.float32)).astype(np.float32)
    return x, y


def mlp_init(d=8, h=16, seed=1):
    rng = np.random.default_rng(seed)
    return {"w1": rng.standard_normal((d, h)).astype(np.float32) * 0.1,
            "b1": np.zeros((h,), np.float32),
            "w2": rng.standard_normal((h, 1)).astype(np.float32) * 0.1,
            "b2": np.zeros((1,), np.float32)}


class MLP(torch.nn.Module):
    def __init__(self, params):
        super().__init__()
        for k, v in params.items():
            setattr(self, k, torch.nn.Parameter(torch.from_numpy(np.array(v))))

    def forward(self, x):
        return torch.tanh(x @ self.w1 + self.b1) @ self.w2 + self.b2


def mse(module, x, y):
    return ((module(x) - y) ** 2).mean()
"""
_ns = {"np": np, "torch": torch}
exec(_MODEL, _ns)
make_data, mlp_init, MLP, mse = _ns["make_data"], _ns["mlp_init"], _ns["MLP"], _ns["mse"]


@pytest.fixture(autouse=True)
def on_cpu():
    htt.use_device("cpu")
    yield
    htt.use_device(None)


@pytest.mark.parametrize("make_opt", [lambda ps: torch.optim.SGD(ps, lr=0.1),
                                      lambda ps: torch.optim.AdamW(ps, lr=1e-2)],
                         ids=["sgd", "adamw"])
def test_world_of_one_is_data_parallel_bit_for_bit(make_opt):
    x, y = make_data(16)
    ref = MLP(mlp_init())
    opt = make_opt(ref.parameters())
    step = htt.nn.DataParallel(ref, optimizer=opt, blocking_parameter_updates=True) \
        .make_train_step(mse)
    zm = MLP(mlp_init())
    zero = htt.optim.ZeroOptimizer(make_opt(zm.parameters()))
    state = zero.init(zm)
    zstep = zero.make_train_step(mse)
    x, y = zero.shard_batch(x, y)
    for _ in range(3):
        _, _, want = step(ref, opt, x, y)
        _, _, got = zstep(zm, state, x, y)
        assert float(got) == float(want)
    for (k, a), (_, b) in zip(ref.named_parameters(), zm.named_parameters()):
        assert torch.equal(a, b), k
    assert zero.state_bytes_per_device() == sum(
        v.numel() * v.element_size() for st in opt.state.values() for v in st.values()
        if torch.is_tensor(v))


def test_refusals_and_the_optimizer_forms(tmp_path):
    with pytest.raises(TypeError, match="torch.optim.Optimizer"):
        htt.optim.ZeroOptimizer(3)
    with pytest.raises(ValueError, match="precision must be one of"):
        htt.optim.ZeroOptimizer(lambda ps: torch.optim.SGD(ps, lr=0.1), precision="fp8")
    m = MLP(mlp_init())
    zero = htt.optim.ZeroOptimizer(lambda ps: torch.optim.SGD(ps, lr=0.1), precision="blockwise")
    zero.init(m)
    assert [s.numel() for s in zero.shards] == [
        tfsdp.flat_chunk(p.numel(), 1, "blockwise", 128) for p in m.parameters()]
    htt.resilience.save_checkpoint({"w": np.zeros(2)}, str(tmp_path / "ck"),
                                   extra={"algo": "fsdp"})
    with pytest.raises(htt.resilience.CheckpointError, match="not zero"):
        zero.load_checkpoint(str(tmp_path / "ck"), m)


_SCRIPT = _MODEL + """
import os
from heat_tpu_torch.optim.zero_optimizer import logical_state


def run(ht, rank, world):
    x, y = make_data(16)
    res = {}

    def train(kind, wire=None):
        m = MLP(mlp_init())
        if kind == "dp":
            opt = torch.optim.Adam(m.parameters(), lr=1e-2)
            dp = ht.nn.DataParallel(m, optimizer=opt, blocking_parameter_updates=True)
            step, state = dp.make_train_step(mse), opt
        else:
            zero = ht.optim.ZeroOptimizer(torch.optim.Adam(m.parameters(), lr=1e-2),
                                          precision=wire)
            step, state = zero.make_train_step(mse), zero.init(m)
        xb, yb = ht.nn.DataParallel(m).shard_batch(x, y)
        losses = []
        for _ in range(3):
            _, _, loss = step(m, state, xb, yb)
            losses.append(float(loss))
        res[kind + "_losses"] = np.array(losses)
        for k, v in m.named_parameters():
            res[f"{kind}_{k}"] = v.detach().numpy().copy()
        opt = state if kind == "dp" else state.torch_optimizer
        res[kind + "_state_bytes"] = np.array(sum(v.numel() * v.element_size()
                                                  for st in opt.state.values()
                                                  for v in st.values() if torch.is_tensor(v)))
        return m, state

    train("dp")
    m, zero = train("zero")
    zero.save_checkpoint(f"{out}/zero_ck", m)
    for key, v in logical_state(zero.torch_optimizer, zero._specs, zero.comm).items():
        res["state_" + key] = np.asarray(v)
    for wire in ("bf16", "int8", "blockwise"):
        train("zero_" + wire, wire)
    os.environ["HEAT_TPU_TOPOLOGY"], os.environ["HEAT_TPU_HIERARCHICAL"] = "2x2", "1"
    train("zero_tiered")
    os.environ["HEAT_TPU_HIERARCHICAL"] = "0"
    # the step form, on averaged gradients, against DataParallelOptimizer's
    grads = {k: torch.full_like(v, 0.5) for k, v in MLP(mlp_init()).named_parameters()}
    for kind in ("dpo", "zero_step"):
        m = MLP(mlp_init())
        if kind == "dpo":
            o = ht.optim.DataParallelOptimizer(torch.optim.SGD(m.parameters(), lr=0.1))
        else:
            o = ht.optim.ZeroOptimizer(torch.optim.SGD(m.parameters(), lr=0.1))
        state = o.init(m)
        o.step(m, state, grads)
        for k, v in m.named_parameters():
            res[f"{kind}_{k}"] = v.detach().numpy().copy()
    return res
"""


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("zero")
    return tmp, spawn(tmp, 4, _SCRIPT)


def _jax_twin():
    x, y = make_data(16)
    comm = MeshCommunication(devices=jax.devices()[:4])

    def apply(p, v):
        return jnp.tanh(v @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]

    dp = JDataParallel(apply, comm=comm, optimizer=optax.adam(1e-2),
                       blocking_parameter_updates=True)
    step = dp.make_train_step(lambda p, a, b: jnp.mean((apply(p, a) - b) ** 2))
    params = jax.device_put({k: jnp.asarray(v) for k, v in mlp_init().items()},
                            comm.replicated())
    state = optax.adam(1e-2).init(params)
    xb, yb = dp.shard_batch(jnp.asarray(x), jnp.asarray(y))
    losses = []
    for _ in range(3):
        params, state, loss = step(params, state, xb, yb)
        losses.append(float(loss))
    grads = jax.grad(lambda p: jnp.mean((apply(p, jnp.asarray(x)) - jnp.asarray(y)) ** 2))(
        {k: jnp.asarray(v) for k, v in mlp_init().items()})
    return params, losses, 2.0 * max(float(jnp.abs(g).max()) for g in grads.values())


def test_world_of_four_trains_as_the_replicated_twins(four):
    _, ranks = four
    want, want_losses, _ = _jax_twin()
    for r in ranks:
        for kind in ("zero", "zero_tiered"):
            np.testing.assert_allclose(r[kind + "_losses"], want_losses, rtol=RTOL, atol=ATOL)
            for k in want:
                np.testing.assert_allclose(r[f"{kind}_{k}"], np.asarray(want[k]), rtol=RTOL,
                                           atol=ATOL, err_msg=k)
                np.testing.assert_allclose(r[f"{kind}_{k}"], r[f"dp_{k}"], rtol=RTOL, atol=ATOL)
        for key in r:
            np.testing.assert_array_equal(r[key], ranks[0][key], err_msg=key)
        assert 0 < r["zero_state_bytes"] < r["dp_state_bytes"]
        for k in want:
            np.testing.assert_array_equal(r[f"zero_step_{k}"], r[f"dpo_{k}"])


@pytest.mark.parametrize("wire", ["bf16", "int8", "blockwise"])
def test_world_of_four_compressed_gradient_wire(four, wire):
    _, ranks = four
    want, _, gmax = _jax_twin()
    # Adam normalizes the update: a gradient error moves each step by at most
    # lr times the relative error of the moments; bound it by the gradient's
    # quantization error over the smallest gradient scale seen (1e-2) a step
    bound = 3 * 1e-2 * min(1.0, cp.quant_error_bound(gmax, wire, 5) / 1e-2)
    for r in ranks:
        for k in want:
            np.testing.assert_allclose(r[f"zero_{wire}_{k}"], r[f"zero_{k}"], rtol=0,
                                       atol=ATOL + bound, err_msg=k)


def test_world_of_four_checkpoint_restores_on_a_world_of_one(four):
    tmp, ranks = four
    m = MLP(mlp_init(seed=5))
    zero = htt.optim.ZeroOptimizer(torch.optim.Adam(m.parameters(), lr=1e-2))
    m, state = zero.load_checkpoint(str(tmp / "zero_ck"), m)
    for k, v in m.named_parameters():
        np.testing.assert_array_equal(v.detach().numpy(), ranks[0][f"zero_{k}"])
    restored = logical_state(state.torch_optimizer, state._specs, state.comm)
    assert set(restored) == {k[6:] for k in ranks[0] if k.startswith("state_")}
    for key, value in restored.items():
        np.testing.assert_array_equal(np.asarray(value), ranks[0]["state_" + key], err_msg=key)
