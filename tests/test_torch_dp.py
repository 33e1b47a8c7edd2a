"""heat_tpu_torch's data parallelism and optimizers against heat_tpu.

The JAX package's behavioural tests of ``nn.DataParallel``,
``DataParallelMultiGPU``, ``optim.DataParallelOptimizer``, ``DASO``,
``DetectMetricPlateau`` and the ``lr_scheduler`` factories
(``tests/test_nn_optim.py``, ``test_plateau_detector.py``,
``test_lr_scheduler.py``) as parity cases: the same numpy inputs and
weights through both packages, the port as a world of one in this process,
and one spawned world of four gloo ranks (2 nodes x 2) against the JAX
package on four devices (``MeshCommunication(devices=jax.devices()[:4])``):
DataParallel in both modes, DASO through warmup, cycling and cooldown.

The port's contract holds the parameters in a ``torch.nn.Module`` and the
optimizer state in a ``torch.optim.Optimizer``: ``params`` is the module and
``opt_state`` the optimizer, updated in place. The MLP here is the JAX
tests' ``tanh(x @ w1 + b1) @ w2 + b2`` with the same parameter names,
carried across by ``interop.load_params``.

Tolerances: f32 training against the JAX package 1e-5 relative and 1e-6
absolute (the JAX tests' own); DASO's schedule state per epoch exactly, its
parameters within 2^-7 of their largest magnitude after the bf16
cross-node merges (each merge rounds the node means to bf16, 2^-8 relative,
and a value near a rounding boundary may round the other way on the other
side); the replicas of the world of four bit for bit after each fully
synchronised epoch; the lr schedules within 1e-6 of the base lr against
optax's f32 values over steps 0-200; the plateau detector's decisions and
state exactly.
"""

import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import heat_tpu as ht_tpu
from heat_tpu.core.communication import MeshCommunication
from heat_tpu.nn import DataParallel as JDataParallel
from heat_tpu.optim import DASO as JDASO
from heat_tpu.optim import DetectMetricPlateau as JPlateau
from heat_tpu.optim import lr_scheduler as jlr

import heat_tpu_torch as htt
from heat_tpu_torch import interop
from heat_tpu_torch.nn import DataParallel, DataParallelMultiGPU
from heat_tpu_torch.optim import DASO, DataParallelOptimizer, DetectMetricPlateau, lr_scheduler

REPO = Path(__file__).resolve().parent.parent
RTOL, ATOL = 1e-5, 1e-6
BF16_MERGE_TOL = 2.0 ** -7

_MODEL = textwrap.dedent("""
    import numpy as np
    import torch

    def make_data(n, d=8, seed=0):
        rng = np.random.default_rng(seed)
        x = rng.standard_normal((n, d)).astype(np.float32)
        w_true = rng.standard_normal((d, 1)).astype(np.float32)
        y = x @ w_true + 0.01 * rng.standard_normal((n, 1)).astype(np.float32)
        return x, y

    def mlp_init(d, h=16, seed=0):
        rng = np.random.default_rng(seed)
        return {"w1": rng.standard_normal((d, h)).astype(np.float32) * 0.1,
                "b1": np.zeros((h,), np.float32),
                "w2": rng.standard_normal((h, 1)).astype(np.float32) * 0.1,
                "b2": np.zeros((1,), np.float32)}

    class MLP(torch.nn.Module):
        def __init__(self, d, h=16):
            super().__init__()
            self.w1 = torch.nn.Parameter(torch.zeros(d, h))
            self.b1 = torch.nn.Parameter(torch.zeros(h))
            self.w2 = torch.nn.Parameter(torch.zeros(h, 1))
            self.b2 = torch.nn.Parameter(torch.zeros(1))

        def forward(self, x):
            return torch.tanh(x @ self.w1 + self.b1) @ self.w2 + self.b2

    def mse(module, x, y):
        return ((module(x) - y) ** 2).mean()

    DASO_RUN = dict(total_epochs=8, warmup_epochs=2, cooldown_epochs=2, max_global_skips=4)
    DASO_BATCHES, DASO_BS = 4, 8
""")
_ns = {}
exec(_MODEL, _ns)
make_data, mlp_init, MLP, mse = _ns["make_data"], _ns["mlp_init"], _ns["MLP"], _ns["mse"]


@pytest.fixture(autouse=True)
def on_cpu():
    htt.use_device("cpu")
    yield
    htt.use_device(None)


def jax_apply(params, x):
    return jnp.tanh(x @ params["w1"] + params["b1"]) @ params["w2"] + params["b2"]


def jax_mse(params, x, y):
    return jnp.mean((jax_apply(params, x) - y) ** 2)


def _jparams(params):
    return {k: jnp.asarray(v) for k, v in params.items()}


def model(params):
    return interop.load_params(MLP(8), params)


def _hold(module_or_dict, want, rtol=RTOL, atol=ATOL):
    got = module_or_dict if isinstance(module_or_dict, dict) else dict(
        module_or_dict.named_parameters())
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k].detach() if hasattr(got[k], "detach")
                                              else got[k]), np.asarray(want[k]), rtol=rtol,
                                   atol=atol, err_msg=k)


def _jax_dp_run(p0, x, y, opt, steps, blocking, comm=None):
    """The JAX package's DataParallel: params after ``steps`` steps and the
    losses."""
    comm = comm or MeshCommunication(devices=jax.devices()[:1])
    dp = JDataParallel(jax_apply, comm=comm, optimizer=opt, blocking_parameter_updates=blocking)
    step = dp.make_train_step(jax_mse)
    p = jax.device_put(_jparams(p0), comm.replicated())
    s = opt.init(p)
    xb, yb = dp.shard_batch(jnp.asarray(x), jnp.asarray(y))
    pending, losses = dp.init_pending(p), []
    for _ in range(steps):
        if blocking:
            p, s, loss = step(p, s, xb, yb)
        else:
            p, s, pending, loss = step(p, s, pending, xb, yb)
        losses.append(float(loss))
    return p, losses


def _port_dp_run(p0, x, y, make_opt, steps, blocking):
    net = model(p0)
    opt = make_opt(net.parameters())
    dp = DataParallel(net, optimizer=opt, blocking_parameter_updates=blocking)
    step = dp.make_train_step(mse)
    xb, yb = dp.shard_batch(x, y)
    pending, losses = dp.init_pending(net), []
    for _ in range(steps):
        if blocking:
            net, opt, loss = step(net, opt, xb, yb)
        else:
            net, opt, pending, loss = step(net, opt, pending, xb, yb)
        losses.append(float(loss))
    return net, losses


# -------------------------------------------------------- DataParallel ------

OPTIMIZERS = {
    "sgd": (lambda: optax.sgd(0.1), lambda ps: torch.optim.SGD(ps, lr=0.1)),
    "adam": (lambda: optax.adam(1e-2), lambda ps: torch.optim.Adam(ps, lr=1e-2)),
    "adamw": (lambda: optax.adamw(1e-2, weight_decay=1e-1),
              lambda ps: torch.optim.AdamW(ps, lr=1e-2, weight_decay=1e-1)),
}


@pytest.mark.parametrize("blocking", [True, False])
@pytest.mark.parametrize("opt", list(OPTIMIZERS))
def test_training_matches_the_reference(blocking, opt):
    x, y = make_data(16)
    p0 = mlp_init(8, seed=1)
    jopt, topt = OPTIMIZERS[opt]
    want, want_losses = _jax_dp_run(p0, x, y, jopt(), 6, blocking)
    got, losses = _port_dp_run(p0, x, y, topt, 6, blocking)
    _hold(got, want)
    np.testing.assert_allclose(losses, want_losses, rtol=RTOL, atol=ATOL)


def test_matches_single_device_training():
    x, y = make_data(16)
    p0 = mlp_init(8)
    opt = optax.sgd(0.1)
    p_ref, s_ref = _jparams(p0), opt.init(_jparams(p0))
    for _ in range(5):
        g = jax.grad(jax_mse)(p_ref, jnp.asarray(x), jnp.asarray(y))
        u, s_ref = opt.update(g, s_ref, p_ref)
        p_ref = optax.apply_updates(p_ref, u)
    got, _ = _port_dp_run(p0, x, y, OPTIMIZERS["sgd"][1], 5, True)
    _hold(got, p_ref)


def test_forward_matches_the_reference():
    x, _ = make_data(16)
    p0 = mlp_init(8)
    dp = DataParallel(model(p0))
    want = JDataParallel(jax_apply, comm=MeshCommunication(devices=jax.devices()[:1]))(
        _jparams(p0), jnp.asarray(x))
    np.testing.assert_allclose(dp(x).detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("bad", [42, lambda params, x: x])
def test_rejects_bad_module(bad):
    with pytest.raises(TypeError):
        DataParallel(bad)
    if not callable(bad):
        with pytest.raises(TypeError):
            JDataParallel(bad)


def test_first_step_applies_zeros():
    x, y = make_data(16)
    p0 = mlp_init(8)
    net = model(p0)
    opt = torch.optim.SGD(net.parameters(), lr=0.1)
    dp = DataParallel(net, optimizer=opt)
    assert dp.blocking_parameter_updates is False  # the reference's default
    step = dp.make_train_step(mse)
    before = {k: v.detach().clone() for k, v in net.named_parameters()}
    net, opt, pending, loss = step(net, opt, dp.init_pending(net), *dp.shard_batch(x, y))
    for k, v in net.named_parameters():
        assert torch.equal(v.detach(), before[k]), k
    g_ref = jax.grad(jax_mse)(_jparams(p0), jnp.asarray(x), jnp.asarray(y))
    _hold(pending, g_ref)


def test_first_zero_step_advances_adamw_as_optax():
    """Zero tensors, not None: optax applies AdamW's decay and counts the
    step; a torch optimizer would skip a parameter whose .grad is None."""
    x, y = make_data(16)
    p0 = mlp_init(8, seed=4)
    for steps in (1, 3):
        want, _ = _jax_dp_run(p0, x, y, optax.adamw(1e-2, weight_decay=0.5), steps, False)
        got, _ = _port_dp_run(p0, x, y, lambda ps: torch.optim.AdamW(ps, lr=1e-2,
                                                                    weight_decay=0.5),
                              steps, False)
        _hold(got, want)
    assert not np.allclose(np.asarray(want["w1"]), p0["w1"])


def test_second_step_matches_blocking_first_update():
    x, y = make_data(16, seed=5)
    p0 = mlp_init(8, seed=5)
    blocking, _ = _port_dp_run(p0, x, y, OPTIMIZERS["sgd"][1], 1, True)
    double, _ = _port_dp_run(p0, x, y, OPTIMIZERS["sgd"][1], 2, False)
    _hold(double, {k: v.detach() for k, v in blocking.named_parameters()})


@pytest.mark.parametrize("blocking,steps,factor", [(True, 30, 1.0), (False, 60, 0.5)])
def test_loss_decreases(blocking, steps, factor):
    x, y = make_data(32, seed=3)
    make = (lambda ps: torch.optim.Adam(ps, lr=1e-2)) if blocking else (
        lambda ps: torch.optim.SGD(ps, lr=5e-2))
    _, losses = _port_dp_run(mlp_init(8, seed=2), x, y, make, steps, blocking)
    assert losses[-1] < losses[0] * factor, (losses[0], losses[-1])


def test_double_buffered_step_refuses_the_blocking_arity():
    x, y = make_data(16)
    net = model(mlp_init(8))
    opt = torch.optim.SGD(net.parameters(), lr=0.1)
    step = DataParallel(net, optimizer=opt).make_train_step(mse)
    with pytest.raises(TypeError, match="init_pending"):
        step(net, opt, *DataParallel(net).shard_batch(x, y))


def test_train_step_refusals():
    net = model(mlp_init(8))
    with pytest.raises(ValueError, match="no optimizer bound"):
        DataParallel(net).make_train_step(mse)
    opt = torch.optim.SGD(net.parameters(), lr=0.1)
    for wire in ("off", "bf16", "int8", "blockwise"):  # every wire builds a step now
        assert callable(DataParallel(net, optimizer=opt).make_train_step(mse, precision=wire))
    with pytest.raises(ValueError, match="precision must be one of"):
        DataParallel(net, optimizer=opt).make_train_step(mse, precision="fp8")
    with pytest.raises(ValueError, match="precision must be one of"):
        JDataParallel(jax_apply, optimizer=optax.sgd(0.1)).make_train_step(jax_mse,
                                                                             precision="fp8")


def test_shard_batch_refuses_a_column_split_batch():
    x = htt.array(np.zeros((4, 8), np.float32), split=1)
    with pytest.raises(ValueError, match="split along 0"):
        DataParallel(model(mlp_init(8))).shard_batch(x)


def test_dp_optimizer_wrapper_trains_like_its_optimizer():
    x, y = make_data(16)
    p0 = mlp_init(8)
    net = model(p0)
    dpo = DataParallelOptimizer(torch.optim.SGD(net.parameters(), lr=0.1), blocking=True)
    dp = DataParallel(net, optimizer=dpo, blocking_parameter_updates=True)
    step = dp.make_train_step(mse)
    state = dpo.init(net)
    for _ in range(5):
        net, state, _ = step(net, state, *dp.shard_batch(x, y))
    want, _ = _jax_dp_run(p0, x, y, optax.sgd(0.1), 5, True)
    _hold(net, want)


# ------------------------------------------------- DataParallelOptimizer ----

def test_dp_optimizer_step_applies_update():
    net = interop.load_params(torch.nn.ParameterDict({"w": torch.nn.Parameter(
        torch.zeros(3))}), {"w": np.ones(3, np.float32)})
    opt = DataParallelOptimizer(torch.optim.SGD(net.parameters(), lr=0.5))
    state = opt.init(net)
    new, state = opt.step(net, state, {"w": torch.ones(3)})
    np.testing.assert_allclose(new["w"].detach().numpy(), 0.5)
    new["w"].grad = torch.ones(3)
    opt.step()  # the reference's form: the parameters' own gradients
    np.testing.assert_allclose(new["w"].detach().numpy(), 0.0)
    opt.zero_grad()
    assert new["w"].grad is None


@pytest.mark.parametrize("bad", [object(), optax.sgd(0.1)])
def test_dp_optimizer_rejects_a_non_torch_optimizer(bad):
    with pytest.raises(TypeError, match="torch.optim.Optimizer"):
        DataParallelOptimizer(bad)


# ------------------------------------------------------------------ DASO ----

def _daso_one_step(make_opt, p0, x, y, **kw):
    net = model(p0)
    daso = DASO(make_opt(net.parameters()), total_epochs=4, **kw)
    daso.set_loss(mse)
    daso.last_batch = 0
    sp = daso.stack_params(net)
    so = daso.init(sp)
    sp, so, _ = daso.step(sp, so, (x, y))
    return daso.unstack_params(sp)


def test_daso_warmup_matches_blocking_dp():
    x, y = make_data(16)
    p0 = mlp_init(8)
    got = _daso_one_step(lambda ps: torch.optim.SGD(ps, lr=0.1), p0, x, y)
    opt = optax.sgd(0.1)
    g = jax.grad(jax_mse)(_jparams(p0), jnp.asarray(x), jnp.asarray(y))
    u, _ = opt.update(g, opt.init(_jparams(p0)), _jparams(p0))
    _hold(got, optax.apply_updates(_jparams(p0), u), rtol=1e-4, atol=1e-5)


def test_interop_carries_one_replica_of_daso_stacked_params():
    """One replica of the JAX package's stacked DASO parameters (a leading
    replica axis over its four devices) loads into this rank's module."""
    jd = JDASO(optax.sgd(0.1), total_epochs=2, comm=MeshCommunication(devices=jax.devices()[:4]))
    p0 = mlp_init(8, seed=6)
    stacked = {k: np.asarray(v) for k, v in jd.stack_params(_jparams(p0)).items()}
    assert stacked["w1"].shape == (4, 8, 16)
    for replica in (0, 3):
        net = interop.load_params(MLP(8), stacked, replica=replica)
        _hold(net, p0, rtol=0, atol=0)
    daso = DASO(torch.optim.SGD(MLP(8).parameters(), lr=0.1), total_epochs=2)
    daso.set_model(MLP(8))
    _hold(daso.stack_params(p0), p0, rtol=0, atol=0)


def test_daso_world_of_one_is_one_node():
    daso = DASO(torch.optim.SGD(MLP(8).parameters(), lr=0.1), total_epochs=2)
    assert (daso.n_nodes, daso.n_local) == (1, 1)


def _daso_epochs(daso, net, x, y, epochs, batches, bs):
    daso.set_loss(mse)
    daso.last_batch = batches - 1
    sp = daso.stack_params(net)
    so = daso.init(sp)
    losses, states = [], []
    for _ in range(epochs):
        ep = 0.0
        for b in range(batches):
            lo = (b * bs) % x.shape[0]
            sp, so, loss = daso.step(sp, so, (x[lo:lo + bs], y[lo:lo + bs]))
            ep += float(loss)
        daso.epoch_loss_logic(ep / batches)
        losses.append(ep / batches)
        states.append((daso.epoch, daso.global_skip, daso.local_skip, daso.batches_to_wait))
    return daso.unstack_params(sp), losses, states


def _jax_daso_epochs(daso, params, x, y, epochs, batches, bs):
    daso.set_loss(jax_mse)
    daso.last_batch = batches - 1
    sp = daso.stack_params(_jparams(params))
    so = daso.init(sp)
    losses, states = [], []
    for _ in range(epochs):
        ep = 0.0
        for b in range(batches):
            lo = (b * bs) % x.shape[0]
            sp, so, loss = daso.step(sp, so, (jnp.asarray(x[lo:lo + bs]),
                                              jnp.asarray(y[lo:lo + bs])))
            ep += float(loss)
        daso.epoch_loss_logic(ep / batches)
        losses.append(ep / batches)
        states.append((daso.epoch, daso.global_skip, daso.local_skip, daso.batches_to_wait))
    return daso.unstack_params(sp), losses, states


def test_daso_full_schedule_trains_as_the_reference_on_one_device():
    x, y = make_data(16)
    p0 = mlp_init(8, seed=2)
    net = model(p0)
    daso = DASO(torch.optim.Adam(net.parameters(), lr=5e-3), **_ns["DASO_RUN"])
    got, losses, states = _daso_epochs(daso, net, x, y, 8, 4, 4)
    jd = JDASO(optax.adam(5e-3), comm=MeshCommunication(devices=jax.devices()[:1]),
               **_ns["DASO_RUN"])
    want, want_losses, want_states = _jax_daso_epochs(jd, p0, x, y, 8, 4, 4)
    assert states == want_states
    assert losses[-1] < losses[0]
    np.testing.assert_allclose(losses, want_losses, rtol=1e-3)
    for k in want:
        scale = float(np.abs(np.asarray(want[k])).max()) or 1.0
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0,
                                   atol=BF16_MERGE_TOL * scale, err_msg=k)


def test_daso_gs1_drains_payload_queue():
    x, y = make_data(16)
    net = model(mlp_init(8))
    daso = DASO(torch.optim.SGD(net.parameters(), lr=0.05), total_epochs=10)
    daso.set_loss(mse)
    daso.last_batch = 7
    daso.global_skip, daso.local_skip, daso.batches_to_wait = 1, 1, 1
    so = daso.init(net)
    for b in range(8):
        lo = (b * 2) % x.shape[0]
        net, so, _ = daso.step(net, so, (x[lo:lo + 2], y[lo:lo + 2]))
        assert len(daso._prev_params) <= 1
    assert len(daso._prev_params) <= 1


def test_daso_zero_scheduler_freezes_training():
    x, y = make_data(4)
    p0 = mlp_init(8)
    got = _daso_one_step(lambda ps: torch.optim.SGD(ps, lr=1.0), p0, x, y,
                         scheduler=lambda step: 0.0)
    _hold(got, p0, rtol=0, atol=1e-6)


def test_daso_absolute_lr_scheduler_not_double_applied():
    x, y = make_data(4)
    p0 = mlp_init(8)
    sgd = lambda ps: torch.optim.SGD(ps, lr=0.5)  # noqa: E731
    got = _daso_one_step(sgd, p0, x, y, scheduler=lr_scheduler.ConstantLR(0.5, factor=1.0,
                                                                         total_iters=1),
                         scheduler_base_lr=0.5)
    _hold(got, _daso_one_step(sgd, p0, x, y))


def test_daso_warmup_ramp_scheduler_exact():
    x, y = make_data(4)
    p0 = mlp_init(8)
    sgd = lambda ps: torch.optim.SGD(ps, lr=0.5)  # noqa: E731
    ramp = lr_scheduler.LinearLR(0.5, start_factor=1.0 / 4, total_iters=10)
    got = _daso_one_step(sgd, p0, x, y, scheduler=ramp, scheduler_base_lr=0.5)
    _hold(got, _daso_one_step(sgd, p0, x, y, scheduler=lambda step: 0.25))


@pytest.mark.parametrize("package", ["port", "jax"])
def test_daso_gs8_hold_gates_plateau_decay(package):
    if package == "port":
        daso = DASO(torch.optim.SGD(MLP(8).parameters(), lr=0.1), total_epochs=40,
                    warmup_epochs=0, cooldown_epochs=0, max_global_skips=8)
    else:
        daso = JDASO(optax.sgd(0.1), total_epochs=40,
                     comm=MeshCommunication(devices=jax.devices()[:1]), warmup_epochs=0,
                     cooldown_epochs=0, max_global_skips=8)
    daso.epoch = 1
    daso.global_skip, daso.local_skip, daso.batches_to_wait = 8, 2, 2
    daso.stability.best = 1.0
    daso.stability.num_bad_epochs = daso.stability.patience
    trace = []
    for _ in range(daso._gs8_waits - 1):
        daso.epoch_loss_logic(1.0)
        trace.append(daso.global_skip)
        daso.epoch += 1
    daso.epoch_loss_logic(1.0)
    trace.append(daso.global_skip)
    assert trace == [8] * (daso._gs8_waits - 1) + [4]


def test_daso_refusals():
    params = MLP(8).parameters
    with pytest.raises(TypeError):
        DASO(torch.optim.SGD(params(), lr=0.1), total_epochs=2, scheduler=3)
    with pytest.raises(ValueError):
        DASO(torch.optim.SGD(params(), lr=0.1), total_epochs=2, n_nodes=3)
    with pytest.raises(ValueError, match="scheduler_base_lr"):
        DASO(torch.optim.SGD(params(), lr=0.1), total_epochs=2, scheduler_base_lr=0.1)
    with pytest.raises(TypeError, match="torch.optim.Optimizer"):
        DASO(optax.sgd(0.1), total_epochs=2)
    daso = DASO(torch.optim.SGD(params(), lr=0.1), total_epochs=2)
    daso.set_loss(mse)
    with pytest.raises(ValueError, match="last_batch"):
        daso.step(MLP(8), None, (np.zeros((8, 8)), np.zeros((8, 1))))


@pytest.mark.parametrize("kw,item", [({"checkpoint_every": 2, "checkpoint_path": "ck"}, "13"),
                                     ({"collective_precision": "int8"}, "12"),
                                     ({"collective_precision": "bf16"}, "12")])
def test_daso_features_of_later_items_raise(kw, item):
    """The features these raised for until the scale-out slice are taken
    now (items 12 and 13 closed); what raises is what the JAX package
    refuses: a window without a path or of no length, an unknown wire."""
    daso = DASO(torch.optim.SGD(MLP(8).parameters(), lr=0.1), total_epochs=2, **kw)
    if "checkpoint_every" in kw:
        assert (daso.checkpoint_every, daso.checkpoint_path) == (2, "ck")
        for bad, msg in (({"checkpoint_every": 2}, "requires checkpoint_path"),
                         ({"checkpoint_every": 0, "checkpoint_path": "ck"}, "positive")):
            for package, opt in ((DASO, torch.optim.SGD(MLP(8).parameters(), lr=0.1)),
                                 (JDASO, optax.sgd(0.1))):
                with pytest.raises(ValueError, match=msg):
                    package(opt, total_epochs=2, **bad)
    else:
        assert daso._collective_precision == kw["collective_precision"]
        with pytest.raises(ValueError, match="precision must be one of"):
            DASO(torch.optim.SGD(MLP(8).parameters(), lr=0.1), total_epochs=2,
                 collective_precision="fp8")


@pytest.mark.parametrize("method", ["save_checkpoint", "load_checkpoint"])
def test_daso_checkpoints_raise(method, tmp_path):
    """A save writes a ``daso`` checkpoint; a load refuses another
    algorithm's (the JAX package's refusal, dp_optimizer.py:487)."""
    net = model(mlp_init(8))
    daso = DASO(torch.optim.SGD(net.parameters(), lr=0.1), total_epochs=2)
    path = str(tmp_path / "ck")
    if method == "save_checkpoint":
        daso.save_checkpoint(path, net, daso.init(net))
        assert htt.resilience.checkpoint.load_manifest(path)["extra"]["algo"] == "daso"
    else:
        htt.resilience.save_checkpoint({"w": np.zeros(3)}, path, extra={"algo": "zero"})
        with pytest.raises(htt.resilience.CheckpointError, match="not daso"):
            daso.load_checkpoint(path, net, daso.init(net))


def _daso_run_with_kill(tmp_path, make_opt, kill_epoch, epochs, batches, bs, x, y, **kw):
    """DASO through ``epochs`` epochs, checkpointing every epoch; a second
    run killed after ``kill_epoch`` epochs and a third resumed from its
    checkpoint. Returns both final models."""
    def fresh():
        net = model(mlp_init(8, seed=2))
        daso = DASO(make_opt(net.parameters()), **kw)
        daso.set_loss(mse)
        daso.last_batch = batches - 1
        return net, daso

    def epochs_of(net, daso, so, first, last):
        for _ in range(first, last):
            ep = 0.0
            for b in range(batches):
                lo = (b * bs) % x.shape[0]
                net, so, loss = daso.step(net, so, (x[lo:lo + bs], y[lo:lo + bs]))
                ep += float(loss)
            daso.epoch_loss_logic(ep / batches)
        return net

    net, daso = fresh()
    whole = epochs_of(net, daso, daso.init(net), 0, epochs)
    path = str(tmp_path / "daso_ck")
    net, daso = fresh()
    daso.checkpoint_every, daso.checkpoint_path = batches, path
    epochs_of(net, daso, daso.init(net), 0, kill_epoch)
    net, daso = fresh()
    so = daso.init(net)
    net, so = daso.load_checkpoint(path, net, so)
    assert daso.epoch == kill_epoch and daso._steps_done == kill_epoch * batches
    return whole, epochs_of(net, daso, so, kill_epoch, epochs)


def test_daso_killed_and_resumed_equals_the_uninterrupted_run(tmp_path):
    """Checkpointed at an epoch's end (no payload in flight) and resumed,
    DASO continues bit for bit: replica, Adam state and schedule (skips,
    waits, the plateau detector)."""
    x, y = make_data(16)
    whole, resumed = _daso_run_with_kill(tmp_path, lambda ps: torch.optim.Adam(ps, lr=5e-3), 5,
                                         8, 4, 4, x, y, **_ns["DASO_RUN"])
    for (k, a), (_, b) in zip(whole.named_parameters(), resumed.named_parameters()):
        assert torch.equal(a, b), k


def test_daso_schedule_hooks():
    daso = DASO(torch.optim.SGD(MLP(8).parameters(), lr=0.1), total_epochs=2, verbose=True)
    daso.global_skip, daso.local_skip, daso.batches_to_wait = 4, 1, 1
    daso._prev_params.append(None)
    daso.reset()
    assert (daso.global_skip, daso.local_skip, daso.batches_to_wait, daso._prev_params) == (
        0, 0, 0, [])
    daso.add_scaler("scaler")
    assert daso.amp and daso.scaler == "scaler"
    daso.zero_grad()


def test_data_parallel_multi_gpu_binds_model():
    net = model(mlp_init(8))
    daso = DASO(torch.optim.SGD(net.parameters(), lr=0.1), total_epochs=2)
    wrapped = DataParallelMultiGPU(net, daso)
    assert daso.module is net
    x, _ = make_data(6)
    assert wrapped(torch.from_numpy(x)).shape == (6, 1)


# ------------------------------------------------- DetectMetricPlateau ------

PLATEAU_CASES = [
    (dict(patience=2, threshold=0.0, threshold_mode="abs"), [1.0, 1.0, 1.0, 1.0]),
    (dict(patience=1, threshold=0.0, threshold_mode="abs"), [1.0, 0.5, 0.9, 0.25]),
    (dict(mode="max", patience=1, threshold=0.0, threshold_mode="abs"), [0.1, 0.05, 0.05]),
    (dict(mode="min", patience=2, threshold=1e-4), [1.0, 0.5, 0.6, 0.6, 0.6]),
    (dict(mode="max", patience=1, threshold=1e-4), [0.1, 0.5, 0.4, 0.4]),
    (dict(mode="min", threshold_mode="rel", threshold=0.1, patience=0), [100.0, 95.0]),
    (dict(mode="min", threshold_mode="rel", threshold=0.1, patience=0), [100.0, 80.0]),
    (dict(mode="min", threshold_mode="abs", threshold=0.5, patience=0), [10.0, 9.0, 8.8]),
    (dict(mode="min", patience=0, cooldown=2), [1.0, 2.0, 3.0, 3.0, 3.0]),
    (dict(mode="min", patience=1, threshold=1e-4), [1.0, 0.9, 0.95, 0.95, 0.8, 0.85, 0.85]),
    (dict(mode="min", patience=2, threshold=0.05), [3.0, -1.0, -0.99, -0.98, -0.97, -2.0]),
]


@pytest.mark.parametrize("kw,seq", PLATEAU_CASES)
def test_plateau_detector_matches_the_reference(kw, seq):
    got, want = DetectMetricPlateau(**kw), JPlateau(**kw)
    assert [got.test_if_improving(v) for v in seq] == [want.test_if_improving(v) for v in seq]
    assert got.get_state() == want.get_state()
    assert got.in_cooldown == want.in_cooldown


def test_plateau_state_roundtrip_and_reset():
    a = DetectMetricPlateau(mode="min", patience=1, threshold=1e-4)
    seq = [1.0, 0.9, 0.95, 0.95, 0.8, 0.85, 0.85]
    for v in seq[:4]:
        a.test_if_improving(v)
    b = DetectMetricPlateau(mode="min", patience=1, threshold=1e-4)
    b.set_state(a.get_state())
    for v in seq[4:]:
        assert a.test_if_improving(v) == b.test_if_improving(v)
    d = DetectMetricPlateau(mode="min", patience=0)
    d.test_if_improving(1.0)
    assert d.test_if_improving(2.0)
    d.reset()
    assert not d.test_if_improving(5.0)
    e = DetectMetricPlateau(mode="min", threshold_mode="abs", threshold=0.0)
    assert e.is_better(0.9, 1.0) and not e.is_better(1.0, 0.9)


@pytest.mark.parametrize("kw", [dict(mode="sideways"), dict(threshold_mode="percent")])
def test_plateau_rejects_bad_modes(kw):
    with pytest.raises(ValueError):
        DetectMetricPlateau(**kw)
    with pytest.raises(ValueError):
        JPlateau(**kw)


# ------------------------------------------------------ lr schedules --------

SCHEDULES = [
    ("StepLR", (1.0,), dict(step_size=10, gamma=0.1)),
    ("StepLR", (0.5,), dict(step_size=3)),
    ("MultiStepLR", (1.0,), dict(milestones=[2, 5, 120], gamma=0.1)),
    ("MultiStepLR", (2.0,), dict(milestones=[1], gamma=0.5)),
    ("ExponentialLR", (1.0,), dict(gamma=0.9)),
    ("ExponentialLR", (0.3,), dict(gamma=0.0)),
    ("CosineAnnealingLR", (2.0,), dict(T_max=10)),
    ("CosineAnnealingLR", (1e-3,), dict(T_max=200)),
    ("CosineAnnealingLR", (1.0,), dict(T_max=4, eta_min=0.2)),
    ("ConstantLR", (1.0,), dict(factor=0.25, total_iters=3)),
    ("ConstantLR", (0.5,), dict()),
    ("LinearLR", (1.0,), dict(start_factor=0.0, end_factor=1.0, total_iters=4)),
    ("LinearLR", (3.0,), dict()),
    ("LinearLR", (0.1,), dict(start_factor=1.0, end_factor=0.1, total_iters=150)),
    ("PolynomialLR", (1.0,), dict(total_iters=4, power=1.0)),
    ("PolynomialLR", (1.0,), dict(total_iters=100, power=2.0)),
]


@pytest.mark.parametrize("name,args,kw", SCHEDULES)
def test_lr_schedule_matches_optax(name, args, kw):
    got = getattr(lr_scheduler, name)(*args, **kw)
    want = getattr(jlr, name)(*args, **kw)
    steps = range(201)
    g = np.array([got(i) for i in steps])
    w = np.array([float(want(i)) for i in steps])
    assert all(isinstance(got(i), float) for i in (0, 7))
    np.testing.assert_allclose(g, w, rtol=0, atol=1e-6 * args[0])


def test_lr_schedule_drives_a_torch_optimizer():
    sched = lr_scheduler.StepLR(0.1, step_size=2, gamma=0.5)
    w = torch.nn.Parameter(torch.ones(()))
    opt = torch.optim.SGD([w], lr=0.1)
    lam = torch.optim.lr_scheduler.LambdaLR(opt, lambda k: sched(k) / 0.1)
    applied = []
    for _ in range(4):
        before = w.item()
        w.grad = torch.ones(())
        opt.step()
        lam.step()
        applied.append(before - w.item())
    np.testing.assert_allclose(applied, [0.1, 0.1, 0.05, 0.05], rtol=1e-6)


def test_cosine_refuses_nonpositive_steps():
    with pytest.raises(ValueError, match="positive decay_steps"):
        lr_scheduler.CosineAnnealingLR(1.0, T_max=0)


# ------------------------------------------------------- pass-throughs ------

def test_optim_passthrough():
    assert htt.optim.AdamW is torch.optim.AdamW
    assert hasattr(htt.optim.SGD([torch.nn.Parameter(torch.ones(1))], lr=0.1), "step")
    with pytest.raises(AttributeError, match="not implemented in torch.optim"):
        htt.optim.no_such_optimizer


def test_nn_passthrough():
    assert htt.nn.Linear is torch.nn.Linear
    with pytest.raises(AttributeError, match="not implemented in torch.nn"):
        htt.nn.NoSuchLayer


def test_functional_passthrough():
    assert htt.nn.functional.relu is torch.nn.functional.relu
    with pytest.raises(AttributeError):
        htt.nn.functional.no_such_function


# ----------------------------------------------- the world of four ---------

_WORKER = _MODEL + textwrap.dedent("""
    import sys
    import torch.distributed as dist
    rank, world, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    import heat_tpu_torch as ht
    from heat_tpu_torch import interop
    from heat_tpu_torch.nn import DataParallel, DataParallelMultiGPU
    from heat_tpu_torch.optim import DASO
    ht.use_device("cpu")
    res = {}
    x, y = make_data(16)
    for blocking, name in ((True, "sgd"), (False, "adam")):
        net = interop.load_params(MLP(8), mlp_init(8, seed=1))
        opt = (torch.optim.SGD(net.parameters(), lr=0.1) if name == "sgd"
               else torch.optim.Adam(net.parameters(), lr=1e-2))
        dp = DataParallel(net, optimizer=opt, blocking_parameter_updates=blocking)
        step = dp.make_train_step(mse)
        xb, yb = dp.shard_batch(x, y)
        res[f"dp_{blocking}_rows"] = np.array(xb.shape[0])
        pending, losses = dp.init_pending(net), []
        for _ in range(5):
            if blocking:
                net, opt, loss = step(net, opt, xb, yb)
            else:
                net, opt, pending, loss = step(net, opt, pending, xb, yb)
            losses.append(float(loss))
        res[f"dp_{blocking}_losses"] = np.array(losses)
        for k, v in net.named_parameters():
            res[f"dp_{blocking}_{k}"] = v.detach().numpy()
        res[f"dp_{blocking}_forward"] = dp(x).detach().numpy()
    net0 = interop.load_params(MLP(8), mlp_init(8, seed=10 + rank))
    DataParallel(net0).init()
    for k, v in net0.named_parameters():
        res[f"init_{k}"] = v.detach().numpy().copy()
    try:
        DataParallel(MLP(8)).shard_batch(ht.array(np.zeros((5, 8), np.float32), split=0))
    except ValueError as e:
        res["padded_refusal"] = np.array(str(e))

    xd, yd = make_data(DASO_BATCHES * DASO_BS, seed=9)
    net = interop.load_params(MLP(8), mlp_init(8, seed=2))
    daso = DASO(torch.optim.Adam(net.parameters(), lr=5e-3), **DASO_RUN)
    res["daso_layout"] = np.array([daso.n_nodes, daso.n_local, daso.node_comm.size,
                                   daso.local_comm.size, daso.node_comm.rank,
                                   daso.local_comm.rank])
    multi = DataParallelMultiGPU(net, daso)
    daso.set_loss(mse)
    daso.last_batch = DASO_BATCHES - 1
    sp = daso.stack_params(net)
    so = daso.init(sp)
    states, losses = [], []
    for epoch in range(DASO_RUN["total_epochs"]):
        ep = 0.0
        for b in range(DASO_BATCHES):
            lo = b * DASO_BS
            sp, so, loss = daso.step(sp, so, (xd[lo:lo + DASO_BS], yd[lo:lo + DASO_BS]))
            ep += float(loss)
        daso.epoch_loss_logic(ep / DASO_BATCHES)
        losses.append(ep / DASO_BATCHES)
        states.append([daso.epoch, daso.global_skip, daso.local_skip, daso.batches_to_wait])
        for k, v in sp.named_parameters():
            res[f"daso_e{epoch}_replica_{k}"] = v.detach().numpy().copy()
    res["daso_states"] = np.array(states)
    res["daso_losses"] = np.array(losses)
    for k, v in daso.unstack_params(sp).items():
        res[f"daso_final_{k}"] = v.numpy()
    res["multi_forward"] = multi(torch.from_numpy(xd[:4])).detach().numpy()

    # the compressed gradient wires (blocking SGD, three steps)
    for wire in ("bf16", "int8", "blockwise"):
        net = interop.load_params(MLP(8), mlp_init(8, seed=1))
        opt = torch.optim.SGD(net.parameters(), lr=0.1)
        dp = DataParallel(net, optimizer=opt, blocking_parameter_updates=True)
        step = dp.make_train_step(mse, precision=wire)
        xb, yb = dp.shard_batch(x, y)
        losses = []
        for _ in range(3):
            net, opt, loss = step(net, opt, xb, yb)
            losses.append(float(loss))
        res[f"cdp_{wire}_losses"] = np.array(losses)
        for k, v in net.named_parameters():
            res[f"cdp_{wire}_{k}"] = v.detach().numpy().copy()

    def daso_epochs(daso, net, so, first, last):
        for epoch in range(first, last):
            ep = 0.0
            for b in range(DASO_BATCHES):
                lo = b * DASO_BS
                net, so, loss = daso.step(net, so, (xd[lo:lo + DASO_BS], yd[lo:lo + DASO_BS]))
                ep += float(loss)
            daso.epoch_loss_logic(ep / DASO_BATCHES)
        return net

    def daso_fresh(**kw):
        net = interop.load_params(MLP(8), mlp_init(8, seed=2))
        daso = DASO(torch.optim.Adam(net.parameters(), lr=5e-3), **DASO_RUN, **kw)
        daso.set_loss(mse)
        daso.last_batch = DASO_BATCHES - 1
        return net, daso

    # DASO over the int8 cross-node wire
    net, daso = daso_fresh(collective_precision="int8")
    net = daso_epochs(daso, net, daso.init(net), 0, DASO_RUN["total_epochs"])
    for k, v in daso.unstack_params(net).items():
        res[f"cdaso_final_{k}"] = v.numpy()
    # killed after epoch 5's checkpoint and resumed by a fresh DASO
    net, daso = daso_fresh(checkpoint_every=DASO_BATCHES, checkpoint_path=f"{out}/daso_ck")
    daso_epochs(daso, net, daso.init(net), 0, 5)
    net, daso = daso_fresh()
    so = daso.init(net)
    net, so = daso.load_checkpoint(f"{out}/daso_ck", net, so)
    net = daso_epochs(daso, net, so, 5, DASO_RUN["total_epochs"])
    for k, v in net.named_parameters():
        res[f"resumed_replica_{k}"] = v.detach().numpy().copy()
    np.savez(f"{out}/rank{rank}.npz", **res)
    dist.destroy_process_group()
""")


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """One spawned world of four gloo ranks (2 nodes x 2); each rank's
    saved results."""
    out = tmp_path_factory.mktemp("dp_gloo")
    world = 4
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(r), str(world), str(port),
                               str(out)], cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=120)[0])
        finally:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(world)]


def _four():
    return MeshCommunication(devices=jax.devices()[:4])


@pytest.mark.parametrize("blocking", [True, False])
def test_four_ranks_data_parallel_matches_the_reference(four_ranks, blocking):
    x, y = make_data(16)
    opt = optax.sgd(0.1) if blocking else optax.adam(1e-2)
    want, want_losses = _jax_dp_run(mlp_init(8, seed=1), x, y, opt, 5, blocking, _four())
    fwd = JDataParallel(jax_apply, comm=_four())(want, jnp.asarray(x))
    for rank, r in enumerate(four_ranks):
        assert int(r[f"dp_{blocking}_rows"]) == 4
        _hold({k: r[f"dp_{blocking}_{k}"] for k in want}, want)
        np.testing.assert_allclose(r[f"dp_{blocking}_losses"], want_losses, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(r[f"dp_{blocking}_forward"],
                                   np.asarray(fwd)[rank * 4:(rank + 1) * 4], rtol=RTOL,
                                   atol=ATOL)


def test_four_ranks_init_replicates_rank_zero(four_ranks):
    want = mlp_init(8, seed=10)
    for r in four_ranks:
        _hold({k: r[f"init_{k}"] for k in want}, want, rtol=0, atol=0)


def test_four_ranks_refuse_a_padded_batch(four_ranks):
    for r in four_ranks:
        assert "must divide evenly" in str(r["padded_refusal"])
    a = ht_tpu.random.randn(5, 4, split=0, comm=_four())
    with pytest.raises(ValueError, match="divide evenly"):
        JDataParallel(jax_apply, comm=_four()).shard_batch(a)


def test_four_ranks_daso_layout_is_two_by_two(four_ranks):
    jd = JDASO(optax.sgd(0.1), total_epochs=2, comm=_four())
    assert (jd.n_nodes, jd.n_local) == (2, 2)
    for rank, r in enumerate(four_ranks):
        np.testing.assert_array_equal(r["daso_layout"], [2, 2, 2, 2, rank // 2, rank % 2])


def test_four_ranks_daso_schedule_matches_the_reference(four_ranks):
    run = _ns["DASO_RUN"]
    batches, bs = _ns["DASO_BATCHES"], _ns["DASO_BS"]
    xd, yd = make_data(batches * bs, seed=9)
    jd = JDASO(optax.adam(5e-3), comm=_four(), **run)
    want, want_losses, want_states = _jax_daso_epochs(jd, mlp_init(8, seed=2), xd, yd,
                                                      run["total_epochs"], batches, bs)
    phases = {s[1] for s in want_states}
    assert 0 in phases and 4 in phases  # blocking and cycling epochs both ran
    for r in four_ranks:
        assert [tuple(s) for s in r["daso_states"].tolist()] == want_states
        np.testing.assert_allclose(r["daso_losses"], want_losses, rtol=1e-3)
        for k in want:
            scale = float(np.abs(np.asarray(want[k])).max()) or 1.0
            np.testing.assert_allclose(r[f"daso_final_{k}"], np.asarray(want[k]), rtol=0,
                                       atol=BF16_MERGE_TOL * scale, err_msg=k)


def test_four_ranks_daso_replicas_agree_after_full_sync(four_ranks):
    """Warmup syncs every gradient over the world: all four replicas are
    equal after each warmup epoch. Past it the node means are merged across
    nodes with each replica's own weight, so replicas agree within a node
    (its gradients are averaged every batch: local skip 1) at every epoch."""
    run = _ns["DASO_RUN"]
    params = ("w1", "b1", "w2", "b2")
    for e in range(run["total_epochs"]):
        for k in params:
            key = f"daso_e{e}_replica_{k}"
            np.testing.assert_array_equal(four_ranks[1][key], four_ranks[0][key])
            np.testing.assert_array_equal(four_ranks[3][key], four_ranks[2][key])
            if e < run["warmup_epochs"]:
                np.testing.assert_array_equal(four_ranks[2][key], four_ranks[0][key])


@pytest.mark.parametrize("wire", ["bf16", "int8", "blockwise"])
def test_four_ranks_compressed_gradient_wire_matches_the_reference(four_ranks, wire):
    """DataParallel's gradient averaged over a compressed wire on four
    ranks against the JAX package's exact DataParallel step on four devices
    (the replicated twin: its own compressed step is no oracle under this
    jax, whose shard_map sums the gradients of replicated parameters
    itself, so that bf16 steps ``p`` times the mean and int8 does not
    trace). Three SGD steps. Tolerance: each step's gradient within
    ``quant_error_bound`` at ``p + 1`` hops of twice the initial gradient's
    largest magnitude, times the learning rate, over three steps, plus the
    f32 tolerance; the loss within 1e-2."""
    x, y = make_data(16)
    exact, exact_losses = _jax_dp_run(mlp_init(8, seed=1), x, y, optax.sgd(0.1), 3, True,
                                      _four())
    grads = jax.grad(jax_mse)(_jparams(mlp_init(8, seed=1)), jnp.asarray(x), jnp.asarray(y))
    gmax = 2.0 * max(float(np.abs(np.asarray(g)).max()) for g in grads.values())
    bound = 3 * 0.1 * htt.core.collective_prec.quant_error_bound(gmax, wire, 5)
    for r in four_ranks:
        np.testing.assert_allclose(r[f"cdp_{wire}_losses"], exact_losses, rtol=1e-2)
        for k in exact:
            np.testing.assert_allclose(r[f"cdp_{wire}_{k}"], np.asarray(exact[k]), rtol=RTOL,
                                       atol=ATOL + bound, err_msg=k)


def test_four_ranks_daso_int8_wire_matches_the_reference(four_ranks):
    """DASO with ``collective_precision="int8"`` (the two-phase quantized
    cross-node sum) on 2 x 2 ranks against the JAX package's on four
    devices: the same schedule; the parameters within 2^-5 of their
    largest magnitude (int8 steps of 1/254 of the node means' max-abs, at
    p + 1 = 3 hops a merge, over the cycling epochs' merges)."""
    run = _ns["DASO_RUN"]
    batches, bs = _ns["DASO_BATCHES"], _ns["DASO_BS"]
    xd, yd = make_data(batches * bs, seed=9)
    jd = JDASO(optax.adam(5e-3), comm=_four(), collective_precision="int8", **run)
    want, _, _ = _jax_daso_epochs(jd, mlp_init(8, seed=2), xd, yd, run["total_epochs"], batches,
                                  bs)
    for r in four_ranks:
        for k in want:
            scale = float(np.abs(np.asarray(want[k])).max()) or 1.0
            np.testing.assert_allclose(r[f"cdaso_final_{k}"], np.asarray(want[k]), rtol=0,
                                       atol=2.0 ** -5 * scale, err_msg=k)


def test_four_ranks_daso_resumes_bit_for_bit(four_ranks):
    """Four ranks checkpoint DASO (each its replica and Adam state as a row
    of the stacked arrays) after epoch 5, a fresh DASO loads it and runs
    the last epochs: every replica equals the uninterrupted run's."""
    last = _ns["DASO_RUN"]["total_epochs"] - 1
    for r in four_ranks:
        for k in ("w1", "b1", "w2", "b2"):
            np.testing.assert_array_equal(r[f"resumed_replica_{k}"],
                                          r[f"daso_e{last}_replica_{k}"], err_msg=k)


def test_four_ranks_multi_gpu_forward(four_ranks):
    xd, _ = make_data(_ns["DASO_BATCHES"] * _ns["DASO_BS"], seed=9)
    for r in four_ranks:
        final = {k: torch.from_numpy(r[f"daso_final_{k}"]) for k in ("w1", "b1", "w2", "b2")}
        assert r["multi_forward"].shape == (4, 1)
        assert np.isfinite(r["multi_forward"]).all()
        assert final["w1"].shape == (8, 16)
