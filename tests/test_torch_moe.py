"""heat_tpu_torch's MoEMLP against heat_tpu's, on the CPU.

The flax layer's variables are carried into the port by
``interop.moe_mlp_from_flax`` and both layers take the same numpy tokens:
the output and every parameter's gradient against ``jax.grad``, the JAX
tests' numpy oracle (top-1 routing, capacity, silu experts, the gate
weight), the capacity drop (over-capacity tokens give 0), the refusal of
an expert count that does not divide over the ranks, and one spawned
world of two gloo ranks (``comm=``: two experts a rank) against
``comm=None`` in this process and the JAX package's sharded layer on two
devices, forward and gradients (each rank's experts' slice; the gate's on
every rank).

Tolerances: f32, 1e-5 relative and absolute on outputs and gradients
(einsums summed in other orders); the oracle 1e-4 (the JAX test's own).
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
import pytest
import torch

from heat_tpu.core.communication import MeshCommunication
from heat_tpu.nn import MoEMLP as FlaxMoE

import heat_tpu_torch as htt
from heat_tpu_torch import interop

REPO = Path(__file__).resolve().parent.parent
TOL = 1e-5


def _flax(n_experts, d_ff, x, seed, **kw):
    layer = FlaxMoE(n_experts=n_experts, d_ff=d_ff, **kw)
    variables = layer.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    return layer, variables, jax.tree.map(np.asarray, variables)


def _moe_oracle(xt, gate_kernel, w_in, w_out, n_experts, cap):
    """The JAX tests' per-token loop (tests/test_pipeline_moe.py)."""
    logits = xt @ gate_kernel
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    expert = probs.argmax(-1)
    gate = probs[np.arange(len(xt)), expert]
    counts = np.zeros(n_experts, int)
    out = np.zeros_like(xt)
    for i in range(len(xt)):
        e = expert[i]
        if counts[e] < cap:
            counts[e] += 1
            z = xt[i] @ w_in[e]
            out[i] = gate[i] * ((z / (1 + np.exp(-z))) @ w_out[e])
    return out


def test_matches_flax_and_the_oracle():
    b, t, d, e, f = 2, 8, 4, 4, 8
    x = np.random.default_rng(7).standard_normal((b, t, d)).astype(np.float32)
    layer, variables, np_vars = _flax(e, f, x, 7, capacity_factor=1.0)
    port = interop.moe_mlp_from_flax(np_vars, n_experts=e, d_ff=f, capacity_factor=1.0,
                                     device="cpu")
    got = port(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(layer.apply(variables, jnp.asarray(x))),
                               rtol=TOL, atol=TOL)
    p = np_vars["params"]
    ref = _moe_oracle(x.reshape(-1, d).astype(np.float64), p["gate"]["kernel"].astype(np.float64),
                      p["w_in"].astype(np.float64), p["w_out"].astype(np.float64), e,
                      int(np.ceil(b * t / e))).reshape(b, t, d)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_capacity_drops_to_zero():
    x = np.ones((1, 4, 4), np.float32)  # identical tokens, one expert, capacity 1
    _, _, np_vars = _flax(2, 4, x, 9, capacity_factor=0.5)
    port = interop.moe_mlp_from_flax(np_vars, n_experts=2, d_ff=4, capacity_factor=0.5,
                                     device="cpu")
    out = port(torch.from_numpy(x)).detach().numpy()[0]
    assert (np.abs(out).sum(-1) > 1e-9).sum() == 1


def test_gradients_match_jax_grad():
    x = np.random.default_rng(10).standard_normal((2, 8, 4)).astype(np.float32)
    w = np.random.default_rng(11).standard_normal((2, 8, 4)).astype(np.float32)
    layer, variables, np_vars = _flax(4, 8, x, 10)
    grads = jax.grad(lambda v: (layer.apply(v, jnp.asarray(x)) * w).sum())(variables)
    port = interop.moe_mlp_from_flax(np_vars, n_experts=4, d_ff=8, device="cpu")
    (port(torch.from_numpy(x)) * torch.from_numpy(w)).sum().backward()
    g = grads["params"]
    np.testing.assert_allclose(port.gate.grad.numpy(), np.asarray(g["gate"]["kernel"]).T,
                               rtol=TOL, atol=TOL)
    for name in ("w_in", "w_out"):
        np.testing.assert_allclose(getattr(port, name).grad.numpy(), np.asarray(g[name]),
                                   rtol=TOL, atol=TOL)
    assert all(torch.isfinite(p.grad).all() for p in port.parameters())


def test_weights_come_from_the_generator_whole():
    """comm=None and a world's share draw the same experts from one seed."""
    a = htt.nn.MoEMLP(4, 8, d_model=6, device="cpu", generator=torch.Generator().manual_seed(3))
    b = htt.nn.MoEMLP(4, 8, d_model=6, device="cpu", generator=torch.Generator().manual_seed(3))
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(), b.parameters()))
    assert a.w_in.shape == (4, 6, 8) and a.w_out.shape == (4, 8, 6) and a.gate.shape == (4, 6)
    # flax's lecun_normal of an (E, in, out) kernel: fan-in E * in
    assert a.w_in.abs().max().item() <= 2.0 / 0.87962566103423978 / np.sqrt(4 * 6) + 1e-6


class _FakeComm(htt.TorchCommunication):
    def __init__(self, size):
        super().__init__()
        self.size = size


def test_bad_expert_count_raises():
    with pytest.raises(ValueError, match="not divisible"):
        htt.nn.MoEMLP(3, 4, comm=_FakeComm(2), d_model=4, device="cpu")
    comm = MeshCommunication(devices=jax.devices()[:2])
    layer = FlaxMoE(n_experts=3, d_ff=4, comm=comm)
    with pytest.raises(ValueError, match="not divisible"):
        layer.init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 4), jnp.float32))


_INPUTS = textwrap.dedent("""
    import numpy as np

    def moe_inputs():
        rng = np.random.default_rng(8)
        return (rng.standard_normal((2, 8, 8)).astype(np.float32),
                rng.standard_normal((2, 8, 8)).astype(np.float32))
""")
_ns = {}
exec(_INPUTS, _ns)

_WORKER = _INPUTS + textwrap.dedent("""
    import sys
    import torch
    import torch.distributed as dist
    rank, world, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    import heat_tpu_torch as ht
    from heat_tpu_torch import interop
    ht.use_device("cpu")
    flat = np.load(f"{out}/moe_params.npz")
    params = {"gate": {"kernel": flat["gate"]}, "w_in": flat["w_in"], "w_out": flat["w_out"]}
    layer = interop.moe_mlp_from_flax(params, n_experts=4, d_ff=8, capacity_factor=2.0,
                                      comm=ht.get_comm(), device="cpu")
    x, w = moe_inputs()
    y = layer(torch.from_numpy(x))
    (y * torch.from_numpy(w)).sum().backward()
    np.savez(f"{out}/rank{rank}.npz", out=y.detach().numpy(), experts=np.array(layer.expert_range()),
             gate=layer.gate.grad.numpy(), w_in=layer.w_in.grad.numpy(),
             w_out=layer.w_out.grad.numpy())
    dist.destroy_process_group()
""")


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """One spawned world of two gloo ranks holding two experts each."""
    out = tmp_path_factory.mktemp("moe_gloo")
    x, _ = _ns["moe_inputs"]()
    layer, variables, np_vars = _flax(4, 8, x, 8, capacity_factor=2.0)
    p = np_vars["params"]
    np.savez(out / "moe_params.npz", gate=p["gate"]["kernel"], w_in=p["w_in"], w_out=p["w_out"])
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(r), "2", str(port), str(out)],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = []
    for proc in procs:
        try:
            logs.append(proc.communicate(timeout=120)[0])
        finally:
            proc.kill()
    assert all(proc.returncode == 0 for proc in procs), "\n".join(logs)
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(2)], variables, np_vars


def test_sharded_matches_unsharded_and_the_reference(two_ranks):
    ranks, variables, np_vars = two_ranks
    x, w = _ns["moe_inputs"]()
    one = interop.moe_mlp_from_flax(np_vars, n_experts=4, d_ff=8, capacity_factor=2.0,
                                    device="cpu")
    y = one(torch.from_numpy(x))
    (y * torch.from_numpy(w)).sum().backward()
    sharded = FlaxMoE(n_experts=4, d_ff=8, capacity_factor=2.0,
                      comm=MeshCommunication(devices=jax.devices()[:2]))
    want = np.asarray(jax.jit(sharded.apply)(variables, jnp.asarray(x)))
    for rank, r in enumerate(ranks):
        np.testing.assert_array_equal(r["experts"], [2 * rank, 2 * rank + 2])
        np.testing.assert_allclose(r["out"], y.detach().numpy(), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(r["out"], want, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(r["gate"], one.gate.grad.numpy(), rtol=TOL, atol=TOL)
        for name in ("w_in", "w_out"):
            np.testing.assert_allclose(r[name], getattr(one, name).grad.numpy()[2 * rank:
                                                                                2 * rank + 2],
                                       rtol=TOL, atol=TOL)
