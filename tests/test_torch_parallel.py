"""Sequence parallelism and the ring and halo schedules of heat_tpu_torch
against heat_tpu, over spawned gloo worlds of 1, 2, 3, 5 and 8 ranks.

Each world is one set of spawned processes (a module fixture; all worlds
start together and each has its own time limit of 120 s). Every rank runs
the port's ``ring_attention`` (causal and not, with pads: ``seq_len`` short
of the padded length), ``ulysses_attention`` where the heads divide over the
ranks (also with ``use_pallas=True``, the flash core, which on the CPU is
its plain version), ``TransformerLM(attn_impl="ring"|"ulysses", comm=...)``
(world of 2), the ring ``cdist``/``rbf``/``manhattan`` in both
``HEAT_TPU_RING_OVERLAP`` schedules, ``ring_pipeline``, ``halo_exchange``
(zero and wrap boundaries, a DNDarray and a tensor) and ``halo_stencil``,
and saves its chunk. This process holds them:

- against the JAX package on ``MeshCommunication(devices=jax.devices()[:p])``
  (forward values; the gradients of ring and Ulysses attention through
  ``jax.grad`` in the world of 2, where the reference's compile time allows);
- the gradients dQ, dK, dV in every world against the world of one
  (``local_attention`` over the whole sequence under autograd, in this
  process), so a gradient lost on the way back over the hops shows;
- the transformer's logits against the JAX package's ring and Ulysses
  models with the same weights, and its gradients (summed over the ranks)
  against the world of one (``attn_impl="local"`` on the whole sequence).

Tolerances: f32 attention and transformer values and gradients within 2e-5
of their largest magnitude (the online softmax sums in another order than
one block); the ring distances 1e-5 relative (2e-5 for the GEMM form,
whose cancellation the JAX package's CPU path shares), the two schedules
bit for bit; ring_pipeline and halos bit for bit against numpy (halos) and
to 1e-5 (a product of f32 tiles).
"""

import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import heat_tpu as ht_tpu
from heat_tpu.core.communication import MeshCommunication
from heat_tpu.nn import TransformerLM as FlaxLM
from heat_tpu.parallel import (halo_exchange as j_halo, ring_attention as j_ring,
                               ring_pipeline as j_pipeline, ulysses_attention as j_ulysses)
from heat_tpu.parallel.halo import halo_stencil as j_stencil

import heat_tpu_torch as htt
from heat_tpu_torch.parallel import local_attention

REPO = Path(__file__).resolve().parent.parent
WORLDS = (1, 2, 3, 5, 8)
ULYSSES_HEADS = 8
LM = dict(vocab_size=16, d_model=16, num_heads=2, num_layers=2, max_len=16)
LM_TOKENS = (2, 8)

_INPUTS = textwrap.dedent("""
    import numpy as np

    def attn_inputs(p, heads):
        rng = np.random.default_rng(100 + p + heads)
        shape = (2, 6 * p, heads, 8)
        q, k, v, w = (rng.standard_normal(shape).astype(np.float32) for _ in range(4))
        return q, k, v, w, 6 * p - 4

    def dist_inputs(p):
        rng = np.random.default_rng(200 + p)
        return (rng.standard_normal((5 * p + 2, 6)).astype(np.float32),
                rng.standard_normal((4 * p + 1, 6)).astype(np.float32))

    def pipeline_inputs(p):
        rng = np.random.default_rng(300 + p)
        return (rng.standard_normal((4 * p, 8)).astype(np.float32),
                rng.standard_normal((4 * p, 8)).astype(np.float32))

    def halo_input(p):
        return np.arange(3 * p * 2, dtype=np.float32).reshape(3 * p, 2)

    def lm_inputs():
        rng = np.random.default_rng(7)
        return rng.integers(0, 16, (2, 8)), rng.standard_normal((2, 8, 16)).astype(np.float32)

    def functional_inputs(p):
        rng = np.random.default_rng(400 + p)
        q, k, v = (rng.standard_normal((2, 6 * p - 1, 4, 8)).astype(np.float32)
                   for _ in range(3))
        x = rng.standard_normal((3 * p + 1, 5)).astype(np.float32)
        w = rng.standard_normal((5, 3)).astype(np.float32)
        return q, k, v, x, w, rng.standard_normal(3).astype(np.float32)

    def central(blk):
        return blk[2:] - blk[:-2]

    def forward(blk):
        return blk[1:] - blk[:-1]
""")

_WORKER = _INPUTS + textwrap.dedent("""
    import os
    import sys
    import torch
    import torch.distributed as dist
    rank, world, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    import heat_tpu_torch as ht
    from heat_tpu_torch import interop
    from heat_tpu_torch.parallel import (halo_exchange, halo_stencil, ring_attention,
                                         ring_pipeline, ulysses_attention)
    ht.use_device("cpu")
    comm = ht.get_comm()
    p = world
    res = {}

    def chunk(a, axis=1):
        c = a.shape[axis] // p
        return torch.from_numpy(np.ascontiguousarray(np.take(a, range(rank * c, (rank + 1) * c),
                                                             axis=axis)))

    def attend(fn, tag, heads, **kw):
        q, k, v, w, seq_len = attn_inputs(p, heads)
        ql, kl, vl = (chunk(a).requires_grad_(True) for a in (q, k, v))
        o = fn(ql, kl, vl, comm=comm, seq_len=seq_len, **kw)
        (o * chunk(w)).sum().backward()
        res[tag] = o.detach().numpy()
        for name, t in (("dq", ql), ("dk", kl), ("dv", vl)):
            res[f"{tag}_{name}"] = t.grad.numpy()

    for causal in (False, True):
        attend(ring_attention, f"ring_{causal}", 3, causal=causal)
    if ULYSSES_HEADS % p == 0:
        attend(ulysses_attention, "ulysses", ULYSSES_HEADS, causal=True, block_size=4)
        attend(ulysses_attention, "ulysses_pallas", ULYSSES_HEADS, causal=True, use_pallas=True)

    if p == 2:
        flat = np.load(f"{out}/lm_params.npz")
        params = {}
        for key, value in flat.items():
            node = params
            *path, leaf = key.split("/")
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = value
        tokens, w = lm_inputs()
        for impl in ("ring", "ulysses"):
            lm = interop.transformer_lm_from_flax(params, **LM, attn_impl=impl, comm=comm,
                                                  device="cpu")
            logits = lm(chunk(tokens))
            (logits * chunk(w)).sum().backward()
            res[f"lm_{impl}"] = logits.detach().numpy()
            for name, t in lm.named_parameters():
                res[f"lm_{impl}_grad_{name}"] = t.grad.numpy()

    fq, fk, fv, fx, fw, fb = functional_inputs(p)
    fqs, fks, fvs = (ht.array(a, split=1) for a in (fq, fk, fv))
    for strategy in ("auto", "ring", "ulysses"):
        if strategy != "ulysses" or 4 % p == 0:
            res[f"sdpa_{strategy}"] = ht.nn.functional.scaled_dot_product_attention(
                fqs, fks, fvs, causal=True, strategy=strategy).larray.numpy()
    for act in (None, "relu", "tanh", "sigmoid"):
        res[f"dense_{act}"] = ht.nn.functional.dense(ht.array(fx, split=0), ht.array(fw),
                                                     ht.array(fb), act).larray.numpy()

    x, y = dist_inputs(p)
    xd, yd = ht.array(x, split=0), ht.array(y, split=0)
    for knob in ("1", "0"):
        os.environ["HEAT_TPU_RING_OVERLAP"] = knob
        res[f"cdist_{knob}"] = ht.spatial.cdist(xd, yd, ring=True).larray.numpy()
        res[f"cdist_q_{knob}"] = ht.spatial.cdist(xd, yd, quadratic_expansion=True,
                                                  ring=True).larray.numpy()
        res[f"rbf_{knob}"] = ht.spatial.rbf(xd, yd, sigma=1.3, quadratic_expansion=True,
                                            ring=True).larray.numpy()
        res[f"manhattan_{knob}"] = ht.spatial.manhattan(xd, yd, ring=True).larray.numpy()

    a, b = pipeline_inputs(p)
    c = a.shape[0] // p

    def step(t, origin, stat, circ, acc):
        acc = acc.clone()
        acc[:, origin * c:(origin + 1) * c] = stat @ circ.T
        return acc

    res["pipeline"] = ring_pipeline(step, chunk(a, 0), chunk(b, 0),
                                    torch.zeros((c, a.shape[0])), comm=comm).numpy()

    h = halo_input(p)
    hd = ht.array(h, split=0)
    res["halo_zero"] = halo_exchange(hd, 2).numpy()
    res["halo_wrap"] = halo_exchange(chunk(h, 0), 2, comm=comm, wrap=True).numpy()
    prev, nxt = halo_exchange(hd, 1, return_parts=True)
    res["halo_parts"] = np.stack([prev.numpy(), nxt.numpy()])
    res["stencil_both"] = halo_stencil(hd, 1, central).numpy()
    res["stencil_prev_wrap"] = halo_stencil(chunk(h, 0), 1, forward, comm=comm, wrap=True,
                                            sides="prev").numpy()
    hd.get_halo(1)
    if p > 1:
        res["get_halo"] = np.stack([hd.halo_prev.numpy(), hd.halo_next.numpy()])
    np.savez(f"{out}/rank{rank}.npz", **res)
    dist.destroy_process_group()
""")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _flax_lm_params(out: Path):
    """A flax TransformerLM's initial weights, flattened into an .npz for
    the workers; returns the nested tree."""
    tokens, _ = _ns["lm_inputs"]()
    model = FlaxLM(**LM, attn_impl="local")
    variables = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(3), jnp.asarray(tokens)))
    flat = {"/".join(str(k.key) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(variables)[0]}
    np.savez(out / "lm_params.npz", **flat)
    return variables


_ns = {}
exec(_INPUTS, _ns)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every world spawned at once; each rank's saved results by world."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    env.pop("HEAT_TPU_RING_OVERLAP", None)
    runs = {}
    lm_vars = None
    for world in WORLDS:
        out = tmp_path_factory.mktemp(f"parallel_world{world}")
        if world == 2:
            lm_vars = _flax_lm_params(out)
        port = _free_port()
        worker = (f"LM = {LM!r}\nULYSSES_HEADS = {ULYSSES_HEADS}\n") + _WORKER
        runs[world] = (out, [subprocess.Popen(
            [sys.executable, "-c", worker, str(r), str(world), str(port), str(out)], cwd=REPO,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)])
    results = {"lm_vars": lm_vars}
    for world, (out, procs) in runs.items():
        logs = []
        for proc in procs:
            try:
                logs.append(proc.communicate(timeout=120)[0])
            finally:
                proc.kill()
        assert all(proc.returncode == 0 for proc in procs), "\n".join(logs)
        results[world] = [dict(np.load(out / f"rank{r}.npz")) for r in range(world)]
    return results


def _gather(ranks, name, axis=1):
    return np.concatenate([r[name] for r in ranks], axis=axis)


def _close(got, want, tol, name=""):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale, err_msg=name)


def _sub_comm(p):
    return MeshCommunication(devices=jax.devices()[:p])


def _world_of_one_attention(q, k, v, w, seq_len, causal):
    """Output and dQ, dK, dV of the whole sequence on one rank."""
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = local_attention(qt, kt, vt, causal=causal, kv_valid=seq_len, block_size=q.shape[1])
    (out * torch.from_numpy(w)).sum().backward()
    return out.detach().numpy(), qt.grad.numpy(), kt.grad.numpy(), vt.grad.numpy()


def _jax_attention(fn, p, q, k, v, **kw):
    comm = _sub_comm(p)
    sh = comm.sharding(1, 4)
    args = [jax.device_put(jnp.asarray(a), sh) for a in (q, k, v)]
    return np.asarray(fn(*args, comm=comm, **kw))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_reference_and_world_of_one(worlds, world, causal):
    q, k, v, w, seq_len = _ns["attn_inputs"](world, 3)
    ranks = worlds[world]
    tag = f"ring_{causal}"
    got = _gather(ranks, tag)
    want = _jax_attention(j_ring, world, q, k, v, causal=causal, seq_len=seq_len)
    _close(got, want, 2e-5, "forward vs the JAX package")
    one = _world_of_one_attention(q, k, v, w, seq_len, causal)
    _close(got, one[0], 2e-5, "forward vs the world of one")
    for name, grad in zip(("dq", "dk", "dv"), one[1:]):
        _close(_gather(ranks, f"{tag}_{name}"), grad, 2e-5, name)


@pytest.mark.parametrize("world", [p for p in WORLDS if ULYSSES_HEADS % p == 0])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_ulysses_attention_matches_reference_and_world_of_one(worlds, world, use_pallas):
    q, k, v, w, seq_len = _ns["attn_inputs"](world, ULYSSES_HEADS)
    ranks = worlds[world]
    tag = "ulysses_pallas" if use_pallas else "ulysses"
    got = _gather(ranks, tag)
    if not use_pallas:  # the interpreted Pallas reference is too slow to compile for the suite
        want = _jax_attention(j_ulysses, world, q, k, v, causal=True, seq_len=seq_len,
                              block_size=4)
        _close(got, want, 2e-5, "forward vs the JAX package")
    one = _world_of_one_attention(q, k, v, w, seq_len, True)
    _close(got, one[0], 2e-5, "forward vs the world of one")
    for name, grad in zip(("dq", "dk", "dv"), one[1:]):
        _close(_gather(ranks, f"{tag}_{name}"), grad, 2e-5, name)


class _FakeComm(htt.TorchCommunication):
    """A world of ``size`` ranks as far as the argument checks see."""

    def __init__(self, size):
        super().__init__()
        self.size = size


def test_ulysses_refuses_heads_that_do_not_divide():
    x = torch.zeros((1, 4, 3, 8))
    with pytest.raises(TypeError, match="TorchCommunication"):
        htt.parallel.ulysses_attention(x, x, x, comm=object())
    with pytest.raises(ValueError, match="must divide over mesh size"):
        htt.parallel.ulysses_attention(x, x, x, comm=_FakeComm(2))
    with pytest.raises(ValueError, match="must divide over mesh size") as want:
        j_ulysses(jnp.zeros((1, 4, 3, 8)), jnp.zeros((1, 4, 3, 8)), jnp.zeros((1, 4, 3, 8)),
                  comm=_sub_comm(2))
    assert "heads (3)" in str(want.value)


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_attention_gradients_match_jax_grad_in_a_world_of_two(worlds, impl):
    """dQ, dK, dV of the spawned world of two against ``jax.grad`` of the JAX
    package's own sequence-parallel attention on two devices."""
    heads = 3 if impl == "ring" else ULYSSES_HEADS
    q, k, v, w, seq_len = _ns["attn_inputs"](2, heads)
    comm = _sub_comm(2)
    sh = comm.sharding(1, 4)
    fn = j_ring if impl == "ring" else j_ulysses
    kw = {"block_size": 4} if impl == "ulysses" else {}

    def loss(a, b, c):
        return (fn(a, b, c, comm=comm, causal=True, seq_len=seq_len, **kw) * w).sum()

    grads = jax.grad(loss, argnums=(0, 1, 2))(*(jax.device_put(jnp.asarray(a), sh)
                                                for a in (q, k, v)))
    tag = "ring_True" if impl == "ring" else "ulysses"
    for name, grad in zip(("dq", "dk", "dv"), grads):
        _close(_gather(worlds[2], f"{tag}_{name}"), np.asarray(grad), 2e-5, name)


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_transformer_lm_sequence_parallel_in_a_world_of_two(worlds, impl):
    tokens, w = _ns["lm_inputs"]()
    variables = worlds["lm_vars"]
    ranks = worlds[2]
    jax_model = FlaxLM(**LM, attn_impl=impl, comm=_sub_comm(2))
    want = np.asarray(jax_model.apply(variables, jnp.asarray(tokens)))
    got = _gather(ranks, f"lm_{impl}")
    _close(got, want, 2e-5, "logits vs the JAX package")
    one = htt.interop.transformer_lm_from_flax(variables, **LM, attn_impl="local",
                                               device="cpu")
    logits = one(torch.from_numpy(tokens))
    _close(got, logits.detach().numpy(), 2e-5, "logits vs the world of one")
    (logits * torch.from_numpy(w)).sum().backward()
    for name, t in one.named_parameters():
        summed = sum(r[f"lm_{impl}_grad_{name}"] for r in ranks)
        _close(summed, t.grad.numpy(), 2e-5, name)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("fn", ["cdist", "cdist_q", "rbf", "manhattan"])
def test_ring_distances_match_reference(worlds, world, fn):
    x, y = _ns["dist_inputs"](world)
    comm = _sub_comm(world)
    xj, yj = ht_tpu.array(x, split=0, comm=comm), ht_tpu.array(y, split=0, comm=comm)
    call = {"cdist": lambda a, b, **kw: ht_tpu.spatial.cdist(a, b, **kw),
            "cdist_q": lambda a, b, **kw: ht_tpu.spatial.cdist(a, b, quadratic_expansion=True,
                                                               **kw),
            "rbf": lambda a, b, **kw: ht_tpu.spatial.rbf(a, b, sigma=1.3,
                                                         quadratic_expansion=True, **kw),
            "manhattan": lambda a, b, **kw: ht_tpu.spatial.manhattan(a, b, **kw)}[fn]
    want = call(xj, yj, ring=True).numpy()
    ranks = worlds[world]
    got = _gather(ranks, f"{fn}_1", axis=0)
    rtol = 2e-5 if fn in ("cdist_q", "rbf") else 1e-5
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol)
    for r in ranks:  # both schedules give the same tiles
        np.testing.assert_array_equal(r[f"{fn}_1"], r[f"{fn}_0"])
    counts = htt.core.communication.counts_displs(x.shape[0], world)[0]
    assert [r[f"{fn}_1"].shape[0] for r in ranks] == list(counts)


@pytest.mark.parametrize("world", WORLDS)
def test_ring_pipeline_matches_numpy_and_reference(worlds, world):
    a, b = _ns["pipeline_inputs"](world)
    got = _gather(worlds[world], "pipeline", axis=0)
    np.testing.assert_allclose(got, a @ b.T, rtol=1e-5, atol=1e-5)
    comm = _sub_comm(world)
    sh = comm.sharding(0, 2)
    n = a.shape[0]

    def step(t, origin, stat, circ, acc):
        col = origin * (n // world)
        return jax.lax.dynamic_update_slice(acc, stat @ circ.T,
                                            (jnp.zeros((), col.dtype), col))

    want = j_pipeline(step, jax.device_put(jnp.asarray(a), sh),
                      jax.device_put(jnp.asarray(b), sh),
                      jax.device_put(jnp.zeros((n, n), jnp.float32), sh), comm=comm)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


class _RingProbe:
    """One rank of a ring whose ranks step in lockstep: a block holds the
    rank it started on, and a hop hands this rank the block of rank - shift.
    Records each hop (whether it was asynchronous)."""

    def __init__(self, size, rank):
        self.size, self.rank, self.hops = size, rank, []

    def ring_permute(self, x, shift=1, async_op=False):
        self.hops.append(async_op)
        out = (x - shift) % self.size
        return SimpleNamespace(wait=lambda: out) if async_op else out


@pytest.mark.parametrize("world", (1, 2, 3, 5))
@pytest.mark.parametrize("shift", (1, 2, -1))
@pytest.mark.parametrize("overlap, home", [(False, False), (True, False), (False, True)])
def test_ring_steps_visits_every_origin_once(world, shift, overlap, home):
    """The one hop loop of the rings: step t visits the block of rank
    (rank - t * shift) mod p; p - 1 hops, asynchronous under ``overlap``,
    and the p-th (home) hop only when asked for."""
    from heat_tpu_torch.core.communication import ring_steps

    for rank in range(world):
        comm, seen = _RingProbe(world, rank), []
        ring_steps(comm, torch.tensor(rank),
                   lambda t, origin, blk: seen.append((t, origin, int(blk))),
                   shift=shift, overlap=overlap, home=home)
        assert seen == [(t, (rank - t * shift) % world, (rank - t * shift) % world)
                        for t in range(world)]
        assert comm.hops == [overlap] * (world - 1 + home)


@pytest.mark.parametrize("world", WORLDS)
def test_halo_exchange_and_stencil_match_reference(worlds, world):
    h = _ns["halo_input"](world)
    ranks = worlds[world]
    comm = _sub_comm(world)
    hj = jax.device_put(jnp.asarray(h), comm.sharding(0, 2))
    for name, want in (
            ("halo_zero", j_halo(hj, 2, comm=comm)),
            ("halo_wrap", j_halo(hj, 2, comm=comm, wrap=True)),
            ("stencil_both", j_stencil(hj, 1, _ns["central"], comm=comm)),
            ("stencil_prev_wrap", j_stencil(hj, 1, _ns["forward"], comm=comm, wrap=True,
                                            sides="prev"))):
        np.testing.assert_array_equal(_gather(ranks, name, axis=0), np.asarray(want),
                                      err_msg=name)
    prev, nxt = j_halo(hj, 1, comm=comm, return_parts=True)
    for rank, r in enumerate(ranks):
        np.testing.assert_array_equal(r["halo_parts"][0], np.split(np.asarray(prev), world)[rank])
        np.testing.assert_array_equal(r["halo_parts"][1], np.split(np.asarray(nxt), world)[rank])
        if world > 1:  # DNDarray.get_halo: the same hops, open boundary
            np.testing.assert_array_equal(r["get_halo"], r["halo_parts"])


def test_halo_refuses_a_halo_longer_than_a_block():
    x = htt.array(np.zeros((3, 2), np.float32), split=0, device="cpu")
    with pytest.raises(ValueError, match="exceeds local extent"):
        htt.parallel.halo_exchange(x, 4)
    with pytest.raises(ValueError, match="sides must be"):
        htt.parallel.halo_stencil(x, 1, lambda b: b, sides="up")
    with pytest.raises(ValueError, match="positive integer"):
        htt.parallel.halo_exchange(x, 0)


@pytest.mark.parametrize("fn", ["cdist", "rbf", "manhattan"])
def test_ring_distance_audit_raises_until_telemetry(fn):
    """Telemetry is ported: ``audit=True`` runs (a world of one takes the
    ordinary path) and gives the unaudited result."""
    x = htt.array(np.arange(12, dtype=np.float32).reshape(4, 3), split=0, device="cpu")
    got = getattr(htt.spatial, fn)(x, ring=True, audit=True)
    want = getattr(htt.spatial, fn)(x, ring=True)
    assert torch.equal(got.larray, want.larray)


@pytest.mark.parametrize("world", WORLDS)
def test_functional_matches_reference(worlds, world):
    """``nn.functional``: the attention entry point on DNDarrays split along
    the sequence (a ragged tail: 6p - 1 positions, chunks by the ceil rule)
    with each strategy, and the dense layer on a row-split DNDarray."""
    from heat_tpu.nn import functional as jfn

    q, k, v, x, w, b = _ns["functional_inputs"](world)
    comm = _sub_comm(world)
    ranks = worlds[world]
    qj, kj, vj = (ht_tpu.array(a, split=1, comm=comm) for a in (q, k, v))
    for strategy in ("auto", "ring", "ulysses"):
        if strategy == "ulysses" and 4 % world:
            continue
        want = jfn.scaled_dot_product_attention(qj, kj, vj, causal=True, strategy=strategy)
        got = _gather(ranks, f"sdpa_{strategy}")
        _close(got, want.numpy(), 2e-5, strategy)
        counts = htt.core.communication.counts_displs(q.shape[1], world)[0]
        assert [r[f"sdpa_{strategy}"].shape[1] for r in ranks] == list(counts)
    for act in (None, "relu", "tanh", "sigmoid"):
        want = jfn.dense(ht_tpu.array(x, split=0, comm=comm), ht_tpu.array(w, comm=comm),
                         ht_tpu.array(b, comm=comm), act).numpy()
        np.testing.assert_allclose(_gather(ranks, f"dense_{act}", axis=0), want, rtol=1e-5,
                                   atol=1e-6, err_msg=str(act))


def test_functional_on_one_rank_and_its_refusals():
    from heat_tpu.nn import functional as jfn

    rng = np.random.default_rng(12)
    q, k, v = (rng.standard_normal((1, 10, 2, 8)).astype(np.float32) for _ in range(3))
    fn = htt.nn.functional.scaled_dot_product_attention
    want = np.asarray(jfn.scaled_dot_product_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                                       causal=True))
    _close(fn(*(torch.from_numpy(a) for a in (q, k, v)), causal=True).numpy(), want, 2e-5)
    for split in (None, 1):
        arrs = [htt.array(a, split=split, device="cpu") for a in (q, k, v)]
        got = fn(*arrs, causal=True)
        assert got.split == split
        _close(got.numpy(), want, 2e-5)
    with pytest.raises(ValueError, match="strategy"):
        fn(*(torch.from_numpy(a) for a in (q, k, v)), strategy="tree")
    qd = htt.array(q, split=1, device="cpu")
    with pytest.raises(TypeError, match="all be DNDarray"):
        fn(qd, torch.from_numpy(k), torch.from_numpy(v))
    with pytest.raises(ValueError, match="splits must match"):
        fn(qd, htt.array(k, device="cpu"), htt.array(v, device="cpu"))
    with pytest.raises(NotImplementedError, match="resplit to 1"):
        fn(*(htt.array(a, split=0, device="cpu") for a in (q, k, v)))
    x = htt.array(rng.standard_normal((4, 5)).astype(np.float32), device="cpu")
    wt = htt.array(rng.standard_normal((5, 3)).astype(np.float32), device="cpu")
    with pytest.raises(ValueError, match="activation"):
        htt.nn.functional.dense(x, wt, activation="swish")
    assert htt.nn.functional.dense(x, wt, activation=htt.abs).shape == (4, 3)
