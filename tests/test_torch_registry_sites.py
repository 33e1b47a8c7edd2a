"""Every program site of the JAX package dispatches through the port's
registry (``heat_tpu_torch.core.program_cache``) under its name.

- For each site of the JAX package outside serving and fusion, the same
  numpy input drives the same operation through both packages twice, from
  an empty registry: the site's misses move on the first call and its hits
  on the second (and the misses do not move again), in both packages. The
  JAX package runs on its 8-device CPU mesh (its pipeline and DASO on three
  and four of the devices, its DataParallel and ZeRO on one; FSDP enabled,
  ``HEAT_TPU_FSDP=1``, in both); the port on one spawned world of three gloo ranks,
  where the distributed paths run (on one rank most of them take no
  collective, as the JAX package's on one device). The training sites
  count a call as the JAX package does: a ``make_train_step``, a wrapper's
  construction or its ``_get_*`` program.
- Fault injection behaves as ``tests/test_resilience.py`` pins it for the
  JAX package: a transient fault at ``relayout`` is retried to the same
  bits, raises without retries and escalates with its attempts; a fault at
  the second ``cg_chunk`` window kills a checkpointed ``cg`` after its first
  checkpoint, and the resumed solve equals the uninterrupted one bit for bit
  (``cg`` and ``lanczos``, both packages).
- An ``is_split`` array assembled from ragged blocks moves through the
  communicator's audited all-gather (``telemetry.hlo``'s audit records it).
- A transient fault never applies an optimizer step twice: an injected
  fault (before the step runs) is retried and the step applied once; a
  fault raised while an in-place step runs escalates at once (the
  ``donated`` programs) instead of running the step a second time.
"""

import numpy as np
import pytest
import torch

import heat_tpu as ht_tpu
from heat_tpu import resilience as jax_resilience
from heat_tpu.core import program_cache as jax_cache
from heat_tpu.resilience import faults as jax_faults

import heat_tpu_torch as htt
from heat_tpu_torch import resilience
from heat_tpu_torch.core import program_cache
from heat_tpu_torch.resilience import faults

from tests.torch_spmd import spawn

# -- the drivers: one call of an operation that reaches a site; the same
# source runs against either package (``ht``) where their APIs agree

_DATA = """
import os
import numpy as np

RNG = np.random.default_rng(19)
D = RNG.standard_normal((7, 5)).astype(np.float32)
V = RNG.standard_normal(10).astype(np.float32)
T = RNG.standard_normal((9, 4)).astype(np.float32)
W = RNG.standard_normal((3, 7)).astype(np.float32)
M = RNG.standard_normal((12, 12))
SPD = (M @ M.T + 12 * np.eye(12)).astype(np.float32)
RHS = RNG.standard_normal(12).astype(np.float32)
SPARSE = np.where(RNG.random((8, 6)) < 0.4, RNG.standard_normal((8, 6)), 0).astype(np.float32)
BLOBS = np.concatenate([RNG.normal(-3, 0.3, (6, 2)), RNG.normal(3, 0.3, (6, 2))]).astype(
    np.float32)
LENS = (4, 2, 1)  # ragged blocks of D's rows: not the ceil-rule (3, 3, 1)


def _knob(ht, name, value):
    return ht._knobs.overlay({name: value})


def _ckpt(tmp, name):
    return os.path.join(str(tmp), name)


def drive_relayout(ht, tmp, rank, world):
    ht.array(D, split=0).resplit(1)


def drive_planned(ht, plan):
    with _knob(ht, "HEAT_TPU_RELAYOUT_PLAN", plan):
        ht.array(D, split=0).resplit(1)


def drive_relayout_init(ht, tmp, rank, world):
    drive_planned(ht, "chunked")


drive_relayout_chunk = drive_relayout_init


def drive_relayout_a2a(ht, tmp, rank, world):
    drive_planned(ht, "alltoall")


def drive_cg(ht, tmp, rank, world):
    ht.linalg.cg(ht.array(SPD, split=0), ht.array(RHS), ht.zeros(12, dtype=ht.float32))


def drive_cg_windows(ht, tmp, rank, world):
    path = _ckpt(tmp, "cg%d" % rank)
    ht.linalg.cg(ht.array(SPD, split=0), ht.array(RHS), ht.zeros(12, dtype=ht.float32),
                 checkpoint_every=3, checkpoint_path=path)


drive_cg_init = drive_cg_chunk = drive_cg_windows


def drive_lanczos(ht, tmp, rank, world):
    ht.linalg.lanczos(ht.array(SPD, split=0), 4)


def drive_lanczos_windows(ht, tmp, rank, world):
    ht.linalg.lanczos(ht.array(SPD, split=0), 4, checkpoint_every=2,
                      checkpoint_path=_ckpt(tmp, "lz%d" % rank))


drive_lanczos_init = drive_lanczos_chunk = drive_lanczos_windows


def drive_is_split_gather(ht, tmp, rank, world):
    if world == 1:  # the JAX package assembles ragged blocks when several processes run
        ht.core.factories._assemble_ragged(D, 0, D.shape, np.array([D.shape]), ht.get_device(),
                                           ht.get_comm(), None)
    else:
        lo = sum(LENS[:rank])
        ht.array(D[lo:lo + LENS[rank]], is_split=0)


def drive_streaming_lasso(ht, tmp, rank, world):
    ht.regression.Lasso(lam=0.1, max_iter=4).partial_fit(ht.array(D, split=0),
                                                        ht.array(V[:7], split=0))


def drive_streaming_moments(ht, tmp, rank, world):
    ht.core.statistics.chunk_moments(ht.array(D, split=0))


def drive_streaming_minibatch_kmeans(ht, tmp, rank, world):
    ht.streaming.MiniBatchKMeans(n_clusters=2, random_state=0).partial_fit(
        ht.array(BLOBS, split=0))


def drive_sparse_laplacian(ht, tmp, rank, world):
    ht.graph.Laplacian(lambda x: ht.spatial.rbf(x, sigma=1.0, quadratic_expansion=True),
                       definition="norm_sym", mode="eNeighbour", threshold_key="lower",
                       threshold_value=0.5, sparse=True).construct(ht.array(BLOBS, split=0))


def drive_ring_cdist(ht, tmp, rank, world):
    x = ht.array(D, split=0)
    ht.spatial.cdist(x, x, ring=True)


def drive_cholqr(ht, tmp, rank, world):
    ht.linalg.qr(ht.array(T, split=1))


drive_cholqr_gram_ring = drive_cholqr_panel_solve = drive_cholqr


def drive_qr_wide_lead(ht, tmp, rank, world):
    ht.linalg.qr(ht.array(W, split=1))


def drive_tsqr(ht, tmp, rank, world):
    ht.linalg.qr(ht.array(T, split=0))


def drive_reshape_split(ht, tmp, rank, world):
    ht.reshape(ht.array(D, split=0), (5, 7))


def drive_concat_split(ht, tmp, rank, world):
    ht.concatenate([ht.array(D, split=0), ht.array(D[:3], split=0)], axis=0)


def drive_permute_split_axis(ht, tmp, rank, world):
    ht.flip(ht.array(D, split=0), 0)


def drive_oddeven_sort(ht, tmp, rank, world):
    ht.sort(ht.array(V, split=0))


def drive_sharded_take(ht, tmp, rank, world):
    ht.array(D, split=0)[np.array([3, 0, 5])]


def _sparse(ht):
    return ht.sparse.csr_from_dense(ht.array(SPARSE, split=0))


def drive_sparse_spmv(ht, tmp, rank, world):
    ht.sparse.spmv(_sparse(ht), ht.array(V[:6], split=0))


def drive_sparse_spmm(ht, tmp, rank, world):
    ht.sparse.spmm(_sparse(ht), ht.array(D[:6, :3], split=0))


def drive_sparse_to_dense(ht, tmp, rank, world):
    ht.sparse.to_dense(_sparse(ht))


def drive_sparse_transpose(ht, tmp, rank, world):
    ht.sparse.transpose(_sparse(ht))


drive_sparse_transpose_a2a = drive_sparse_transpose_build = drive_sparse_transpose
"""

# the port's training drivers (torch modules and optimizers)
_PORT_TRAINING = """
import torch

torch.manual_seed(0)
NET = torch.nn.Sequential(torch.nn.Linear(5, 4), torch.nn.Tanh(), torch.nn.Linear(4, 2))
XB = torch.from_numpy(D[:6].copy())
YB = torch.from_numpy(np.ones((6, 2), np.float32))


def mse(module, x, y):
    return ((module(x) - y) ** 2).mean()


def out_mse(out, y):
    return ((out - y) ** 2).mean()


def _grads():
    return {n: torch.ones_like(p) for n, p in NET.named_parameters()}


def drive_dp_forward(ht, tmp, rank, world):
    ht.nn.DataParallel(NET)(XB)


def drive_dp_train_step(ht, tmp, rank, world):
    ht.nn.DataParallel(NET, optimizer=torch.optim.SGD(NET.parameters(), lr=0.1),
                       blocking_parameter_updates=True).make_train_step(mse)


OPT = torch.optim.SGD(NET.parameters(), lr=0.1)


def drive_dp_optimizer_step(ht, tmp, rank, world):
    ht.optim.DataParallelOptimizer(OPT).step(NET, None, _grads())


def _daso(ht):
    daso = ht.optim.DASO(torch.optim.SGD(NET.parameters(), lr=0.1), total_epochs=2)
    daso.set_loss(mse)
    return daso


def drive_daso_step(ht, tmp, rank, world):
    daso = _daso(ht)
    daso._local_step(NET, daso.local_optimizer, (XB, YB), False, False)


def drive_daso_send(ht, tmp, rank, world):
    _daso(ht)._global_send(NET).wait()


def drive_daso_merge(ht, tmp, rank, world):
    daso = _daso(ht)
    daso._merge(NET, daso._global_send(NET), 1.0)


ZO = None


def _zero(ht):
    global ZO
    if ZO is None:
        ZO = ht.optim.ZeroOptimizer(torch.optim.SGD)
        ZO.init(NET)
    return ZO


def drive_zero_opt_init(ht, tmp, rank, world):
    ht.optim.ZeroOptimizer(torch.optim.SGD).init(NET)


def drive_zero_step(ht, tmp, rank, world):
    zo = _zero(ht)
    zo.step(NET, zo, _grads())


def drive_zero_train_step(ht, tmp, rank, world):
    _zero(ht).make_train_step(mse)


STAGES = [torch.nn.Linear(5, 4), torch.nn.Linear(4, 2)]
FS = None


def _fsdp(ht):
    global FS
    if FS is None:
        model = ht.nn.FSDP(STAGES, optimizer=torch.optim.SGD)
        FS = (model, model.shard_params(model.init()))
    return FS


def drive_fsdp_opt_init(ht, tmp, rank, world):
    model, params = _fsdp(ht)
    model.init_opt_state(params)


def drive_fsdp_forward(ht, tmp, rank, world):
    model, params = _fsdp(ht)
    model(params, XB)


def drive_fsdp_train_step(ht, tmp, rank, world):
    model, _ = _fsdp(ht)
    model.make_train_step(out_mse)


def _stage(p, h):
    return torch.tanh(h @ p["w"])


STACKED = {"w": torch.from_numpy(np.stack([np.eye(5, dtype=np.float32)] * 3))}


def drive_pipeline_apply(ht, tmp, rank, world):
    ht.parallel.pipeline_apply(_stage, STACKED, XB, comm=ht.get_comm(), n_microbatches=3)


class Layer(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(5, 5))

    def forward(self, h):
        return torch.tanh(h @ self.w)


PIPE = None


def drive_pipeline_step(ht, tmp, rank, world):
    global PIPE
    if PIPE is None:
        PIPE = ht.nn.Pipeline(Layer(), 3, optimizer=lambda ps: torch.optim.SGD(ps, lr=0.1),
                              loss_fn=out_mse, n_microbatches=3)
        PIPE.shard_params(PIPE.init())
    PIPE.make_train_step()
"""

# the JAX package's training drivers (flax stages, optax)
_JAX_TRAINING = """
import jax
import jax.numpy as jnp
import optax
import flax.linen as fnn
from heat_tpu.core.communication import MeshCommunication

PARAMS = {"w1": jnp.asarray(D[:5, :4]), "b1": jnp.zeros(4), "w2": jnp.asarray(D[:4, :2]),
          "b2": jnp.zeros(2)}
XB = jnp.asarray(D[:6])
YB = jnp.ones((6, 2), jnp.float32)
SGD = optax.sgd(0.1)


def apply_fn(p, x):
    return jnp.tanh(x @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]


def mse(p, x, y):
    return jnp.mean((apply_fn(p, x) - y) ** 2)


def out_mse(out, y):
    return jnp.mean((out - y) ** 2)


def _one():
    return MeshCommunication(devices=jax.devices()[:1])


def drive_dp_forward(ht, tmp, rank, world):
    ht.nn.DataParallel(apply_fn, comm=_one())(PARAMS, XB)


def drive_dp_train_step(ht, tmp, rank, world):
    ht.nn.DataParallel(apply_fn, comm=_one(), optimizer=SGD,
                       blocking_parameter_updates=True).make_train_step(mse)


def drive_dp_optimizer_step(ht, tmp, rank, world):
    ht.optim.DataParallelOptimizer(SGD)


def _daso(ht):
    daso = ht.optim.DASO(SGD, total_epochs=2, comm=MeshCommunication(devices=jax.devices()[:4]))
    daso.set_loss(mse)
    return daso


def drive_daso_step(ht, tmp, rank, world):
    _daso(ht)._get_step(local_sync=False, full_sync=False)


def drive_daso_send(ht, tmp, rank, world):
    _daso(ht)._get_global_send()


def drive_daso_merge(ht, tmp, rank, world):
    _daso(ht)._get_merge()


ZO = ht_jax.optim.ZeroOptimizer(SGD, comm=_one())
ZPARAMS = {"w": jnp.asarray(T[:, :3]), "b": jnp.zeros(3)}


def zloss(p, x, y):
    return jnp.mean((x @ p["w"] + p["b"] - y) ** 2)


def drive_zero_opt_init(ht, tmp, rank, world):
    ZO.init(ZPARAMS)


def drive_zero_step(ht, tmp, rank, world):
    try:
        ZO.step(ZPARAMS, ZO.init(ZPARAMS), {"w": jnp.ones((9, 3)), "b": jnp.ones(3)})
    except ValueError as e:
        # the JAX package's ZeRO step dispatches, then fails to trace under this
        # jax (as in tests/test_zero_optimizer.py): its lookup has counted
        if "shard_map" not in str(e):
            raise


def drive_zero_train_step(ht, tmp, rank, world):
    ZO.make_train_step(zloss)


FSDP_COMM = MeshCommunication(devices=jax.devices()[:4])
FS = None


def _fsdp(ht):
    global FS
    if FS is None:
        stages = [fnn.Dense(4), fnn.Dense(2)]
        variables = ht.nn.FSDP(stages).init(jax.random.PRNGKey(0), XB)
        model = ht.nn.FSDP(stages, comm=FSDP_COMM, optimizer=SGD)
        FS = (model, model.shard_params(variables))
    return FS


def drive_fsdp_opt_init(ht, tmp, rank, world):
    model, params = _fsdp(ht)
    model.init_opt_state(params)


def drive_fsdp_forward(ht, tmp, rank, world):
    model, params = _fsdp(ht)
    model(params, XB[:4])


def drive_fsdp_train_step(ht, tmp, rank, world):
    model, _ = _fsdp(ht)
    model.make_train_step(out_mse)


def _stage(p, h):
    return jnp.tanh(h @ p["w"])


STACKED = {"w": jnp.asarray(np.stack([np.eye(5, dtype=np.float32)] * 3))}
THREE = MeshCommunication(devices=jax.devices()[:3])


def drive_pipeline_apply(ht, tmp, rank, world):
    ht.parallel.pipeline_apply(_stage, STACKED, XB, comm=THREE, n_microbatches=3)


PIPE = None


def drive_pipeline_step(ht, tmp, rank, world):
    global PIPE
    if PIPE is None:
        PIPE = ht.nn.Pipeline(fnn.Dense(5), 3, comm=THREE, optimizer=SGD, loss_fn=out_mse,
                              n_microbatches=3)
        PIPE.shard_params(PIPE.init(jax.random.PRNGKey(0), XB[:2]))
    PIPE.make_train_step()
"""

# row of the site table -> the sites it dispatches
SITES = [
    "relayout", "relayout_init", "relayout_chunk", "relayout_a2a",
    "cg", "cg_init", "cg_chunk", "lanczos", "lanczos_init", "lanczos_chunk",
    "is_split_gather", "streaming.lasso", "streaming.moments", "streaming.minibatch_kmeans",
    "sparse.laplacian", "ring_cdist",
    "cholqr_gram_ring", "cholqr_panel_solve", "qr_wide_lead", "tsqr",
    "reshape_split", "concat_split", "permute_split_axis", "oddeven_sort",
    "sharded_take",
    "sparse.spmv", "sparse.spmm", "sparse.to_dense", "sparse.transpose_a2a",
    "sparse.transpose_build",
    "dp_forward", "dp_train_step",
    "dp_optimizer_step", "daso_step", "daso_send", "daso_merge",
    "zero_opt_init", "zero_step", "zero_train_step",
    "fsdp_opt_init", "fsdp_forward", "fsdp_train_step",
    "pipeline.apply", "pipeline.step",
]

_SITES_RUN = """
SITE_LIST = %r


def exact_stats(cache, site):
    row = cache.stats()["sites"].get(site, {"hits": 0, "misses": 0})
    return [row["misses"], row["hits"]]


def drive_twice(ht, cache, site, tmp, rank, world):
    fn = globals()["drive_" + site.replace(".", "_")]
    cache.reset()
    fn(ht, tmp, rank, world)
    first = exact_stats(cache, site)
    fn(ht, tmp, rank, world)
    return first + exact_stats(cache, site)
""" % (SITES,)

_PORT_SCRIPT = _DATA + _PORT_TRAINING + _SITES_RUN + """
def run(ht, rank, world):
    from heat_tpu_torch.core import program_cache
    import tempfile

    tmp = tempfile.mkdtemp()
    return {"site_" + s: np.array(drive_twice(ht, program_cache, s, tmp, rank, world))
            for s in SITE_LIST}
"""


@pytest.fixture(scope="module")
def port_ranks(tmp_path_factory):
    return spawn(tmp_path_factory.mktemp("sites"), 3, _PORT_SCRIPT, env={"HEAT_TPU_FSDP": "1"})


@pytest.fixture(scope="module")
def jax_drivers():
    ns = {"ht_jax": ht_tpu}
    exec(_DATA + _JAX_TRAINING + _SITES_RUN, ns)
    return ns


def _moved_as_pinned(stats, who):
    m1, h1, m2, h2 = (int(v) for v in stats)
    assert m1 >= 1, f"{who}: the first call missed nothing"
    assert m2 == m1, f"{who}: the second call missed again ({m1} -> {m2})"
    assert h2 > h1, f"{who}: the second call hit nothing"


@pytest.mark.parametrize("site", SITES)
def test_site_misses_then_hits_in_both_packages(site, port_ranks, jax_drivers, tmp_path,
                                                monkeypatch):
    for rank, r in enumerate(port_ranks):
        _moved_as_pinned(r["site_" + site], f"port rank {rank}")
    monkeypatch.setenv("HEAT_TPU_FSDP", "1")
    stats = jax_drivers["drive_twice"](ht_tpu, jax_cache, site, tmp_path, 0, 1)
    _moved_as_pinned(stats, "heat_tpu")


# -- fault injection, as tests/test_resilience.py pins it for heat_tpu ---------------------


@pytest.fixture
def cpu_world(monkeypatch):
    htt.use_device("cpu")
    monkeypatch.delenv("HEAT_TPU_RETRIES", raising=False)
    yield
    faults.clear()
    jax_faults.clear()
    resilience.refresh()
    jax_resilience.refresh()
    htt.use_device(None)


def _packages():
    return [(htt, resilience, faults), (ht_tpu, jax_resilience, jax_faults)]


@pytest.mark.parametrize("which", ["port", "heat_tpu"])
def test_relayout_fault_is_retried_to_the_same_bits(which, cpu_world, monkeypatch):
    ht, res, _ = _packages()[which != "port"]
    monkeypatch.setenv("HEAT_TPU_RETRIES", "3")
    res.refresh()
    data = np.random.default_rng(3).standard_normal((19, 6)).astype(np.float32)
    a = ht.array(data, split=0)
    want = a.resplit(1).numpy()
    rule = res.inject(site="relayout", kind="resource", calls=(1,))
    got = a.resplit(1).numpy()
    assert rule.fired == 1
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("which", ["port", "heat_tpu"])
def test_relayout_fault_escalates_with_its_attempts(which, cpu_world, monkeypatch):
    ht, res, _ = _packages()[which != "port"]
    monkeypatch.setenv("HEAT_TPU_RETRIES", "1")
    res.refresh()
    res.inject(site="relayout", kind="reset", p=1.0)
    a = ht.array(np.ones((8, 4), np.float32), split=0)
    with pytest.raises(res.HeatTpuRuntimeError) as ei:
        a.resplit(1)
    assert ei.value.site == "relayout"
    assert len(ei.value.attempts) == 2


@pytest.mark.parametrize("which", ["port", "heat_tpu"])
def test_relayout_fault_raises_without_retries(which, cpu_world):
    ht, res, _ = _packages()[which != "port"]
    res.refresh()
    res.inject(site="relayout", kind="resource", calls=(1,))
    with pytest.raises(res.HeatTpuRuntimeError):
        ht.array(np.ones((8, 4), np.float32), split=0).resplit(1)


def _spd(ht):
    rng = np.random.default_rng(0)
    n = 32
    m = rng.standard_normal((n, n))
    A = ht.array((m @ m.T + n * np.eye(n)).astype(np.float32), split=0)
    b = ht.array(rng.standard_normal(n).astype(np.float32))
    return A, b, ht.zeros(n, dtype=ht.float32)


@pytest.mark.parametrize("which", ["port", "heat_tpu"])
def test_cg_killed_at_its_second_window_resumes_bit_for_bit(which, cpu_world, tmp_path):
    ht, res, flt = _packages()[which != "port"]
    A, b, x0 = _spd(ht)
    path = str(tmp_path / "cg")
    base = ht.linalg.cg(A, b, x0)
    res.inject(site="cg_chunk", kind="resource", calls=(2,))
    with pytest.raises(res.HeatTpuRuntimeError):
        ht.linalg.cg(A, b, x0, checkpoint_every=5, checkpoint_path=path)
    flt.clear()
    _, extra = res.load_checkpoint(path, with_extra=True)
    assert extra["algo"] == "cg" and extra["it"] == 5
    resumed = ht.linalg.cg(A, b, x0, checkpoint_every=5, checkpoint_path=path, resume=True)
    np.testing.assert_array_equal(resumed.numpy(), base.numpy())


@pytest.mark.parametrize("which", ["port", "heat_tpu"])
def test_lanczos_killed_at_its_second_window_resumes_bit_for_bit(which, cpu_world, tmp_path):
    ht, res, flt = _packages()[which != "port"]
    A, _, _ = _spd(ht)
    path = str(tmp_path / "lz")
    Vb, Tb = ht.linalg.lanczos(A, 10)
    res.inject(site="lanczos_chunk", kind="resource", calls=(2,))
    with pytest.raises(res.HeatTpuRuntimeError):
        ht.linalg.lanczos(A, 10, checkpoint_every=4, checkpoint_path=path)
    flt.clear()
    V, T = ht.linalg.lanczos(A, 10, checkpoint_every=4, checkpoint_path=path, resume=True)
    np.testing.assert_array_equal(V.numpy(), Vb.numpy())
    np.testing.assert_array_equal(T.numpy(), Tb.numpy())


def test_port_cg_resume_equals_the_jax_packages_checkpointed_solve(cpu_world, tmp_path):
    A, b, x0 = _spd(htt)
    JA, jb, jx0 = _spd(ht_tpu)
    mine = htt.linalg.cg(A, b, x0, checkpoint_every=5, checkpoint_path=str(tmp_path / "a"))
    theirs = ht_tpu.linalg.cg(JA, jb, jx0, checkpoint_every=5,
                              checkpoint_path=str(tmp_path / "b"))
    np.testing.assert_allclose(mine.numpy(), theirs.numpy(), rtol=1e-4, atol=1e-5)


# -- the is_split gather in the collective audit -------------------------------------------

_AUDIT_SCRIPT = """
LENS = (4, 2, 1)


def run(ht, rank, world):
    from heat_tpu_torch import telemetry

    data = np.arange(7 * 3, dtype=np.float32).reshape(7, 3)
    lo = sum(LENS[:rank])
    block = data[lo:lo + LENS[rank]]
    got, rec = telemetry.hlo.audit_call("is_split_gather",
                                        lambda: ht.array(block, is_split=0))
    kinds = [c.op for c in rec.audit.collectives]
    return {"chunk": got.larray.numpy(), "whole": got.numpy(),
            "gathers": np.array(sum(1 for k in kinds if "all-gather" in k))}
"""


def test_is_split_gather_is_in_the_collective_audit(tmp_path):
    ranks = spawn(tmp_path, 3, _AUDIT_SCRIPT)
    whole = np.arange(21, dtype=np.float32).reshape(7, 3)
    for rank, r in enumerate(ranks):
        assert int(r["gathers"]) >= 1, rank
        np.testing.assert_array_equal(r["whole"], whole)
        np.testing.assert_array_equal(r["chunk"], whole[[0, 3, 6][rank]:[3, 6, 7][rank]])


# -- in-place steps are never applied twice -------------------------------------------------


def _net_and_grads():
    torch.manual_seed(0)
    net = torch.nn.Linear(3, 2)
    grads = {n: torch.full_like(p, 0.5) for n, p in net.named_parameters()}
    return net, grads


def _one_step_reference():
    net, grads = _net_and_grads()
    htt.optim.DataParallelOptimizer(torch.optim.SGD(net.parameters(), lr=0.1)).step(
        net, None, grads)
    return [p.detach().clone() for p in net.parameters()]


def test_an_injected_fault_before_the_step_is_retried_once(cpu_world, monkeypatch):
    want = _one_step_reference()
    monkeypatch.setenv("HEAT_TPU_RETRIES", "3")
    resilience.refresh()
    rule = resilience.inject(site="dp_optimizer_step", kind="resource", calls=(1,))
    net, grads = _net_and_grads()
    htt.optim.DataParallelOptimizer(torch.optim.SGD(net.parameters(), lr=0.1)).step(
        net, None, grads)
    assert rule.fired == 1
    for p, w in zip(net.parameters(), want):
        assert torch.equal(p.detach(), w)


class _FailsOnceAfterStepping(torch.optim.SGD):
    """An optimizer whose first step updates the parameters, then fails as
    a card out of memory would."""

    failed = False

    def step(self, closure=None):
        out = super().step(closure)
        if not _FailsOnceAfterStepping.failed:
            _FailsOnceAfterStepping.failed = True
            raise RuntimeError("CUDA out of memory (after the update)")
        return out


def test_a_fault_while_the_step_runs_is_not_retried(cpu_world, monkeypatch):
    want = _one_step_reference()
    monkeypatch.setenv("HEAT_TPU_RETRIES", "3")
    resilience.refresh()
    _FailsOnceAfterStepping.failed = False
    net, grads = _net_and_grads()
    opt = htt.optim.DataParallelOptimizer(_FailsOnceAfterStepping(net.parameters(), lr=0.1))
    with pytest.raises(resilience.HeatTpuRuntimeError) as ei:
        opt.step(net, None, grads)
    assert ei.value.site == "dp_optimizer_step" and len(ei.value.attempts) == 1
    for p, w in zip(net.parameters(), want):  # applied once, not twice
        assert torch.equal(p.detach(), w)


def test_a_functional_program_is_still_retried(cpu_world, monkeypatch):
    monkeypatch.setenv("HEAT_TPU_RETRIES", "2")
    resilience.refresh()
    calls = []

    def flaky(x):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("CUDA out of memory")
        return x + 1

    program_cache.reset()
    fn = program_cache.cached_program("test.flaky", (), lambda: flaky, inline=True)
    assert torch.equal(fn(torch.zeros(2)), torch.ones(2)) and len(calls) == 2


# -- one program for every penalty -------------------------------------------------------------


def test_lasso_fits_at_three_penalties_share_one_program_and_parameter_set(cpu_world):
    """``streaming.lasso`` is keyed on the design's shape and type, as the JAX
    package keys it: a regularisation path over three penalties builds one
    program with one parameter set, and each fit still equals a fit from an
    empty registry bit for bit."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((40, 6)).astype(np.float32)
    y = (x @ rng.standard_normal(6) + 0.3).astype(np.float32)
    lams = (0.3, 0.05, 0.01)
    fresh = []
    for lam in lams:
        program_cache.reset()
        fresh.append(htt.regression.Lasso(lam=lam, max_iter=6, tol=0.0).fit(
            htt.array(x, split=0), htt.array(y, split=0)).theta.numpy())
    program_cache.reset()
    path = [htt.regression.Lasso(lam=lam, max_iter=6, tol=0.0).fit(
        htt.array(x, split=0), htt.array(y, split=0)).theta.numpy() for lam in lams]
    assert program_cache.site_stats("streaming.lasso") == {"hits": 2, "misses": 1}
    sets = [k for k in program_cache._SHARED.keys() if k[0] == "streaming.lasso"]
    assert len(sets) == 1
    for got, want in zip(path, fresh):
        np.testing.assert_array_equal(got, want)
    assert not np.array_equal(path[0], path[2])  # the penalty reached the program
