"""``heat_tpu_torch.serve`` against ``heat_tpu.serve`` on the CPU.

Data: seeded numpy blobs (4 centers 8 apart in 12 columns, unit noise), so
that no query row is a near tie between two labels. The JAX package's
estimators are fitted on them; their endpoints' parameters are carried into
the port as numpy arrays (``_carry``), and both packages' ``Server`` serve
the same payloads.

- Parity: KMeans, KNN and GaussianNB labels equal; cdist, rbf, Lasso, the
  dense and the sparse forwards within 1e-5 relative and absolute (f32:
  the port's exact forms sum by a halving tree, the JAX package's in XLA's
  order); GaussianNB's joint log-likelihood order is float64 on both sides.
  The port's adapters over the port's own estimators answer as those
  estimators' ``predict``.
- The port's contracts: a request inside a padded bucket is the same bits
  as alone, for every kind, in exact mode; the fast forms (TF32 off, the
  flag restored) agree with the exact ones within f32 rounding; warm-up
  builds one program a bucket and the steady state builds nothing; a
  re-warm and a same-shape ``publish`` are all hits with 0 builds; the
  queue sheds 503, the budget degrades and then sheds; an injected
  transient fault retries with the same bits, an exhausted one fails its
  batch and the server recovers; ``save``/``restore`` bit for bit, a
  foreign checkpoint refused, a corrupt blob detected; a checkpoint written
  by the JAX package's ``Server.save`` restores in the port and answers as
  the carried endpoints do (and the reverse restores in the JAX package).
- ``LatencyHistogram`` and the trace sampling draw equal the JAX package's.
"""

import numpy as np
import pytest
import torch

import heat_tpu as ht_tpu
from heat_tpu.serve import Server as JaxServer
from heat_tpu.serve import tracing as jax_tracing
from heat_tpu.serve.metrics import LatencyHistogram as JaxHistogram
from heat_tpu.sparse.host import CsrRows as JaxCsrRows

import heat_tpu_torch as htt
from heat_tpu_torch import resilience, serve, telemetry
from heat_tpu_torch.core import program_cache
from heat_tpu_torch.serve import (AdmissionController, Endpoint, Server, ServerClosedError,
                                  ServerOverloadedError, tracing)
from heat_tpu_torch.serve.metrics import LatencyHistogram
from heat_tpu_torch.sparse.host import CsrRows

F = 12
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def on_cpu():
    htt.use_device("cpu")
    yield
    htt.use_device(None)


@pytest.fixture()
def rng():
    return np.random.default_rng(42)


def _blobs(rng, n):
    protos = np.random.default_rng(7).standard_normal((4, F)) * 8
    ids = rng.integers(0, 4, n)
    return (protos[ids] + rng.standard_normal((n, F))).astype(np.float32), ids


@pytest.fixture(scope="module")
def fitted():
    """Both packages' estimators on the same blobs (read-only inputs)."""
    rng = np.random.default_rng(7)
    xn, ids = _blobs(rng, 96)
    yn = (xn @ rng.standard_normal(F) + 0.2).astype(np.float32)
    labels = (ids % 2).astype(np.int64)
    out = {"xn": xn}
    for tag, pkg in (("jax", ht_tpu), ("port", htt)):
        if tag == "port":
            htt.use_device("cpu")
        x = pkg.array(xn, split=0)
        y = pkg.array(yn, split=0)
        lab = pkg.array(labels, split=0)
        out[tag] = {
            "km": pkg.cluster.KMeans(n_clusters=4, max_iter=15, random_state=0).fit(x),
            "lasso": pkg.regression.Lasso(lam=0.05, max_iter=10).fit(x, y),
            "gnb": pkg.naive_bayes.GaussianNB().fit(x, lab),
            "knn": pkg.classification.KNeighborsClassifier(n_neighbors=3).fit(x, lab),
        }
    htt.use_device(None)
    return out


def _jax_endpoints(fitted, rng):
    """Every kind through the JAX package's adapters."""
    w = np.random.default_rng(3).standard_normal((F, 6)).astype(np.float32)
    b = np.random.default_rng(4).standard_normal(6).astype(np.float32)
    ref = fitted["xn"][:20]
    j = fitted["jax"]
    return {
        "km": ht_tpu.serve.kmeans_predict(j["km"]),
        "knn": ht_tpu.serve.knn_classify(j["knn"]),
        "gnb": ht_tpu.serve.gaussian_nb_predict(j["gnb"]),
        "lasso": ht_tpu.serve.lasso_predict(j["lasso"]),
        "cdist": ht_tpu.serve.cdist_query(ref),
        "rbf": ht_tpu.serve.rbf_query(ref, sigma=2.0),
        "dense": ht_tpu.serve.dense_forward(w, b, activation="sigmoid"),
        "sparse": ht_tpu.serve.sparse_query(w, b, activation="relu"),
    }


def _carry(jep, **kw) -> Endpoint:
    """A JAX endpoint's fitted parameters carried into the port as numpy."""
    return Endpoint(jep.kind, [np.asarray(p) for p in jep.params], dict(jep.config),
                    features=jep.features, dtype=jep.dtype, version=jep.version, **kw)


def _payload(rng, name, ep, rows):
    q, _ = _blobs(rng, rows)
    q = q.astype(ep.dtype)
    if name == "sparse":
        q[rng.random(q.shape) < 0.6] = 0
    return q


def _mk(cls, **kw):
    kw.setdefault("max_batch", 8)
    kw.setdefault("max_wait_ms", 1.0)
    return cls(**kw)


KINDS = ["km", "knn", "gnb", "lasso", "cdist", "rbf", "dense", "sparse"]
LABELS = {"km", "knn", "gnb"}


# -- parity with the JAX package -----------------------------------------------------


@pytest.mark.parametrize("name", KINDS)
def test_every_kind_answers_as_the_jax_package(fitted, rng, name):
    jep = _jax_endpoints(fitted, rng)[name]
    payloads = [_payload(rng, name, jep, r) for r in (1, 5, 11)]
    with _mk(JaxServer) as js, _mk(Server) as ps:
        js.register(name, jep)
        ps.register(name, _carry(jep, device="cpu"))
        for q in payloads:
            want, got = np.asarray(js.predict(name, q)), ps.predict(name, q)
            assert got.dtype == want.dtype and got.shape == want.shape
            if name in LABELS:
                np.testing.assert_array_equal(got, want)
            else:
                np.testing.assert_allclose(got, want, **TOL)


def test_sparse_csr_payloads_of_both_packages(fitted, rng):
    jep = _jax_endpoints(fitted, rng)["sparse"]
    q = _payload(rng, "sparse", jep, 6)
    mine = CsrRows.from_dense(q)
    theirs = JaxCsrRows.from_dense(q)
    with _mk(JaxServer) as js, _mk(Server) as ps:
        js.register("s", jep)
        ps.register("s", _carry(jep, device="cpu"))
        want = np.asarray(js.predict("s", theirs))
        got = ps.predict("s", mine)
        np.testing.assert_allclose(got, want, **TOL)
        np.testing.assert_array_equal(ps.predict("s", q), got)  # dense rows compact the same
        with pytest.raises(ValueError, match="features"):
            ps.submit("s", CsrRows.from_dense(np.ones((2, 5), np.float32)))


@pytest.mark.parametrize("name", ["km", "knn", "gnb", "lasso"])
def test_adapters_over_the_ports_estimators(fitted, rng, name):
    est = fitted["port"][name]
    adapter = {"km": serve.kmeans_predict, "knn": serve.knn_classify,
               "gnb": serve.gaussian_nb_predict, "lasso": serve.lasso_predict}[name]
    ep = adapter(est)
    q = _payload(rng, name, ep, 7)
    with _mk(Server) as ps:
        ps.register(name, ep)
        got = ps.predict(name, q)
    want = est.predict(htt.array(q)).numpy().reshape(got.shape)
    if name in LABELS:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **TOL)


def test_cdist_rbf_dense_adapters_against_the_ports_functions(fitted, rng):
    ref = fitted["xn"][:20]
    w = rng.standard_normal((F, 6)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    q = rng.standard_normal((4, F)).astype(np.float32)
    with _mk(Server) as ps:
        ps.register("c", serve.cdist_query(ref))
        ps.register("r", serve.rbf_query(htt.array(ref), sigma=2.0))
        ps.register("d", serve.dense_forward(w, b, activation="tanh"))
        got = {k: ps.predict(k, q) for k in "crd"}
    np.testing.assert_allclose(got["c"], htt.spatial.cdist(htt.array(q), htt.array(ref)).numpy(),
                               **TOL)
    np.testing.assert_allclose(
        got["r"], htt.spatial.rbf(htt.array(q), htt.array(ref), sigma=2.0).numpy(), **TOL)
    np.testing.assert_allclose(got["d"], np.tanh(q @ w + b), **TOL)


def test_payload_contracts(fitted, rng):
    jeps = _jax_endpoints(fitted, rng)
    with _mk(Server) as ps:
        ps.register("km", _carry(jeps["km"]))
        ps.register("c", _carry(jeps["cdist"]))
        assert ps.predict("km", np.empty((0, F), np.float32)).shape == (0,)
        assert ps.predict("c", np.empty((0, F), np.float32)).shape == (0, 20)
        assert ps.predict("km", rng.standard_normal(F).astype(np.float32)).shape == ()
        with pytest.raises(ValueError, match="expects"):
            ps.submit("km", np.zeros((3, 5), np.float32))
        with pytest.raises(ValueError, match="unknown endpoint"):
            ps.submit("nope", np.zeros((1, F), np.float32))
        assert ps.stats()["endpoints"]["km"]["errors"] == 0
    with pytest.raises(ValueError, match="not fitted"):
        serve.kmeans_predict(htt.cluster.KMeans(n_clusters=2))
    with pytest.raises(ValueError, match="unknown endpoint kind"):
        Endpoint("nope", [], features=1, dtype=np.float32)
    with pytest.raises(ValueError, match="activation"):
        serve.dense_forward(np.ones((2, 2), np.float32), activation="gelu")


def test_endpoints_default_to_the_card(fitted):
    htt.use_device(None)
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.cdist_query(fitted["xn"][:4])
    assert serve.cdist_query(fitted["xn"][:4], device="cpu").device == torch.device("cpu")


# -- the port's own contracts ----------------------------------------------------------


@pytest.mark.parametrize("name", KINDS)
def test_batched_equals_solo_bit_for_bit(fitted, rng, name):
    ep = _carry(_jax_endpoints(fitted, rng)[name])
    payloads = [_payload(rng, name, ep, r) for r in (1, 2, 3, 1, 5)]
    with _mk(Server, max_wait_ms=30.0) as ps:
        ps.register("e", ep)
        ps.warmup()
        solo = [np.asarray(ps.predict("e", p)) for p in payloads]
        futs = [ps.submit("e", p) for p in payloads]
        batched = [np.asarray(f.result(30)) for f in futs]
        assert ps.stats()["endpoints"]["e"]["batches"] < 2 * len(payloads)
    for s, b in zip(solo, batched):
        assert s.tobytes() == b.tobytes(), "a padded batch changed the bits"


@pytest.mark.parametrize("name", ["km", "knn", "cdist", "rbf", "dense"])
def test_tiles_of_the_exact_forms_change_no_bit(fitted, rng, name, monkeypatch):
    ep = _carry(_jax_endpoints(fitted, rng)[name])
    call = ep.build()
    q = torch.from_numpy(_payload(rng, name, ep, 5))
    whole = call(q, *ep.params)
    monkeypatch.setattr(serve.endpoints, "_TILE_BYTES", 5 * F * 4 * 3)  # 3 rows a tile
    tiled = call(q, *ep.params)
    assert whole.shape == tiled.shape and whole.numpy().tobytes() == tiled.numpy().tobytes()


def test_an_endpoints_buckets_share_one_parameter_set(fitted, rng):
    jeps = _jax_endpoints(fitted, rng)
    with _mk(Server) as ps:
        ps.register("a", _carry(jeps["knn"]))
        ps.register("b", _carry(jeps["knn"]))
        ps.register("s", _carry(jeps["sparse"]))
        ps.warmup()
        eps = ps.endpoints()
        sets = {name: {id(ps._program(name, eps[name], b).__wrapped__.shared)
                       for b in ps.ladder} for name in ("a", "b")}
        sparse = {id(ps._program("s", eps["s"], b, c).__wrapped__.shared)
                  for b in ps.ladder for c in eps["s"].nnz_ladder(b)}
    assert len(sets["a"]) == len(sets["b"]) == len(sparse) == 1
    assert not sets["a"] & sets["b"]
    assert ps._program("a", eps["a"], 1).__wrapped__.params_from == 1


@pytest.mark.parametrize("name", ["km", "lasso", "cdist", "dense"])
def test_fast_forms_agree_and_keep_the_tf32_flag(fitted, rng, name, monkeypatch):
    jep = _jax_endpoints(fitted, rng)[name]
    exact = _carry(jep)
    monkeypatch.setenv("HEAT_TPU_SERVE_EXACT", "0")
    fast = Endpoint(jep.kind, exact.params, {k: v for k, v in jep.config.items() if k != "exact"},
                    features=jep.features, dtype=jep.dtype)
    assert fast.config["exact"] is False and exact.config["exact"] is True
    q = _payload(rng, name, exact, 9)
    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with _mk(Server) as ps:
            ps.register("x", exact)
            ps.register("f", fast)
            a, b = ps.predict("x", q), ps.predict("f", q)
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag
    if name == "km":
        np.testing.assert_array_equal(a, b)
    else:
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)


def test_micro_batching_coalesces_and_segments(fitted, rng):
    jeps = _jax_endpoints(fitted, rng)
    with _mk(Server, max_batch=16, max_wait_ms=25.0) as ps:
        ps.register("km", _carry(jeps["km"]))
        ps.register("l", _carry(jeps["lasso"]))
        ps.warmup()
        futs = [ps.submit("km", _payload(rng, "km", jeps["km"], 1)) for _ in range(12)]
        for f in futs:
            f.result(30)
        st = ps.stats()["endpoints"]["km"]
        assert st["requests"] == 12 and st["batches"] < 12 and st["latency"]["count"] == 12
        mixed = [("km" if i % 2 else "l", ps.submit("km" if i % 2 else "l",
                                                   _payload(rng, "km", jeps["km"], 2)))
                 for i in range(10)]
        for _, f in mixed:
            assert f.result(30).shape[0] == 2


def test_oversized_request_chunks(fitted, rng):
    ep = _carry(_jax_endpoints(fitted, rng)["km"])
    q = _payload(rng, "km", ep, 21)
    with _mk(Server, max_batch=8) as ps:
        ps.register("km", ep)
        got = ps.predict("km", q)
    with _mk(Server, max_batch=32) as ps:
        ps.register("km", ep)
        assert got.tobytes() == ps.predict("km", q).tobytes()


def test_steady_state_builds_nothing(fitted, rng):
    jeps = _jax_endpoints(fitted, rng)
    program_cache.reset()  # earlier tests built some of these programs
    with _mk(Server) as ps:
        ps.register("km", _carry(jeps["km"]))
        ps.register("s", _carry(jeps["sparse"]))
        rep = ps.warmup()
        sparse_programs = sum(len(ps.endpoints()["s"].nnz_ladder(b)) for b in ps.ladder)
        assert rep["programs"] == len(ps.ladder) + sparse_programs
        assert rep["backend_compiles"] == rep["programs"]
        before = program_cache.site_stats("serve.")
        with telemetry.CompileWatcher() as cw:
            futs = [ps.submit("km" if i % 2 else "s", _payload(rng, "sparse", jeps["km"], 1 + i % 4))
                    for i in range(30)]
            for f in futs:
                f.result(30)
        after = program_cache.site_stats("serve.")
    assert after["misses"] == before["misses"], "the steady state built a program"
    assert cw.backend_compiles == 0 and after["hits"] > before["hits"]


def test_rewarm_and_same_shape_publish_build_nothing(fitted, rng):
    jeps = _jax_endpoints(fitted, rng)
    ep = _carry(jeps["km"])
    q = _payload(rng, "km", ep, 6)
    with _mk(Server, max_batch=4) as ps:
        ps.register("km", ep)
        ps.warmup()
        first = ps.predict("km", q)
        before = program_cache.site_stats("serve.")
        assert ps.warmup()["backend_compiles"] == 0
        shifted = ep.with_params([ep.params[0] + 100.0])
        out = ps.publish("km", shifted)
        assert (out["version"], out["backend_compiles"]) == (2, 0)
        assert program_cache.site_stats("serve.")["misses"] == before["misses"]
        with telemetry.CompileWatcher() as cw:
            moved = ps.predict("km", q)
            back = ps.publish("km", ep.with_params(ep.params, version=7))
            again = ps.predict("km", q)
        assert cw.backend_compiles == 0 and back["version"] == 7
        assert ps.endpoint_version("km") == 7 and ps.stats()["versions"] == {"km": 7}
    centers = ep.params[0].numpy() + 100.0
    want = np.argmin(((q[:, None, :] - centers[None]) ** 2).sum(-1), axis=1)
    np.testing.assert_array_equal(moved, want)
    assert again.tobytes() == first.tobytes()
    with pytest.raises(ValueError, match="same parameter shapes"):
        ep.with_params([np.zeros((3, F), np.float32)])


def test_queue_full_sheds_503(fitted, rng, monkeypatch):
    ep = _carry(_jax_endpoints(fitted, rng)["km"])
    srv = _mk(Server, queue_max=3)
    monkeypatch.setattr(Server, "_ensure_thread", lambda self: None)
    srv.register("km", ep)
    futs = [srv.submit("km", _payload(rng, "km", ep, 1)) for _ in range(3)]
    with pytest.raises(ServerOverloadedError) as ei:
        srv.submit("km", _payload(rng, "km", ep, 1))
    assert (ei.value.status, ei.value.reason) == (503, "queue_full")
    assert srv.admission.sheds == 1 and srv.stats()["endpoints"]["km"]["shed"] == 1
    monkeypatch.undo()
    srv._ensure_thread()
    for f in futs:
        f.result(30)
    srv.close()


def test_budget_degrades_then_sheds(monkeypatch):
    ep = Endpoint("dense_forward", [np.zeros((4, 2), np.float32)],
                  {"bias": False, "activation": None}, features=4, dtype=np.float32)
    ladder = [1, 2, 4, 8]
    ctl = AdmissionController(queue_max=100, measured_cost=lambda name, b: b * 100, live_ttl=0.0)
    target = "heat_tpu_torch.resilience.memory_guard.headroom"
    monkeypatch.setattr(target, lambda: (250, 0))
    ctl.admit("d", ep, rows=8, queue_depth=0, ladder=ladder)
    assert ctl.bucket_cap(ladder) == 2 and ctl.degrades == 1
    monkeypatch.setattr(target, lambda: (50, 0))
    with pytest.raises(ServerOverloadedError) as ei:
        ctl.admit("d", ep, rows=1, queue_depth=0, ladder=ladder)
    assert ei.value.reason == "memory"
    monkeypatch.setattr(target, lambda: (10_000, 0))
    ctl.admit("d", ep, rows=1, queue_depth=0, ladder=ladder)
    assert ctl.bucket_cap(ladder) == 8


def test_budget_uses_the_warm_builds_bytes(fitted, rng, monkeypatch):
    ep = _carry(_jax_endpoints(fitted, rng)["km"])
    monkeypatch.setenv("HEAT_TPU_HBM_BUDGET", "4G")
    resilience.refresh()
    try:
        with _mk(Server, max_batch=4) as ps:
            ps.register("km", ep)
            ps._measured[("km", 4)] = 12345
            assert ps.admission._measured_cost("km", 4) == 12345
            assert ps.admission._measured_cost("km", 2) is None
            ps.warmup()
            assert set(ps._measured) == {("km", b) for b in ps.ladder}
            assert all(ps._measured[("km", b)] == ep.cost_bytes(b) for b in ps.ladder)
            assert ps.predict("km", np.zeros((2, F), np.float32)).shape == (2,)
    finally:
        monkeypatch.undo()
        resilience.refresh()


def test_injected_fault_retries_per_batch(fitted, rng, monkeypatch):
    monkeypatch.setenv("HEAT_TPU_RETRIES", "2")
    monkeypatch.setenv("HEAT_TPU_RETRY_BASE", "0.001")
    ep = _carry(_jax_endpoints(fitted, rng)["rbf"])
    q = _payload(rng, "rbf", ep, 2)
    with _mk(Server) as ps:
        ps.register("r", ep)
        ps.warmup()
        clean = ps.predict("r", q)
        # the ladder is 1, 2, 4, 8: 4 warm-up calls and 1 predict, so the
        # 6th serve.r call is the next dispatch (calls count while armed,
        # and HEAT_TPU_RETRIES armed the package at the first refresh)
        resilience.refresh()
        rule = resilience.inject("serve.r", kind="reset", calls=[1])
        try:
            with telemetry.CompileWatcher() as cw:
                faulted = ps.predict("r", q)
        finally:
            resilience.clear_faults()
            monkeypatch.undo()
            resilience.refresh()
    assert rule.fired == 1 and cw.backend_compiles == 0
    assert faulted.tobytes() == clean.tobytes()


def test_exhausted_fault_fails_the_batch_and_recovers(fitted, rng, monkeypatch):
    monkeypatch.delenv("HEAT_TPU_RETRIES", raising=False)
    ep = _carry(_jax_endpoints(fitted, rng)["km"])
    q = _payload(rng, "km", ep, 2)
    with _mk(Server) as ps:
        ps.register("km", ep)
        ps.warmup()
        clean = ps.predict("km", q)
        resilience.inject("serve.km", kind="resource", calls=[1])
        try:
            with pytest.raises(resilience.HeatTpuRuntimeError):
                ps.submit("km", q).result(30)
        finally:
            resilience.clear_faults()
        again = ps.predict("km", q)
        assert ps.stats()["endpoints"]["km"]["errors"] == 1
    assert again.tobytes() == clean.tobytes()


def test_save_restore_bit_for_bit(fitted, rng, tmp_path):
    jeps = _jax_endpoints(fitted, rng)
    names = ["km", "lasso", "gnb", "knn", "sparse"]
    qs = {n: _payload(rng, n, jeps[n], 3) for n in names}
    path = str(tmp_path / "serve_ckpt")
    with _mk(Server, max_batch=4) as ps:
        for n in names:
            ps.register(n, _carry(jeps[n]))
        ps.warmup()
        before = {n: ps.predict(n, qs[n]) for n in names}
        ps.save(path)
    restored = Server.restore(path, max_batch=4, device="cpu")
    with restored:
        rep = restored.warmup()
        after = {n: restored.predict(n, qs[n]) for n in names}
    assert rep["backend_compiles"] == 0  # the same shapes re-enter the registry
    for n in names:
        assert after[n].tobytes() == before[n].tobytes(), n


def test_restore_refuses_foreign_and_corrupt_checkpoints(fitted, rng, tmp_path):
    import os

    path = str(tmp_path / "not_serve")
    resilience.save_checkpoint([np.arange(3)], path, extra={"algo": "kmeans"})
    with pytest.raises(resilience.CheckpointError, match="serve"):
        Server.restore(path)
    path = str(tmp_path / "ck")
    with _mk(Server) as ps:
        ps.register("km", _carry(_jax_endpoints(fitted, rng)["km"]))
        ps.save(path)
    blob = next(os.path.join(path, f) for f in sorted(os.listdir(path)) if f.endswith(".npy"))
    raw = bytearray(open(blob, "rb").read())
    raw[-1] ^= 0xFF
    open(blob, "wb").write(bytes(raw))
    with pytest.raises(resilience.CheckpointCorruptError):
        Server.restore(path)


def test_checkpoints_cross_between_the_packages(fitted, rng, tmp_path):
    jeps = _jax_endpoints(fitted, rng)
    qs = {n: _payload(rng, n, jeps[n], 4) for n in KINDS}
    jax_path, port_path = str(tmp_path / "jax"), str(tmp_path / "port")
    with _mk(JaxServer) as js:
        for n in KINDS:
            js.register(n, jeps[n])
        want = {n: np.asarray(js.predict(n, qs[n])) for n in KINDS}
        js.save(jax_path)
    with _mk(Server) as carried:
        for n in KINDS:
            carried.register(n, _carry(jeps[n]))
        same = {n: carried.predict(n, qs[n]) for n in KINDS}
    with Server.restore(jax_path, max_batch=8, device="cpu") as ps:
        got = {n: ps.predict(n, qs[n]) for n in KINDS}
        assert ps.stats()["versions"] == {n: 1 for n in KINDS}
        ps.save(port_path)
    for n in KINDS:
        assert got[n].tobytes() == same[n].tobytes(), n
        if n in LABELS:
            np.testing.assert_array_equal(got[n], want[n])
        else:
            np.testing.assert_allclose(got[n], want[n], **TOL)
    with JaxServer.restore(port_path, max_batch=8) as js:
        for n in KINDS:
            back = np.asarray(js.predict(n, qs[n]))
            assert back.tobytes() == want[n].tobytes(), n


def test_serving_counters(fitted, rng):
    reg = telemetry.get_registry()
    was = telemetry.enabled()
    saved = dict(reg.counters)
    reg.clear()
    telemetry.enable()
    try:
        with _mk(Server, max_wait_ms=5.0) as ps:
            ps.register("km", _carry(_jax_endpoints(fitted, rng)["km"]))
            ps.warmup()
            for f in [ps.submit("km", _payload(rng, "km", ps.endpoints()["km"], 1 + i % 2))
                      for i in range(10)]:
                f.result(30)
        assert reg.counters["serve.requests"] == 10
        assert reg.counters["serve.batches"] >= 1
        assert reg.counters["tracing.sampled"] == 10
        spans = {e["name"] for e in reg.events if e["kind"] == "trace_span"}
        assert {"serve.queue", "serve.coalesce", "serve.pad", "serve.execute",
                "serve.reply"} <= spans
        assert any(e["kind"] == "serve" and e.get("event") == "warmup" for e in reg.events)
    finally:
        if not was:
            telemetry.disable()
        reg.clear()
        reg.counters.update(saved)


def test_histogram_and_sampling_match_the_jax_package():
    vals = np.random.default_rng(0).exponential(0.01, 500)
    mine, theirs = LatencyHistogram(), JaxHistogram()
    for v in vals:
        mine.record(float(v))
        theirs.record(float(v))
    assert mine.snapshot() == theirs.snapshot()
    assert mine.raw() == theirs.raw()
    merged = LatencyHistogram.from_raw(theirs.raw()).merge(mine)
    assert merged.count == 1000
    assert LatencyHistogram().snapshot() == {"count": 0}
    for i in range(300):
        tid = f"{i * 7919:08x}{i:08x}"
        for rate in (0.0, 0.1, 0.5, 0.93, 1.0):
            assert tracing._sampled(tid, rate) == jax_tracing._sampled(tid, rate)
    assert tracing.HOPS == jax_tracing.HOPS


def test_lifecycle(fitted, rng, monkeypatch):
    ep = _carry(_jax_endpoints(fitted, rng)["km"])
    srv = _mk(Server)
    monkeypatch.setattr(Server, "_ensure_thread", lambda self: None)
    srv.register("km", ep)
    fut = srv.submit("km", _payload(rng, "km", ep, 1))
    monkeypatch.undo()
    srv.close()
    with pytest.raises(ServerClosedError):
        fut.result(5)
    with pytest.raises(ServerClosedError):
        srv.submit("km", _payload(rng, "km", ep, 1))
    srv.close()
    with _mk(Server) as ps:
        with pytest.raises(TypeError):
            ps.register("x", object())
        with pytest.raises(ValueError):
            ps.register("bad/name", ep)
        ps.register("km", ep)
        with pytest.raises(ValueError, match="replace=True"):
            ps.register("km", ep)
