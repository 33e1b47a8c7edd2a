"""``heat_tpu_torch.streaming`` against ``heat_tpu.streaming`` on the same
files.

Data: seeded numpy blobs (6 well separated centers in 8 columns) written as
two ``.npy`` files of 1000 and 777 rows, read in 7 chunks of 300 rows (the
chunking restarts at each file, so the last chunk of each file is short:
100 and 177 rows).

- ``ChunkStream``: chunk rows from the knob and from the budget, ``len``,
  ``skip_rows`` and the chunks' contents equal heat_tpu's.
- ``StreamingMoments``: after every chunk within 1e-6 of heat_tpu's (mean
  relative to the column's spread, M2 relative; the chunks' f32 moments are
  summed in other orders, the float64 carry adds no error of its own); one
  chunk equals ``chunk_moments`` bit for bit.
- ``MiniBatchKMeans``: the initial centers bit for bit; after every chunk
  the centers within 1e-5 (the blobs' spread is 8, so no row is a near tie:
  the same labels, sums in another order), the counts exactly and the
  inertia within 1e-5 relative of heat_tpu's.
- Resume: saved after chunk 5, restored and continued through
  ``ChunkStream(skip_rows=...)``, both estimators equal the uninterrupted
  stream bit for bit; a carry saved by heat_tpu, restored by the port and
  continued equals heat_tpu's own continuation within the same tolerances,
  and the reverse.
- ``rolling_update`` gives heat_tpu's steps on the same stub pool and
  router; ``EVENT_COUNTER`` and the events' counters are heat_tpu's.
- A fresh interpreter that imports the port and runs the streaming path
  holds no module of heat_tpu or jax.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

import heat_tpu as ht_tpu

import heat_tpu_torch as htt
from heat_tpu_torch import streaming, telemetry
from heat_tpu_torch.core.statistics import chunk_moments

REPO = Path(__file__).resolve().parent.parent
ROWS = (1000, 777)
CHUNK = 300
K = 6


@pytest.fixture(autouse=True)
def on_cpu():
    htt.use_device("cpu")
    yield
    htt.use_device(None)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    rng = np.random.default_rng(0)
    protos = (rng.standard_normal((K, 8)) * 8).astype(np.float32)
    d = tmp_path_factory.mktemp("stream")
    paths = []
    for i, n in enumerate(ROWS):
        x = (protos[rng.integers(0, K, n)] + rng.standard_normal((n, 8))).astype(np.float32)
        path = str(d / f"part{i}.npy")
        np.save(path, x)
        paths.append(path)
    return paths


# -- ChunkStream ------------------------------------------------------------------


@pytest.mark.parametrize("skip", [0, 300, 1000, 1300, 1777])
def test_chunk_stream_len_skip_and_contents(files, skip):
    mine = streaming.ChunkStream(files, chunk_rows=CHUNK, skip_rows=skip)
    theirs = ht_tpu.streaming.ChunkStream(files, chunk_rows=CHUNK, skip_rows=skip)
    assert len(mine) == len(theirs)
    assert (mine.nrows(), mine.load_all_bytes(), mine.chunk_bytes()) == \
        (theirs.nrows(), theirs.load_all_bytes(), theirs.chunk_bytes())
    got = list(mine)
    want = list(theirs)
    assert len(got) == len(want) == len(mine)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.split == w.split == 0
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    assert mine.rows_read == theirs.rows_read == 1777 - skip


@pytest.mark.parametrize("budget,knob", [(None, None), ("64K", None), ("1G", None),
                                         ("64K", "500"), (None, "4096")])
def test_chunk_rows_from_the_budget_and_the_knob(files, monkeypatch, budget, knob):
    for name, value in (("HEAT_TPU_HBM_BUDGET", budget), ("HEAT_TPU_STREAM_CHUNK_ROWS", knob)):
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)
    mine = streaming.ChunkStream(files)
    theirs = ht_tpu.streaming.ChunkStream(files)
    assert mine.chunk_rows == theirs.chunk_rows and len(mine) == len(theirs)


def test_chunk_stream_rejects_what_jax_rejects(files, tmp_path):
    other = str(tmp_path / "other.npy")
    np.save(other, np.zeros((5, 3), np.float32))
    for kwargs in ({"paths": []}, {"paths": files + [other]},
                   {"paths": files, "skip_rows": 5000}, {"paths": files, "chunk_rows": -1}):
        with pytest.raises(ValueError):
            ht_tpu.streaming.ChunkStream(**kwargs)
        with pytest.raises(ValueError):
            streaming.ChunkStream(**kwargs)


def test_chunk_stream_resplit_and_hdf5(files, tmp_path):
    x = np.load(files[0])
    h5 = str(tmp_path / "x.h5")
    htt.save_hdf5(htt.array(x), h5, "d")
    for path, kw in ((files[0], {}), (h5, {"dataset": "d"})):
        got = list(streaming.ChunkStream(path, chunk_rows=CHUNK, resplit=1, **kw))
        want = list(ht_tpu.streaming.ChunkStream(path, chunk_rows=CHUNK, resplit=1, **kw))
        for g, w in zip(got, want):
            assert g.split == w.split == 1
            np.testing.assert_array_equal(g.numpy(), w.numpy())


def test_chunk_events_and_watermark(files):
    reg = telemetry.get_registry()
    reg.clear()
    telemetry.enable()
    try:
        list(streaming.ChunkStream(files, chunk_rows=CHUNK))
        snap = reg.snapshot()
        events = [e for e in reg.events if e.get("event") == "stream_chunk"]
    finally:
        telemetry.disable()
        reg.clear()
    assert snap["counters"]["streaming.chunks"] == 7
    assert snap["counters"]["streaming.rows"] == 1777
    assert snap["watermarks"]["streaming.chunk_bytes"] == CHUNK * 8 * 4
    assert [(e["start"], e["stop"]) for e in events][:5] == [
        (0, 300), (300, 600), (600, 900), (900, 1000), (0, 300)]


def test_event_counter_is_the_jax_packages():
    assert streaming.EVENT_COUNTER == ht_tpu.streaming.EVENT_COUNTER


# -- StreamingMoments ----------------------------------------------------------------


def test_streaming_moments_match_jax_chunk_by_chunk(files):
    mine, theirs = streaming.StreamingMoments(ddof=1), ht_tpu.streaming.StreamingMoments(ddof=1)
    for g, w in zip(streaming.ChunkStream(files, chunk_rows=CHUNK),
                    ht_tpu.streaming.ChunkStream(files, chunk_rows=CHUNK)):
        mine.partial_fit(g)
        theirs.partial_fit(w)
        assert mine.n_seen == theirs.n_seen and mine.chunks_seen == theirs.chunks_seen
        spread = np.abs(theirs.mean) + theirs.std()
        assert float(np.max(np.abs(mine.mean - theirs.mean) / spread)) <= 1e-6
        assert float(np.max(np.abs(mine._m2 - theirs._m2) / theirs._m2)) <= 1e-6
    whole = np.concatenate([np.load(p) for p in files]).astype(np.float64)
    np.testing.assert_allclose(mine.var(), whole.var(0, ddof=1), rtol=1e-6)
    np.testing.assert_allclose(mine.std(0), whole.std(0), rtol=1e-6)


def test_one_chunk_equals_chunk_moments(files):
    chunk = htt.load_npy(files[1], split=0)
    n, mu, m2 = chunk_moments(chunk)
    est = streaming.StreamingMoments().partial_fit(chunk)
    assert est.n_seen == n
    np.testing.assert_array_equal(est.mean, mu.numpy().astype(np.float64))
    np.testing.assert_array_equal(est._m2, m2.numpy().astype(np.float64))


def test_streaming_moments_merge_and_errors(files):
    a, b = streaming.StreamingMoments(), streaming.StreamingMoments()
    chunks = list(streaming.ChunkStream(files, chunk_rows=CHUNK))
    for c in chunks[:4]:
        a.partial_fit(c)
    for c in chunks[4:]:
        b.partial_fit(c)
    merged = streaming.StreamingMoments().merge(a).merge(b)
    whole = np.concatenate([np.load(p) for p in files]).astype(np.float64)
    np.testing.assert_allclose(merged.mean, whole.mean(0), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(merged.var(), whole.var(0), rtol=1e-6)
    assert merged.chunks_seen == 7
    with pytest.raises(RuntimeError):
        streaming.StreamingMoments().mean
    with pytest.raises(ValueError):
        a.partial_fit(htt.array(np.zeros((3, 2), np.float32)))
    with pytest.raises(RuntimeError):
        streaming.StreamingMoments().save("unused")


# -- MiniBatchKMeans ------------------------------------------------------------------


@pytest.mark.parametrize("init,decay", [("random", 1.0), ("probability_based", 0.9)])
def test_minibatch_kmeans_matches_jax_chunk_by_chunk(files, init, decay):
    kw = dict(n_clusters=K, init=init, inner_iter=3, decay=decay, random_state=4)
    mine, theirs = streaming.MiniBatchKMeans(**kw), ht_tpu.streaming.MiniBatchKMeans(**kw)
    first = htt.load_npy(files[0], split=0, chunks=(0, CHUNK))
    first_jax = ht_tpu.load_npy(files[0], split=0, chunks=(0, CHUNK))
    np.testing.assert_array_equal(mine._initialize_cluster_centers(first).numpy(),
                                  np.asarray(theirs._initialize_cluster_centers(first_jax)))
    for g, w in zip(streaming.ChunkStream(files, chunk_rows=CHUNK),
                    ht_tpu.streaming.ChunkStream(files, chunk_rows=CHUNK)):
        mine.partial_fit(g)
        theirs.partial_fit(w)
        np.testing.assert_allclose(mine._centers_np, theirs._centers_np, rtol=0, atol=1e-5)
        np.testing.assert_allclose(mine._counts_np, theirs._counts_np, rtol=1e-7)
        assert abs(mine.inertia_ - theirs._inertia) <= 1e-5 * theirs._inertia
        assert (mine.chunks_seen, mine.rows_seen) == (theirs.chunks_seen, theirs.rows_seen)
    np.testing.assert_allclose(mine.cluster_centers_.numpy(), theirs.cluster_centers_.numpy(),
                               rtol=0, atol=1e-5)
    labels = mine.predict(htt.load_npy(files[1]))
    want = theirs.predict(ht_tpu.load_npy(files[1]))
    np.testing.assert_array_equal(labels.numpy(), want.numpy())


def test_minibatch_kmeans_arguments():
    with pytest.raises(ValueError):
        streaming.MiniBatchKMeans(decay=0.0)
    est = streaming.MiniBatchKMeans(n_clusters=2)
    with pytest.raises(TypeError):
        est.partial_fit(np.zeros((4, 2)))
    with pytest.raises(ValueError):
        est.partial_fit(htt.zeros(4))
    est.partial_fit(htt.array(np.arange(8, dtype=np.float32).reshape(4, 2)))
    with pytest.raises(ValueError):
        est.partial_fit(htt.zeros((4, 3)))
    with pytest.raises(RuntimeError):
        streaming.MiniBatchKMeans().save("unused")


# -- resume -------------------------------------------------------------------------


def _carry(est):
    if isinstance(est, (streaming.StreamingMoments, ht_tpu.streaming.StreamingMoments)):
        return [est._mean, est._m2, np.array(est.n_seen), np.array(est.chunks_seen)]
    return [est._centers_np, est._counts_np, np.array(est._shift), np.array(est.rows_seen)]


def _run(est, chunks):
    for c in chunks:
        est.partial_fit(c)
    return est


@pytest.mark.parametrize("which", ["moments", "kmeans"])
def test_resume_is_bit_for_bit(files, tmp_path, which):
    make = (lambda: streaming.StreamingMoments()) if which == "moments" else (
        lambda: streaming.MiniBatchKMeans(n_clusters=K, inner_iter=3, random_state=1))
    cls = type(make())
    full = _run(make(), streaming.ChunkStream(files, chunk_rows=CHUNK))
    first = _run(make(), list(streaming.ChunkStream(files, chunk_rows=CHUNK))[:5])
    first.save(str(tmp_path / "ck"))
    skip = 1000 + CHUNK  # 4 chunks of the first file, 1 of the second
    resumed = _run(cls.restore(str(tmp_path / "ck")),
                   streaming.ChunkStream(files, chunk_rows=CHUNK, skip_rows=skip))
    for got, want in zip(_carry(resumed), _carry(full)):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(htt.resilience.CheckpointError):
        (streaming.MiniBatchKMeans if which == "moments" else
         streaming.StreamingMoments).restore(str(tmp_path / "ck"))


@pytest.mark.parametrize("which", ["moments", "kmeans"])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_carry_crosses_between_the_packages(files, tmp_path, which, direction):
    """One package fits 5 chunks and saves; the other restores and fits the
    rest; the result equals the first package's own continuation."""
    make = {"moments": (lambda: streaming.StreamingMoments(),
                        lambda: ht_tpu.streaming.StreamingMoments()),
            "kmeans": (lambda: streaming.MiniBatchKMeans(n_clusters=K, random_state=1),
                       lambda: ht_tpu.streaming.MiniBatchKMeans(n_clusters=K, random_state=1))
            }[which]
    pkgs = {"port": (streaming, make[0]), "jax": (ht_tpu.streaming, make[1])}
    src, dst = direction.split("_to_")
    src_mod, src_make = pkgs[src]
    dst_mod, _ = pkgs[dst]
    head = _run(src_make(), list(src_mod.ChunkStream(files, chunk_rows=CHUNK))[:5])
    head.save(str(tmp_path / "ck"))
    want = _run(head, src_mod.ChunkStream(files, chunk_rows=CHUNK, skip_rows=1300))
    cls = type(make[0]() if dst == "port" else make[1]())
    got = _run(cls.restore(str(tmp_path / "ck")),
               dst_mod.ChunkStream(files, chunk_rows=CHUNK, skip_rows=1300))
    g, w = _carry(got), _carry(want)
    if which == "moments":
        assert float(g[2]) == float(w[2])
        assert float(np.max(np.abs(g[0] - w[0]) / (np.abs(w[0]) + np.sqrt(w[1] / w[2])))) <= 1e-6
        np.testing.assert_allclose(g[1], w[1], rtol=1e-6)
    else:
        np.testing.assert_allclose(g[0], w[0], rtol=0, atol=1e-5)
        np.testing.assert_array_equal(g[1], w[1])
        assert int(g[3]) == int(w[3])


# -- rolling_update --------------------------------------------------------------------


class _Handle:
    def __init__(self, index, state="up"):
        self.index, self.state, self.url = index, state, f"http://replica{index}"
        self.log_path = f"replica{index}.log"

    def alive(self):
        return self.state == "up"


class _Pool:
    def __init__(self, n, rc=0):
        self.replicas = [_Handle(i) for i in range(n)] + [_Handle(n, "down")]
        self.checkpoint, self.rc, self.calls = None, rc, []

    def set_checkpoint(self, path):
        self.checkpoint = path
        self.calls.append(("set_checkpoint", path))

    def spawn(self):
        h = _Handle(len(self.replicas))
        self.replicas.append(h)
        self.calls.append(("spawn", h.index))
        return h

    def remove(self, idx, timeout):
        self.calls.append(("remove", idx, timeout))
        self.handle(idx).state = "gone"
        return self.rc

    def handle(self, idx):
        return next(h for h in self.replicas if h.index == idx)

    def stats(self, idx):
        return {"versions": {"model": self.checkpoint}}


class _Router:
    def __init__(self):
        self.targets = []

    def add_target(self, url):
        self.targets.append(url)


def _steps(out):
    return [{k: v for k, v in s.items() if k != "seconds"} for s in out["steps"]]


def test_rolling_update_takes_the_jax_packages_steps(monkeypatch):
    monkeypatch.setenv("HEAT_TPU_STREAM_DRAIN_TIMEOUT", "7.5")
    outs = []
    for fn in (streaming.rolling_update, ht_tpu.streaming.rolling_update):
        pool, router = _Pool(3), _Router()
        out = fn(pool, router, "ckpt-2")
        outs.append((out, pool.calls, router.targets))
    (mine, my_calls, my_targets), (theirs, their_calls, their_targets) = outs
    assert _steps(mine) == _steps(theirs)
    assert my_calls == their_calls and ("remove", 0, 7.5) in my_calls
    assert my_targets == their_targets
    assert mine["replicas"] == theirs["replicas"] == 3
    assert mine["versions"] == theirs["versions"]
    for fn in (streaming.rolling_update, ht_tpu.streaming.rolling_update):
        with pytest.raises(RuntimeError, match="exited rc=1"):
            fn(_Pool(2, rc=1), _Router(), "ckpt")
        with pytest.raises(RuntimeError, match="no live replicas"):
            fn(_Pool(0), _Router(), "ckpt")


def test_estimator_events_count_as_the_jax_package(files, tmp_path):
    reg = telemetry.get_registry()
    reg.clear()
    telemetry.enable()
    try:
        est = _run(streaming.StreamingMoments(), streaming.ChunkStream(files, chunk_rows=CHUNK))
        est.save(str(tmp_path / "m"))
        streaming.StreamingMoments.restore(str(tmp_path / "m"))
        pool = _Pool(2)
        streaming.rolling_update(pool, _Router(), "c", drain_timeout=1.0)
        counters = reg.snapshot()["counters"]
    finally:
        telemetry.disable()
        reg.clear()
    assert counters["streaming.checkpoints"] == 1 and counters["streaming.resumes"] == 1
    assert counters["streaming.roll_steps"] == 2 and counters["streaming.chunks"] == 7
    assert counters["resilience.checkpoints_saved"] == 1


# -- no JAX on the port's path -------------------------------------------------------------

_FRESH = textwrap.dedent("""
    import sys, tempfile, os
    import numpy as np
    import heat_tpu_torch as ht
    ht.use_device("cpu")
    d = tempfile.mkdtemp()
    x = np.random.default_rng(0).standard_normal((500, 4)).astype(np.float32)
    ht.save_npy(ht.array(x, split=0), os.path.join(d, "a.npy"))
    ht.save_csv(ht.array(x), os.path.join(d, "a.csv"))
    ht.load_csv(os.path.join(d, "a.csv"))
    stream = ht.streaming.ChunkStream([os.path.join(d, "a.npy")], chunk_rows=128)
    m, k = ht.streaming.StreamingMoments(), ht.streaming.MiniBatchKMeans(n_clusters=3)
    for c in stream:
        m.partial_fit(c)
        k.partial_fit(c)
    m.save(os.path.join(d, "m"))
    ht.streaming.StreamingMoments.restore(os.path.join(d, "m"))
    ht.cluster.KMeans(n_clusters=3, max_iter=4, checkpoint_every=2,
                      checkpoint_path=os.path.join(d, "km")).fit(ht.load_npy(os.path.join(d, "a.npy")))
    bad = sorted(n for n in sys.modules if n.split(".")[0] in ("heat_tpu", "jax", "jaxlib"))
    print("MODULES", bad)
""")


def test_the_port_and_its_streaming_path_import_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-c", _FRESH], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "MODULES []" in out.stdout, out.stdout
