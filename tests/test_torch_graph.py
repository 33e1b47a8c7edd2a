"""The sparse graph paths of heat_tpu_torch against heat_tpu: the sparse
eNeighbour ``Laplacian`` with its density gate, ``cg``/``lanczos`` on a
sparse operator, the sparse ``Spectral`` and ``connected_components``.

One numpy input from a seed goes through both packages, heat_tpu_torch as
a world of one rank on the CPU; layout against heat_tpu on a one-device
communicator, values against its 8-device mesh too:

* ``Laplacian``: a ``SparseDNDarray`` in both packages where the graph is
  sparse enough (``sparse=None``) or forced (``sparse=True``), dense past
  ``HEAT_TPU_SPARSE_DENSE_THRESHOLD`` (set both ways); ``indptr``,
  ``indices`` and ``counts`` bit for bit, the values within 1e-5 (the
  degrees are float32 sums added in another order); with and without the
  two-operand similarity;
* ``cg``/``lanczos`` on the sparse operator: within 1e-5 of the dense solve
  on ``to_dense(A)`` and of the JAX package's sparse solve (``cg`` to 1e-6
  of ``numpy.linalg.solve``; ``lanczos``' Ritz values, ``VᵀV = I``,
  ``VᵀAV = T``; the breakdown restart's V and T within 1e-6);
* ``Spectral`` with a sparse graph: the labels equal the JAX package's up
  to a relabelling, and the generating blob ids;
* ``connected_components``: bit for bit the JAX package's labels, the same
  partition as ``scipy.sparse.csgraph.connected_components`` (weak), each
  label its component's least vertex.
"""

import jax
import numpy as np
import pytest
import scipy.sparse
import scipy.sparse.csgraph

import heat_tpu as ht_tpu
from heat_tpu.core.communication import MeshCommunication

import heat_tpu_torch as htt


@pytest.fixture(autouse=True)
def on_cpu():
    htt.use_device("cpu")
    yield
    htt.use_device(None)


def _one():
    return MeshCommunication(devices=jax.devices()[:1])


def _blobs(k=5, per=12, seed=3, spread=0.3, gap=6.0):
    rng = np.random.default_rng(seed)
    centers = rng.permutation(np.stack(np.meshgrid(np.arange(3), np.arange(3)), -1)
                              .reshape(-1, 2))[:k] * gap
    x = np.concatenate([c + spread * rng.standard_normal((per, 2)) for c in centers])
    return x.astype(np.float32), np.repeat(np.arange(k), per)


def _same_partition(a, b):
    pairs = set(zip(np.asarray(a).tolist(), np.asarray(b).tolist()))
    return len(pairs) == len(set(np.asarray(a).tolist())) == len(set(np.asarray(b).tolist()))


def _rbf(ht):
    return lambda x: ht.spatial.rbf(x, sigma=1.0, quadratic_expansion=True)


def _rbf_pair(ht):
    return lambda a, b: ht.spatial.rbf(a, b, sigma=1.0, quadratic_expansion=True)


def _hold_structure(got, ref, tol=1e-5):
    assert isinstance(got, htt.sparse.SparseDNDarray)
    assert got.shape == tuple(ref.shape) and got.dtype.__name__ == ref.dtype.__name__
    assert got.counts.tolist() == ref.counts.tolist() and got.capacity == ref.capacity
    np.testing.assert_array_equal(got.indptr.numpy(), np.asarray(ref.indptr))
    c = int(ref.counts[0])
    np.testing.assert_array_equal(got.indices.numpy()[:c], np.asarray(ref.indices)[:c])
    np.testing.assert_allclose(got.values.numpy()[:c], np.asarray(ref.values)[:c], rtol=tol,
                               atol=tol)


# ---------------------------------------------------------------- Laplacian


@pytest.mark.parametrize("pair", [True, False])
@pytest.mark.parametrize("split", [None, 0])
@pytest.mark.parametrize("definition,key,weighted", [("norm_sym", "lower", True),
                                                     ("simple", "lower", False),
                                                     ("norm_sym", "lower", False),
                                                     ("simple", "upper", True)])
def test_sparse_laplacian_matches_reference(definition, key, weighted, split, pair):
    x, _ = _blobs()
    kw = dict(weighted=weighted, definition=definition, mode="eNeighbour", threshold_key=key,
              threshold_value=0.5 if key == "lower" else 1e-3, sparse=True)
    got = htt.graph.Laplacian(_rbf(htt), pair_similarity=_rbf_pair(htt) if pair else None,
                              **kw).construct(htt.array(x, split=split))
    ref = ht_tpu.graph.Laplacian(_rbf(ht_tpu), pair_similarity=_rbf_pair(ht_tpu) if pair else
                                 None, **kw).construct(ht_tpu.array(x, split=split, comm=_one()))
    _hold_structure(got, ref)
    mesh = ht_tpu.graph.Laplacian(_rbf(ht_tpu), pair_similarity=_rbf_pair(ht_tpu), **kw).construct(
        ht_tpu.array(x, split=split))
    np.testing.assert_allclose(got.to_dense().numpy(), np.asarray(mesh.to_dense().numpy()),
                               rtol=1e-5, atol=1e-5)
    dense = htt.graph.Laplacian(_rbf(htt), **dict(kw, sparse=False)).construct(
        htt.array(x, split=split))
    np.testing.assert_allclose(got.to_dense().numpy(), dense.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("block_rows", [1, 7, 60])
def test_sparse_laplacian_in_blocks_equals_one_block(block_rows, monkeypatch):
    """Blocks of ``block_rows`` rows (the memory budget made small) give the
    same shard bit for bit as the whole graph in one block."""
    import heat_tpu_torch.graph.laplacian as lap

    x, _ = _blobs()
    kw = dict(definition="norm_sym", mode="eNeighbour", threshold_key="lower",
              threshold_value=0.01, sparse=True)
    whole = htt.graph.Laplacian(_rbf(htt), pair_similarity=_rbf_pair(htt), **kw).construct(
        htt.array(x, split=0))
    monkeypatch.setattr(lap, "_BLOCK_BUDGET", x.shape[0] * 4 * block_rows)
    for pair in (_rbf_pair(htt), None):
        got = htt.graph.Laplacian(_rbf(htt), pair_similarity=pair, **kw).construct(
            htt.array(x, split=0))
        assert got.counts.tolist() == whole.counts.tolist()
        for name in ("indptr", "indices", "values"):
            np.testing.assert_array_equal(getattr(got, name).numpy(), getattr(whole, name).numpy())


@pytest.mark.parametrize("limit,sparse", [(None, True), ("0.9", True), ("0.05", False)])
def test_density_gate(limit, sparse, monkeypatch):
    """Five blobs of 12: density ~0.2 with the diagonal slots, under the
    default gate of 0.25."""
    if limit is not None:
        monkeypatch.setenv("HEAT_TPU_SPARSE_DENSE_THRESHOLD", limit)
    x, _ = _blobs()
    kw = dict(definition="norm_sym", mode="eNeighbour", threshold_key="lower",
              threshold_value=0.01)
    got = htt.graph.Laplacian(_rbf(htt), pair_similarity=_rbf_pair(htt), **kw).construct(
        htt.array(x, split=0))
    ref = ht_tpu.graph.Laplacian(_rbf(ht_tpu), pair_similarity=_rbf_pair(ht_tpu), **kw).construct(
        ht_tpu.array(x, split=0))
    assert isinstance(got, htt.sparse.SparseDNDarray) is sparse
    assert isinstance(ref, ht_tpu.sparse.SparseDNDarray) is sparse
    want = ref.to_dense() if sparse else ref
    np.testing.assert_allclose((got.to_dense() if sparse else got).numpy(),
                               np.asarray(want.numpy()), rtol=1e-5, atol=1e-5)
    if sparse:
        assert 0.15 < got.density <= 0.25 and got.density == ref.density


def test_laplacian_sparse_false_and_fully_connected_stay_dense():
    x, _ = _blobs()
    for kw in (dict(mode="eNeighbour", threshold_key="lower", threshold_value=0.01, sparse=False),
               dict(mode="fully_connected", sparse=True)):
        got = htt.graph.Laplacian(_rbf(htt), **kw).construct(htt.array(x, split=0))
        assert isinstance(got, htt.DNDarray) and got.split == 0


# ---------------------------------------------------------------- solvers


def _sparse_spd(n=40, seed=4, dtype=np.float32):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)) * (rng.random((n, n)) < 0.1)
    a = a + a.T
    a += np.diag(np.abs(a).sum(1) + 1.0)
    return a.astype(dtype), rng.standard_normal(n).astype(dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_sparse_cg_matches_dense_and_reference(dtype):
    a, b = _sparse_spd(dtype=dtype)
    x0 = np.zeros(a.shape[0], dtype)
    A = htt.sparse.csr_from_dense(a)
    got = htt.linalg.cg(A, htt.array(b), htt.array(x0, split=0))
    dense = htt.linalg.cg(A.to_dense(), htt.array(b), htt.array(x0, split=0))
    ref = ht_tpu.linalg.cg(ht_tpu.sparse.csr_from_dense(a), ht_tpu.array(b),
                           ht_tpu.array(x0, split=0))
    assert (got.dtype.__name__, got.split) == (ref.dtype.__name__, ref.split)
    for want in (dense.numpy(), np.asarray(ref.numpy()),
                 np.linalg.solve(a.astype(np.float64), b.astype(np.float64))):
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_sparse_lanczos_matches_dense_and_reference():
    a, _ = _sparse_spd()
    A = htt.sparse.csr_from_dense(a)
    got_v, got_t = htt.linalg.lanczos(A, 12)
    den_v, den_t = htt.linalg.lanczos(A.to_dense(), 12)
    ref_v, ref_t = ht_tpu.linalg.lanczos(ht_tpu.sparse.csr_from_dense(a), 12)
    assert (got_v.shape, got_v.split, got_v.dtype.__name__) == \
        (ref_v.shape, ref_v.split, ref_v.dtype.__name__)
    scale = np.abs(np.linalg.eigvalsh(a.astype(np.float64))).max()
    ritz = lambda t: np.linalg.eigvalsh(np.asarray(t.numpy(), np.float64))
    for want in (den_t, ref_t):
        np.testing.assert_allclose(ritz(got_t), ritz(want), atol=1e-5 * scale)
    np.testing.assert_allclose(got_v.numpy(), den_v.numpy(), atol=1e-5)
    v, t = got_v.numpy().astype(np.float64), got_t.numpy().astype(np.float64)
    np.testing.assert_allclose(v.T @ v, np.eye(12), atol=1e-5)
    np.testing.assert_allclose(v.T @ a.astype(np.float64) @ v, t, atol=1e-5 * scale)


def test_sparse_lanczos_breakdown_restarts_from_the_reference_vector():
    d = np.diag(np.repeat([1.0, 2.0, 3.0], 5)).astype(np.float32)
    got_v, got_t = htt.linalg.lanczos(htt.sparse.csr_from_dense(d), 6)
    ref_v, ref_t = ht_tpu.linalg.lanczos(ht_tpu.sparse.csr_from_dense(d), 6)
    assert got_t.numpy()[3, 2] == 0.0 and np.asarray(ref_t.numpy())[3, 2] == 0.0
    np.testing.assert_allclose(got_t.numpy(), np.asarray(ref_t.numpy()), atol=1e-6)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(ref_v.numpy()), atol=1e-6)


# ---------------------------------------------------------------- Spectral


@pytest.mark.parametrize("split", [None, 0])
@pytest.mark.parametrize("sparse", [None, True])
def test_sparse_spectral_matches_reference(sparse, split):
    x, truth = _blobs()
    kw = dict(n_clusters=5, gamma=0.5, laplacian="eNeighbour", threshold=0.01,
              boundary="lower", n_lanczos=30, sparse=sparse)
    htt.random.seed(1)
    ht_tpu.random.seed(1)
    got = htt.cluster.Spectral(**kw)
    assert isinstance(got._laplacian.construct(htt.array(x, split=split)),
                      htt.sparse.SparseDNDarray)
    got.fit(htt.array(x, split=split))
    want = ht_tpu.cluster.Spectral(**kw).fit(ht_tpu.array(x, split=split))
    labels = got.labels_.numpy()
    assert labels.shape == (60,) and got.labels_.split == want.labels_.split
    assert _same_partition(labels, np.asarray(want.labels_.numpy()))
    assert _same_partition(labels, truth)


@pytest.mark.parametrize("metric", ["euclidean", "manhattan"])
def test_sparse_spectral_distance_graphs_match_reference(metric):
    """A distance graph (edges below 2.0, weighted by the distance) through
    the two-operand ``cdist``/``manhattan``: the same sparse Laplacian and
    Ritz values as the JAX package's (its KMeans labels hinge on a degenerate
    embedding, so they are not compared); with ``n_lanczos = n`` the Ritz
    values are the eigenvalues of L, within 1e-4. The GEMM-form distances carry an
    absolute error near 1e-5 in d² at |x|² ≈ 150 in either package, so a
    short edge's weight may differ by 1e-4: the values are held to 2e-4."""
    x, _ = _blobs()
    kw = dict(n_clusters=5, metric=metric, laplacian="eNeighbour", threshold=2.0,
              boundary="upper", n_lanczos=60, sparse=True)
    got = htt.cluster.Spectral(**kw)
    want = ht_tpu.cluster.Spectral(**kw)
    L = got._laplacian.construct(htt.array(x, split=0))
    _hold_structure(L, want._laplacian.construct(ht_tpu.array(x, split=0, comm=_one())),
                    tol=2e-4)
    eig, _ = got._spectral_embedding(htt.array(x, split=0))
    ref_eig, _ = want._spectral_embedding(ht_tpu.array(x, split=0))
    np.testing.assert_allclose(eig, np.asarray(ref_eig.numpy()), atol=1e-4)
    np.testing.assert_allclose(eig, np.linalg.eigvalsh(L.to_dense().numpy().astype(np.float64)),
                               atol=1e-4)


# ---------------------------------------------------------------- components


def _graph(n=30, seed=5, edges=25, directed=True):
    rng = np.random.default_rng(seed)
    a = np.zeros((n, n), np.float32)
    i, j = rng.integers(0, n, edges), rng.integers(0, n, edges)
    a[i, j] = rng.random(edges).astype(np.float32) + 0.5
    if not directed:
        a = np.maximum(a, a.T)
    return a


@pytest.mark.parametrize("directed", [True, False])
@pytest.mark.parametrize("source", ["sparse", "dense"])
def test_connected_components_match_reference_and_scipy(directed, source):
    a = _graph(directed=directed)
    if source == "sparse":
        got = htt.graph.connected_components(htt.sparse.csr_from_dense(a),
                                             assume_symmetric=not directed)
        ref = ht_tpu.graph.connected_components(ht_tpu.sparse.csr_from_dense(a),
                                                assume_symmetric=not directed)
    else:
        got = htt.graph.connected_components(htt.array(a, split=0))
        ref = ht_tpu.graph.connected_components(ht_tpu.array(a, split=0))
    labels = got.numpy()
    assert got.split is None and got.dtype is htt.int64 and got.shape == (30,)
    np.testing.assert_array_equal(labels, np.asarray(ref.numpy()))
    _, sp = scipy.sparse.csgraph.connected_components(scipy.sparse.csr_matrix(a),
                                                      connection="weak")
    assert _same_partition(labels, sp)
    for lab in np.unique(labels):
        assert lab == np.flatnonzero(labels == lab).min()


def test_connected_components_max_iter_and_errors():
    a = np.diag(np.ones(19, np.float32), 1)  # a path: 19 rounds to converge
    for it in (1, 3):
        got = htt.graph.connected_components(htt.sparse.csr_from_dense(a), max_iter=it)
        ref = ht_tpu.graph.connected_components(ht_tpu.sparse.csr_from_dense(a), max_iter=it)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref.numpy()))
    assert (htt.graph.connected_components(htt.sparse.csr_from_dense(a)).numpy() == 0).all()
    with pytest.raises(TypeError):
        htt.graph.connected_components(a)
    with pytest.raises(ValueError):
        htt.graph.connected_components(htt.sparse.csr_from_dense(np.ones((3, 4))))
