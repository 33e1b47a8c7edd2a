"""``graph.Laplacian`` and ``cluster.Spectral`` of heat_tpu_torch against
heat_tpu.

One numpy input goes through both packages: heat_tpu on its 8-device CPU
mesh, heat_tpu_torch as a world of one rank on the CPU.

* ``Laplacian``: ``simple`` and ``norm_sym``, ``fully_connected`` and
  ``eNeighbour`` (``upper`` and ``lower``, weighted or not), split None
  and 0: type, split and values within 1e-5 relative and absolute of the
  reference's (the degrees are float32 sums of up to 60 similarities, added
  in another order); for ``sparse=None`` the reference builds a sparse
  array unless the graph is too dense for one, compared through
  ``to_dense``.
* ``Spectral``: the three blobs of ``tests/test_ml.py``, for ``rbf``,
  ``euclidean`` and ``manhattan`` and split None, 0 and 1: the labels equal
  the reference's up to a relabelling (both seed KMeans from the same
  ``random.seed``), and for ``rbf`` the generating blob ids. With
  ``n_clusters=None`` the eigen-gap picks the reference's count.
"""

import numpy as np
import pytest

import heat_tpu as ht_tpu

import heat_tpu_torch as htt


@pytest.fixture(autouse=True)
def on_cpu():
    htt.use_device("cpu")
    yield
    htt.use_device(None)


def _blobs(seed=3, per=20):
    rng = np.random.default_rng(seed)
    centers = np.array([[0, 0], [6, 6], [0, 6]], dtype=np.float32)
    x = np.concatenate([c + 0.3 * rng.standard_normal((per, 2)) for c in centers])
    return x.astype(np.float32), np.repeat(np.arange(3), per)


def _two_blobs():
    rng = np.random.default_rng(7)
    a = rng.standard_normal((30, 2)) * 0.3
    b = rng.standard_normal((30, 2)) * 0.3 + np.array([10.0, 0.0])
    return np.vstack([a, b]).astype(np.float32), np.repeat(np.arange(2), 30)


def _same_partition(a, b):
    pairs = set(zip(np.asarray(a).tolist(), np.asarray(b).tolist()))
    return len(pairs) == len(set(np.asarray(a).tolist())) == len(set(np.asarray(b).tolist()))


def _rbf(ht):
    return lambda x: ht.spatial.rbf(x, sigma=1.0, quadratic_expansion=True)


@pytest.mark.parametrize("split", [None, 0])
@pytest.mark.parametrize("mode,key,weighted", [("fully_connected", "upper", True),
                                               ("eNeighbour", "lower", True),
                                               ("eNeighbour", "upper", False),
                                               ("eNeighbour", "lower", False)])
@pytest.mark.parametrize("definition", ["simple", "norm_sym"])
def test_laplacian_matches_reference(definition, mode, key, weighted, split):
    x, _ = _blobs()
    kw = dict(weighted=weighted, definition=definition, mode=mode, threshold_key=key,
              threshold_value=0.5)
    got = htt.graph.Laplacian(_rbf(htt), **kw).construct(htt.array(x, split=split))
    want = ht_tpu.graph.Laplacian(_rbf(ht_tpu), sparse=False, **kw).construct(
        ht_tpu.array(x, split=split))
    assert (got.dtype.__name__, got.split, got.shape) == \
        (want.dtype.__name__, want.split, tuple(want.shape))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    if mode == "eNeighbour":  # the reference's default: a sparse array of the same values
        sparse = ht_tpu.graph.Laplacian(_rbf(ht_tpu), **kw).construct(
            ht_tpu.array(x, split=split))
        dense = sparse.to_dense() if hasattr(sparse, "to_dense") else sparse
        np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=1e-5, atol=1e-5)


def test_laplacian_errors():
    # sparse=True is ported: it builds the sparse array (tests/test_torch_graph.py)
    x, _ = _blobs()
    got = htt.graph.Laplacian(_rbf(htt), mode="eNeighbour", sparse=True).construct(htt.array(x))
    assert isinstance(got, htt.sparse.SparseDNDarray)
    for ht in (htt, ht_tpu):
        with pytest.raises(NotImplementedError):
            ht.graph.Laplacian(_rbf(ht), definition="random_walk")
        with pytest.raises(NotImplementedError):
            ht.graph.Laplacian(_rbf(ht), mode="knn")


@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("metric", ["rbf", "euclidean", "manhattan"])
def test_spectral_labels_match_reference(metric, split):
    x, truth = _blobs()
    htt.random.seed(1)
    ht_tpu.random.seed(1)
    got = htt.cluster.Spectral(n_clusters=3, gamma=1.0, metric=metric, n_lanczos=20).fit(
        htt.array(x, split=split))
    want = ht_tpu.cluster.Spectral(n_clusters=3, gamma=1.0, metric=metric, n_lanczos=20).fit(
        ht_tpu.array(x, split=split))
    labels = got.labels_.numpy()
    assert labels.shape == (60,) and got.labels_.split == want.labels_.split
    assert _same_partition(labels, want.labels_.numpy())
    if metric == "rbf":
        assert _same_partition(labels, truth)


def test_spectral_callable_metric_eigen_gap_and_predict():
    x, truth = _two_blobs()
    htt.random.seed(2)
    ht_tpu.random.seed(2)
    got = htt.cluster.Spectral(gamma=0.5, n_lanczos=40).fit(htt.array(x, split=0))
    want = ht_tpu.cluster.Spectral(gamma=0.5, n_lanczos=40).fit(ht_tpu.array(x, split=0))
    assert got.n_clusters == want.n_clusters
    assert _same_partition(got.labels_.numpy(), want.labels_.numpy())
    assert _same_partition(got.predict(htt.array(x, split=1)).numpy(),
                           want.predict(ht_tpu.array(x, split=1)).numpy())
    sp = htt.cluster.Spectral(n_clusters=2, metric=_rbf(htt), n_lanczos=40)
    assert _same_partition(sp.fit(htt.array(x, split=0)).labels_.numpy(), truth)


def test_spectral_errors():
    with pytest.raises(NotImplementedError):
        htt.cluster.Spectral(metric="cosine")
    with pytest.raises(NotImplementedError):
        htt.cluster.Spectral(assign_labels="discretize")
    sp = htt.cluster.Spectral(n_clusters=2)
    with pytest.raises(RuntimeError):
        sp.predict(htt.array(np.ones((4, 2), np.float32)))
    with pytest.raises(TypeError):
        sp.fit(np.ones((4, 2)))
