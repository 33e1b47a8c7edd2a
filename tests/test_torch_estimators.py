"""``cluster.KMedians``, ``cluster.KMedoids``, ``naive_bayes.GaussianNB`` and
``classification.KNeighborsClassifier`` of heat_tpu_torch against heat_tpu.

One numpy input from a seed goes through both packages: heat_tpu on its
8-device CPU mesh, heat_tpu_torch as a world of one rank on the CPU.

* KMedians/KMedoids (both seed from the same ``random_state`` through the
  port's threefry): labels and ``n_iter_`` exactly, the centers within
  1e-6 (medians are data values or the midpoint of two: bit for bit unless
  a Manhattan distance sums 8 floats in another order at a tie), the
  inertia within 1e-5 relative; KMedoids' centers are data rows; the
  even-count median is numpy's midpoint;
* GaussianNB: ``classes_`` exactly, ``class_count_`` (weighted),
  ``theta_``, ``var_``, ``class_prior_``, ``epsilon_`` within 1e-12
  relative (float64 sums in another order), the predictions exactly and the probabilities within
  1e-10; with sample weights, priors and ``partial_fit``;
* KNN: predictions exactly, also with planted distance ties (the lower
  index first) and vote ties (the lower class).
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


def _blobs(n_per=25, k=4, d=3, seed=0, spread=1.0):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-10, 10, (k, d))
    x = np.concatenate([c + spread * rng.standard_normal((n_per, d)) for c in centers])
    y = np.repeat(np.arange(k), n_per)
    order = rng.permutation(len(x))
    return x[order].astype(np.float32), y[order]


@pytest.mark.parametrize("cls", ["KMedians", "KMedoids"])
@pytest.mark.parametrize("init", ["random", "probability_based"])
@pytest.mark.parametrize("split", [None, 0])
def test_kmedians_kmedoids_match_reference(cls, init, split):
    x, _ = _blobs()
    kw = dict(n_clusters=4, init=init, max_iter=20, random_state=3)
    got = getattr(htt.cluster, cls)(**kw).fit(htt.array(x, split=split))
    ref = getattr(ht_tpu.cluster, cls)(**kw).fit(ht_tpu.array(x, split=split))
    assert got.n_iter_ == ref.n_iter_
    np.testing.assert_array_equal(got.labels_.numpy(), np.asarray(ref.labels_.numpy()))
    assert got.labels_.split == ref.labels_.split and got.labels_.dtype is htt.int64
    centers = got.cluster_centers_.numpy()
    np.testing.assert_allclose(centers, np.asarray(ref.cluster_centers_.numpy()), atol=1e-6)
    assert got.cluster_centers_.split is None
    np.testing.assert_allclose(got.inertia_, ref.inertia_, rtol=1e-5)
    np.testing.assert_array_equal(got.predict(htt.array(x, split=split)).numpy(),
                                  got.labels_.numpy())
    if cls == "KMedoids":  # every center is a data row
        assert all((x == c).all(axis=1).any() for c in centers)


def test_median_update_is_numpys_midpoint():
    """Even member counts: the midpoint of the two middle values; an empty
    cluster keeps its center."""
    x = np.array([[0.0, 1.0], [1.0, 5.0], [2.0, 2.0], [7.0, 0.5], [100.0, 100.0],
                  [101.0, 102.0]], np.float32)
    init = np.array([[1.0, 1.0], [100.0, 100.0], [-50.0, -50.0]], np.float32)
    for ht in (htt, ht_tpu):
        est = ht.cluster.KMedians(n_clusters=3, init=ht.array(init), max_iter=1).fit(
            ht.array(x, split=0))
        c = np.asarray(est.cluster_centers_.numpy())
        np.testing.assert_array_equal(c[0], np.median(x[:4], axis=0))
        np.testing.assert_array_equal(c[1], np.median(x[4:], axis=0))
        np.testing.assert_array_equal(c[2], init[2])


def test_kmedoids_init_alias_and_errors():
    x, _ = _blobs()
    got = htt.cluster.KMedoids(n_clusters=4, init="kmedoids++", random_state=1).fit(
        htt.array(x, split=0))
    ref = ht_tpu.cluster.KMedoids(n_clusters=4, init="kmedoids++", random_state=1).fit(
        ht_tpu.array(x, split=0))
    np.testing.assert_array_equal(got.labels_.numpy(), np.asarray(ref.labels_.numpy()))
    assert got.tol == 0.0 and got.init == "probability_based"
    for est in (htt.cluster.KMedians(), htt.cluster.KMedoids()):
        with pytest.raises(TypeError):
            est.fit(x)
        with pytest.raises(ValueError):
            est.fit(htt.array(x[:, 0]))
        with pytest.raises(RuntimeError):
            est.predict(htt.array(x))


# ------------------------------------------------------------------ GaussianNB


def _hold_nb(got, ref):
    np.testing.assert_array_equal(got.classes_.numpy(), np.asarray(ref.classes_.numpy()))
    for name in ("class_count_", "theta_", "var_", "class_prior_"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name).numpy()), rtol=1e-12, err_msg=name)
    np.testing.assert_allclose(got.epsilon_, ref.epsilon_, rtol=1e-12)


@pytest.mark.parametrize("split", [None, 0])
@pytest.mark.parametrize("weighted", [False, True])
def test_gaussian_nb_matches_reference(split, weighted):
    x, y = _blobs(spread=4.0)
    w = np.random.default_rng(5).uniform(0.2, 2.0, len(x)) if weighted else None
    got = htt.naive_bayes.GaussianNB().fit(htt.array(x, split=split), htt.array(y, split=split),
                                           sample_weight=w)
    ref = ht_tpu.naive_bayes.GaussianNB().fit(ht_tpu.array(x, split=split),
                                              ht_tpu.array(y, split=split), sample_weight=w)
    _hold_nb(got, ref)
    q = x[::3] + 0.5
    pred = got.predict(htt.array(q, split=split))
    np.testing.assert_array_equal(pred.numpy(), np.asarray(ref.predict(ht_tpu.array(q)).numpy()))
    assert pred.split == split and pred.dtype is htt.int64
    for name in ("predict_log_proba", "predict_proba"):
        g = getattr(got, name)(htt.array(q, split=split))
        r = getattr(ref, name)(ht_tpu.array(q, split=split))
        assert g.dtype is htt.float64 and g.shape == tuple(r.shape) and g.split == r.split
        np.testing.assert_allclose(g.numpy(), np.asarray(r.numpy()), rtol=1e-10, atol=1e-10)


def test_gaussian_nb_partial_fit_and_priors():
    x, y = _blobs(spread=4.0)
    got, ref = htt.naive_bayes.GaussianNB(), ht_tpu.naive_bayes.GaussianNB()
    for lo, hi in ((0, 40), (40, 70), (70, 100)):
        got.partial_fit(htt.array(x[lo:hi], split=0), htt.array(y[lo:hi], split=0),
                        classes=np.arange(4))
        ref.partial_fit(ht_tpu.array(x[lo:hi], split=0), ht_tpu.array(y[lo:hi], split=0),
                        classes=np.arange(4))
    _hold_nb(got, ref)
    priors = np.array([0.1, 0.2, 0.3, 0.4])
    got = htt.naive_bayes.GaussianNB(priors=htt.array(priors)).fit(htt.array(x), htt.array(y))
    ref = ht_tpu.naive_bayes.GaussianNB(priors=ht_tpu.array(priors)).fit(ht_tpu.array(x),
                                                                        ht_tpu.array(y))
    _hold_nb(got, ref)
    for ht in (htt, ht_tpu):
        nb = ht.naive_bayes.GaussianNB()
        with pytest.raises(ValueError):
            nb.partial_fit(ht.array(x), ht.array(y))
        with pytest.raises(ValueError):
            ht.naive_bayes.GaussianNB(priors=ht.array(priors[:3])).fit(ht.array(x), ht.array(y))
        with pytest.raises(ValueError):
            ht.naive_bayes.GaussianNB(priors=ht.array(priors * 2)).fit(ht.array(x), ht.array(y))
        with pytest.raises(ValueError):
            nb.fit(ht.array(x), ht.array(y), sample_weight=np.ones(3))
        with pytest.raises(TypeError):
            nb.fit(x, y)
        nb.fit(ht.array(x[y < 2]), ht.array(y[y < 2]))
        with pytest.raises(ValueError):
            nb.partial_fit(ht.array(x), ht.array(y))
    with pytest.raises(RuntimeError):
        htt.naive_bayes.GaussianNB().predict(htt.array(x))


# ------------------------------------------------------------------ KNN


@pytest.mark.parametrize("split", [None, 0])
@pytest.mark.parametrize("k", [1, 5, 200])
def test_knn_matches_reference(split, k):
    x, y = _blobs(spread=5.0)
    q = np.random.default_rng(9).uniform(-12, 12, (31, 3)).astype(np.float32)
    got = htt.classification.KNeighborsClassifier(k).fit(htt.array(x, split=split),
                                                         htt.array(y, split=split))
    ref = ht_tpu.classification.KNeighborsClassifier(k).fit(ht_tpu.array(x, split=split),
                                                            ht_tpu.array(y, split=split))
    pred = got.predict(htt.array(q, split=split))
    want = ref.predict(ht_tpu.array(q, split=split))
    np.testing.assert_array_equal(pred.numpy(), np.asarray(want.numpy()))
    assert pred.split == want.split and pred.dtype.__name__ == want.dtype.__name__


def test_knn_ties():
    """Training points at equal distances: the lower index is nearer; a
    tied vote goes to the lower class."""
    x = np.array([[1.0, 0.0], [-1.0, 0.0], [0.0, 1.0], [0.0, -1.0], [5.0, 5.0]], np.float32)
    y = np.array([3, 1, 1, 3, 0])
    q = np.zeros((1, 2), np.float32)
    for k, want in ((1, 3), (2, 1), (3, 1), (4, 1)):
        for ht in (htt, ht_tpu):
            est = ht.classification.KNeighborsClassifier(k).fit(ht.array(x), ht.array(y))
            assert int(np.asarray(est.predict(ht.array(q)).numpy())[0]) == want, (ht, k)
    with pytest.raises(RuntimeError):
        htt.classification.KNeighborsClassifier().predict(htt.array(q))
    with pytest.raises(TypeError):
        htt.classification.KNeighborsClassifier().fit(x, y)


def test_estimators_are_exported_as_in_the_reference():
    for mod, names in (("cluster", ("KMedians", "KMedoids")), ("naive_bayes", ("GaussianNB",)),
                       ("classification", ("KNeighborsClassifier",))):
        for name in names:
            assert hasattr(getattr(ht_tpu, mod), name) and hasattr(getattr(htt, mod), name)
    assert htt.is_classifier(htt.naive_bayes.GaussianNB())
    assert htt.is_classifier(htt.classification.KNeighborsClassifier())
    for name in ("Ragged", "ragged", "sparse", "SplitTiles", "SquareDiagTiles"):
        assert hasattr(ht_tpu, name) and hasattr(htt, name), name
    assert hasattr(htt.core, "tiling") and hasattr(htt.graph, "connected_components")
