"""``regression.Lasso`` of heat_tpu_torch against heat_tpu.

One numpy problem (x from a seed, y = x w + 0.5 + noise, w sparse) goes
through both packages: heat_tpu on its 8-device CPU mesh, heat_tpu_torch
as a world of one rank on the CPU. Tolerances:

* ``theta`` within 2e-6 absolute (the coefficients are O(1); float32
  coordinate descent whose dot products add in another order);
* ``n_iter`` equal: at ``tol=0`` both run ``max_iter`` epochs (kept below
  the epoch where float32 iterates settle on a fixed point, since the
  summation order decides whether that epoch's change is exactly 0), and
  at ``tol=1e-6`` both stop at the same epoch;
* ``predict`` within 1e-5 absolute and ``rmse`` within 1e-6 relative.

Split 0, 1 and None, a ragged number of rows over the reference's 8
devices, a column vector ``y``, and ``partial_fit`` over three chunks.
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


def _problem(n=203, d=9, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    w = rng.standard_normal(d).astype(np.float32)
    w[::3] = 0.0
    y = (x @ w + 0.5 + 0.1 * rng.standard_normal(n)).astype(np.float32)
    return x, y


def _fit(ht, x, y, split, **kw):
    y_split = 0 if split == 0 else None
    return ht.regression.Lasso(**kw).fit(ht.array(x, split=split), ht.array(y, split=y_split))


@pytest.mark.parametrize("n", [203, 64])
@pytest.mark.parametrize("split", [None, 0, 1])
def test_fit_at_tol_zero_runs_max_iter(split, n):
    x, y = _problem(n)
    got = _fit(htt, x, y, split, lam=0.05, max_iter=10, tol=0.0)
    ref = _fit(ht_tpu, x, y, split, lam=0.05, max_iter=10, tol=0.0)
    assert got.n_iter == ref.n_iter == 10
    np.testing.assert_allclose(got.theta.numpy(), ref.theta.numpy(), atol=2e-6)
    assert got.theta.split is None and got.theta.shape == (x.shape[1] + 1,)
    np.testing.assert_allclose(got.coef_.numpy(), ref.coef_.numpy(), atol=2e-6)
    np.testing.assert_allclose(got.intercept_.numpy(), ref.intercept_.numpy(), atol=2e-6)


@pytest.mark.parametrize("lam", [0.01, 0.3])
@pytest.mark.parametrize("split", [None, 0, 1])
def test_fit_to_convergence_predict_rmse(split, lam):
    x, y = _problem()
    got = _fit(htt, x, y, split, lam=lam, max_iter=100, tol=1e-6)
    ref = _fit(ht_tpu, x, y, split, lam=lam, max_iter=100, tol=1e-6)
    assert got.n_iter == ref.n_iter < 100
    np.testing.assert_allclose(got.theta.numpy(), ref.theta.numpy(), atol=2e-6)
    px, rx = htt.array(x, split=split), ht_tpu.array(x, split=split)
    pred, ref_pred = got.predict(px), ref.predict(rx)
    assert pred.shape == ref_pred.shape and pred.split == ref_pred.split
    np.testing.assert_allclose(pred.numpy(), ref_pred.numpy(), atol=1e-5)
    np.testing.assert_allclose(got.rmse(htt.array(y), got.predict(htt.array(x))),
                               ref.rmse(ht_tpu.array(y), ref.predict(ht_tpu.array(x))), rtol=1e-6)


def test_column_vector_y_and_float64():
    x, y = _problem(seed=1)
    got = _fit(htt, x.astype(np.float64), y[:, None].astype(np.float64), 0, lam=0.05,
               max_iter=10, tol=0.0)
    ref = _fit(ht_tpu, x.astype(np.float64), y[:, None].astype(np.float64), 0, lam=0.05,
               max_iter=10, tol=0.0)
    assert got.theta.dtype is htt.float64
    np.testing.assert_allclose(got.theta.numpy(), ref.theta.numpy(), atol=1e-12)


def test_partial_fit_over_three_chunks():
    x, y = _problem()
    got = htt.regression.Lasso(lam=0.05, max_iter=5, tol=0.0)
    ref = ht_tpu.regression.Lasso(lam=0.05, max_iter=5, tol=0.0)
    for lo, hi in ((0, 70), (70, 140), (140, 203)):
        got.partial_fit(htt.array(x[lo:hi], split=0), htt.array(y[lo:hi], split=0))
        ref.partial_fit(ht_tpu.array(x[lo:hi], split=0), ht_tpu.array(y[lo:hi], split=0))
        assert got.n_iter == ref.n_iter
        np.testing.assert_allclose(got.theta.numpy(), ref.theta.numpy(), atol=2e-6)
    with pytest.raises(ValueError):
        got.partial_fit(htt.array(x[:, :4]), htt.array(y))


def test_soft_threshold_and_errors():
    rho = np.array([-1.0, 0.01, 0.5, -0.02], np.float32)
    got = htt.regression.Lasso(lam=0.05).soft_threshold(htt.array(rho))
    ref = ht_tpu.regression.Lasso(lam=0.05).soft_threshold(ht_tpu.array(rho))
    np.testing.assert_array_equal(got.numpy(), ref.numpy())
    est = htt.regression.Lasso()
    assert est.coef_ is None and est.intercept_ is None and est.theta is None
    with pytest.raises(RuntimeError):
        est.predict(htt.array(np.ones((2, 2), np.float32)))
    with pytest.raises(TypeError):
        est.fit(np.ones((2, 2)), htt.array(np.ones(2)))
    with pytest.raises(ValueError):
        est.fit(htt.array(np.ones(2)), htt.array(np.ones(2)))
    with pytest.raises(ValueError):
        est.fit(htt.array(np.ones((2, 2))), htt.array(np.ones((2, 2, 1))))
    assert est.get_params() == {"lam": 0.1, "max_iter": 100, "tol": 1e-6}
