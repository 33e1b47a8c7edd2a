"""heat_tpu_torch's statistics against heat_tpu: ``argmax``/``argmin``,
``average``, ``bincount``, ``cov``, ``histc``, ``histogram``, ``kurtosis``,
``skew``, ``maximum``/``minimum``, the nan-reductions, ``chunk_moments``,
``percentile`` and ``median``.

One numpy input from a seeded ``np.random.default_rng`` goes through both
packages: heat_tpu on its 8-device CPU mesh, heat_tpu_torch as a world of
one rank on the CPU, split None, 0 and 1, ragged shapes (10 rows over 8
devices). Shape, split, type name and the lshape map over 8 ranks must be
the reference's exactly; indices, counts and other exact results bit for
bit; float32 results within rtol 1e-5 (atol 1e-5 times the result's
magnitude: sums of tens of terms in another order, and the third and
fourth powers of ``skew`` and ``kurtosis``), float64 within 1e-12. The
percentiles, float64 interpolations of the same order statistics, are
within 1 ulp, with NaN where the reference has NaN.
Histogram counts of float32 data are exact: both bin in float64 against
the same float64 edges. Ties across ranks for ``argmax``/``argmin`` and the
counts of ``histogram``/``bincount`` on three gloo ranks are held to a
world of one in ``test_torch_linalg.py``'s spawned world.
"""

import numpy as np
import pytest
import torch

import heat_tpu as ht_tpu

import heat_tpu_torch as htt
from heat_tpu_torch.core import communication as tcomm

MESH = 8
SPLITS = [None, 0, 1]
RTOL = {"float32": 1e-5, "float64": 1e-12}


@pytest.fixture(autouse=True)
def on_cpu():
    htt.use_device("cpu")
    yield
    htt.use_device(None)


def _data(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == "bool":
        return rng.integers(0, 2, size=shape).astype(bool)
    if dtype.startswith(("int", "uint")):
        return rng.integers(0 if dtype.startswith("uint") else -6, 7, size=shape).astype(dtype)
    return (rng.standard_normal(shape) * 2 + 0.5).astype(dtype)


def _check(got, ref):
    assert got.shape == ref.shape
    assert got.split == ref.split
    assert got.dtype.__name__ == ref.dtype.__name__, (got.dtype, ref.dtype)
    if got.ndim:
        np.testing.assert_array_equal(tcomm.lshape_map(got.shape, got.split, MESH),
                                      ref.lshape_map)
    g, r = got.numpy(), np.asarray(ref.numpy())
    name = got.dtype.__name__
    if name in RTOL:
        finite = r[np.isfinite(r)]
        scale = max(1.0, float(np.abs(finite).max())) if finite.size else 1.0
        np.testing.assert_allclose(g, r, rtol=RTOL[name], atol=RTOL[name] * scale)
    else:
        np.testing.assert_array_equal(g, r)


def _both(fn, *operands):
    got = fn(htt, *(htt.array(x, split=s) for x, s in operands))
    ref = fn(ht_tpu, *(ht_tpu.array(x, split=s) for x, s in operands))
    return got, ref


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("axis,keepdims", [(None, False), (None, True), (0, False), (1, False),
                                           (0, True), (1, True)])
@pytest.mark.parametrize("dtype", ["float32", "int32", "bool", "float64"])
@pytest.mark.parametrize("name", ["argmax", "argmin"])
def test_arg_extremes(name, dtype, axis, keepdims, split):
    x = _data((10, 7), dtype)
    if dtype == "float32":
        x[3, 2] = x[6, 4] = x.max() + 1  # a tie: the first index wins
        x[8, 1] = x.min() - 1
    got, ref = _both(lambda ht, a: getattr(ht, name)(a, axis=axis, keepdims=keepdims), (x, split))
    _check(got, ref)


def test_arg_extremes_nan_and_method():
    x = _data((10, 3), "float32")
    x[4, 1] = np.nan
    for split in SPLITS:
        for axis in (None, 0, 1):
            got, ref = _both(lambda ht, a: a.argmax(axis), (x, split))
            _check(got, ref)
            got, ref = _both(lambda ht, a: a.argmin(axis), (x, split))
            _check(got, ref)


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("case", ["none", "none_returned", "full", "axis0", "axis1",
                                  "axis1_returned", "axis0_returned"])
def test_average(case, split):
    x = _data((10, 4), "float32")
    w0 = np.abs(_data((10,), "float32", 1)) + 0.1
    w1 = np.abs(_data((4,), "float32", 2)) + 0.1
    wf = np.abs(_data((10, 4), "float32", 3)) + 0.1
    calls = {
        "none": lambda ht, a: ht.average(a),
        "none_returned": lambda ht, a: ht.average(a, axis=0, returned=True),
        "full": lambda ht, a: ht.average(a, weights=ht.array(wf, split=split)),
        "axis0": lambda ht, a: ht.average(a, axis=0, weights=ht.array(w0, split=0)),
        "axis1": lambda ht, a: a.average(axis=1, weights=ht.array(w1)),
        "axis1_returned": lambda ht, a: ht.average(a, axis=1, weights=ht.array(w1),
                                                   returned=True),
        "axis0_returned": lambda ht, a: ht.average(a, axis=0, weights=ht.array(w0),
                                                   returned=True),
    }
    got, ref = _both(calls[case], (x, split))
    if isinstance(ref, tuple):
        for g, r in zip(got, ref):
            _check(g, r)
    else:
        _check(got, ref)


def test_average_errors():
    for ht in (htt, ht_tpu):
        a = ht.array(np.ones((4, 3), np.float32))
        with pytest.raises(ValueError):
            ht.average(a, axis=0, weights=ht.array(np.ones(3, np.float32)))
        with pytest.raises(TypeError):
            ht.average(a, weights=ht.array(np.ones(3, np.float32)))


@pytest.mark.parametrize("split", [None, 0])
@pytest.mark.parametrize("case", ["plain", "minlength", "weights", "weights_f64", "bool"])
def test_bincount(case, split):
    x = np.random.default_rng(0).integers(0, 9, size=37).astype(np.int64)
    w = np.random.default_rng(1).random(37).astype(np.float32)
    calls = {
        "plain": lambda ht, a: ht.bincount(a),
        "minlength": lambda ht, a: ht.bincount(a, minlength=15),
        "weights": lambda ht, a: ht.bincount(a, weights=ht.array(w, split=split)),
        "weights_f64": lambda ht, a: ht.bincount(a, weights=ht.array(w.astype(np.float64),
                                                                     split=split)),
        "bool": lambda ht, a: ht.bincount(ht.array(x.astype(np.int32) % 2, split=split)),
    }
    got, ref = _both(calls[case], (x, split))
    _check(got, ref)


def test_bincount_errors():
    for ht in (htt, ht_tpu):
        with pytest.raises(ValueError):
            ht.bincount(ht.array(np.array([1, -2, 3]), split=0))
        with pytest.raises(ValueError):
            ht.bincount(ht.array(np.ones((2, 2), np.int64)))


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("case", ["rowvar", "cols", "bias", "ddof", "with_y", "vector",
                                  "vector_y"])
def test_cov(case, split):
    m = _data((4, 10), "float32")
    y = _data((4, 10), "float32", 5)
    mt = np.ascontiguousarray(m.T)
    calls = {
        "rowvar": lambda ht: ht.cov(ht.array(m, split=split)),
        "cols": lambda ht: ht.cov(ht.array(mt, split=split), rowvar=False),
        "bias": lambda ht: ht.cov(ht.array(m, split=split), bias=True),
        "ddof": lambda ht: ht.cov(ht.array(m, split=split), ddof=2),
        "with_y": lambda ht: ht.cov(ht.array(m, split=split), ht.array(y, split=split)),
        "vector": lambda ht: ht.cov(ht.array(m[0], split=None if split == 1 else split)),
        "vector_y": lambda ht: ht.cov(ht.array(m[0]), ht.array(m[1])),
    }
    _check(calls[case](htt), calls[case](ht_tpu))


def test_cov_errors():
    for ht in (htt, ht_tpu):
        with pytest.raises(ValueError):
            ht.cov(ht.array(np.ones((2, 2, 2), np.float32)))
        with pytest.raises(ValueError):
            ht.cov(ht.array(np.ones((2, 3), np.float32)), ddof=1.5)


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("case", ["bins", "range", "edges", "weights", "density", "int",
                                  "histc", "histc_range", "histc_int"])
def test_histograms(case, split):
    x = _data((10, 6), "float32")
    xi = _data((10, 6), "int32")
    w = np.abs(_data((10, 6), "float32", 4))
    edges = [-3.0, -1.0, 0.0, 0.5, 2.0, 4.0]
    calls = {
        "bins": lambda ht: ht.histogram(ht.array(x, split=split), bins=7),
        "range": lambda ht: ht.histogram(ht.array(x, split=split), bins=5, range=(-1, 1)),
        "edges": lambda ht: ht.histogram(ht.array(x, split=split), bins=edges),
        "weights": lambda ht: ht.histogram(ht.array(x, split=split), bins=4,
                                           weights=ht.array(w, split=split)),
        "density": lambda ht: ht.histogram(ht.array(x, split=split), bins=6, density=True),
        "int": lambda ht: ht.histogram(ht.array(xi, split=split), bins=5),
        "histc": lambda ht: ht.histc(ht.array(x, split=split), bins=9),
        "histc_range": lambda ht: ht.histc(ht.array(x, split=split), bins=4, min=-1.0, max=2.0),
        "histc_int": lambda ht: ht.histc(ht.array(xi, split=split), bins=3),
    }
    got, ref = calls[case](htt), calls[case](ht_tpu)
    if isinstance(ref, tuple):
        for g, r in zip(got, ref):
            _check(g, r)
    else:
        _check(got, ref)


def test_histogram_errors():
    x = np.array([1.0, np.nan, 2.0], np.float32)
    for ht in (htt, ht_tpu):
        with pytest.raises(ValueError):
            ht.histogram(ht.array(x, split=0))
        with pytest.raises(ValueError):
            ht.histogram(ht.array(x), range=(2, 1))


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("axis", [None, 0, 1])
@pytest.mark.parametrize("case", ["skew", "skew_biased", "kurtosis", "kurtosis_pearson",
                                  "kurtosis_unbiased"])
def test_skew_kurtosis(case, axis, split):
    x = np.exp(_data((10, 6), "float32")).astype(np.float32)
    calls = {
        "skew": lambda ht, a: ht.skew(a, axis=axis),
        "skew_biased": lambda ht, a: ht.skew(a, axis=axis, unbiased=False),
        "kurtosis": lambda ht, a: ht.kurtosis(a, axis=axis),
        "kurtosis_pearson": lambda ht, a: ht.kurtosis(a, axis=axis, fisher=False),
        "kurtosis_unbiased": lambda ht, a: ht.kurtosis(a, axis=axis, bias=False),
    }
    got, ref = _both(calls[case], (x, split))
    _check(got, ref)


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("axis,keepdims", [(None, False), (0, False), (1, True), ((0, 1), False)])
@pytest.mark.parametrize("dtype", ["float32", "float64", "int32"])
@pytest.mark.parametrize("name", ["nanmax", "nanmin", "nanmean", "nanvar", "nanstd",
                                  "nanvar_ddof"])
def test_nan_reductions(name, dtype, axis, keepdims, split):
    x = _data((10, 5), dtype)
    if dtype.startswith("float"):
        x[1, 2] = x[6, 0] = x[9, 4] = np.nan
        x[:, 3] = np.nan  # a lane of NaN alone
    if name == "nanvar_ddof":
        fn = lambda ht, a: ht.nanvar(a, axis=axis, ddof=1, keepdims=keepdims)  # noqa: E731
    else:
        fn = lambda ht, a: getattr(ht, name)(a, axis=axis, keepdims=keepdims)  # noqa: E731
    got, ref = _both(fn, (x, split))
    _check(got, ref)


def test_nan_reductions_out():
    x = _data((6, 4), "float32")
    x[2, 1] = np.nan
    for ht in (htt, ht_tpu):
        out = ht.zeros((4,), dtype=ht.float64)
        res = ht.nanmean(ht.array(x, split=0), axis=0, out=out)
        assert res is out and out.dtype.__name__ == "float64"
        np.testing.assert_allclose(out.numpy(), np.nanmean(x, axis=0), rtol=1e-6)


@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("shape,dtype", [((10, 7), "float32"), ((33, 3), "float64"),
                                         ((5, 4), "int32")])
def test_chunk_moments(shape, dtype, split):
    x = _data(shape, dtype)
    n_got, mu_got, m2_got = htt.chunk_moments(htt.array(x, split=split))
    n_ref, mu_ref, m2_ref = ht_tpu.chunk_moments(ht_tpu.array(x, split=split))
    assert n_got == n_ref == shape[0]
    assert str(mu_got.dtype).split(".")[-1] == str(np.asarray(mu_ref).dtype)
    tol = RTOL.get(dtype, 1e-5)
    d = shape[1]
    # split along the columns, the reference returns its padded buffer:
    # the columns, then zeros up to a whole chunk on each of its 8 devices
    for got, ref in ((mu_got, np.asarray(mu_ref)), (m2_got, np.asarray(m2_ref))):
        assert got.shape == (d,) and ref.shape[0] >= d
        np.testing.assert_allclose(got.numpy(), ref[:d], rtol=tol, atol=tol)
        np.testing.assert_array_equal(ref[d:], 0)


def test_chunk_moments_errors_and_launches():
    for ht in (htt, ht_tpu):
        with pytest.raises(ValueError):
            ht.chunk_moments(ht.array(np.ones(3, np.float32)))
        with pytest.raises(TypeError):
            ht.chunk_moments(np.ones((2, 2)))
    htt.reset_launch_counts()
    htt.chunk_moments(htt.array(np.ones((8, 3), np.float32), split=0))
    assert htt.launch_counts()["moments"] == 0  # the CPU takes the plain version


def test_exports_cover_the_reference():
    import heat_tpu.core.statistics as ref_stats

    import heat_tpu_torch.core.statistics as got_stats

    missing = sorted(set(ref_stats.__all__) - set(got_stats.__all__))
    assert missing == []
    for name in got_stats.__all__:
        assert getattr(htt, name) is getattr(got_stats, name)
    assert htt.maximum(htt.array([1.0, np.nan]), 0.5).numpy()[1] != htt.maximum(
        htt.array([1.0, np.nan]), 0.5).numpy()[1]
    assert torch.equal(htt.minimum(2, htt.array([1, 5])).larray, torch.tensor([1, 2]))


PERCENTILE_X = _data((11, 6), "float32")


def _check_percentile(got, ref):
    assert got.shape == tuple(ref.shape) and got.split == ref.split
    assert got.dtype.__name__ == ref.dtype.__name__ == "float64"
    g, r = got.numpy(), np.asarray(ref.numpy())
    np.testing.assert_array_equal(np.isnan(g), np.isnan(r))
    np.testing.assert_array_max_ulp(g[~np.isnan(g)], r[~np.isnan(r)], maxulp=1)


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("method", ["linear", "lower", "higher", "midpoint", "nearest"])
@pytest.mark.parametrize("q", [37.5, [5, 25, 50, 75, 95], [[10, 90], [0, 100]]], ids=str)
def test_percentile(q, method, split):
    """Along the split axis (the distributed sort), along the other axis and
    over all; scalar, vector and 2-D q; keepdims."""
    for axis, keepdims in ((0, False), (1, False), (None, False), (0, True), (None, True)):
        _check_percentile(
            htt.percentile(htt.array(PERCENTILE_X, split=split), q, axis=axis,
                           interpolation=method, keepdims=keepdims),
            ht_tpu.percentile(ht_tpu.array(PERCENTILE_X, split=split), q, axis=axis,
                              interpolation=method, keepdims=keepdims))


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("dtype", ["int32", "float64", "bool", "int64"])
def test_percentile_types_nan_and_median(dtype, split):
    x = _data((11, 6), dtype)
    for axis in (0, 1, None):
        _check_percentile(htt.percentile(htt.array(x, split=split), [10, 50, 93], axis=axis),
                          ht_tpu.percentile(ht_tpu.array(x, split=split), [10, 50, 93],
                                            axis=axis))
        _check_percentile(htt.median(htt.array(x, split=split), axis=axis, keepdims=True),
                          ht_tpu.median(ht_tpu.array(x, split=split), axis=axis, keepdims=True))
    xn = PERCENTILE_X.copy()
    xn[3, 2] = np.nan
    for axis in (0, 1):
        _check_percentile(htt.percentile(htt.array(xn, split=split), [20, 70], axis=axis),
                          ht_tpu.percentile(ht_tpu.array(xn, split=split), [20, 70], axis=axis))
    v = _data((13,), "float32")
    _check_percentile(htt.median(htt.array(v, split=0 if split is not None else None)),
                      ht_tpu.median(ht_tpu.array(v, split=0 if split is not None else None)))


def test_percentile_errors_and_out():
    for ht in (htt, ht_tpu):
        with pytest.raises(ValueError):
            ht.percentile(ht.array(PERCENTILE_X, split=0), 101.0, axis=0)
        with pytest.raises(ValueError):
            ht.percentile(ht.array(PERCENTILE_X, split=0), [10, np.nan], axis=0)
    out = htt.zeros((6,), dtype=htt.float64)
    res = htt.percentile(htt.array(PERCENTILE_X, split=0), 40, axis=0, out=out)
    assert res is out
    np.testing.assert_allclose(out.numpy(), np.percentile(PERCENTILE_X, 40, axis=0), rtol=1e-6)
