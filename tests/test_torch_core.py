"""Factories, binary ops and reductions of heat_tpu_torch against heat_tpu.

One numpy input goes through both packages, heat_tpu on its 8-device CPU
mesh and heat_tpu_torch as a world of one rank on the CPU; the gathered
results must agree. Elementwise results and integer reductions must be
equal; float reductions may sum in another order and are held to
rtol 1e-6 (f32: a few ulps over at most a few hundred terms) or 1e-12
(f64)."""

import numpy as np
import pytest

import heat_tpu as ht_tpu

import heat_tpu_torch as htt


@pytest.fixture(autouse=True)
def on_cpu():
    htt.use_device("cpu")
    yield
    htt.use_device(None)


SPLITS = [None, 0]


def _same(got, ref, rtol=0.0):
    assert got.shape == ref.shape
    assert got.split == ref.split
    assert got.dtype.__name__ == ref.dtype.__name__
    if rtol:
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=rtol, atol=rtol)
    else:
        np.testing.assert_array_equal(got.numpy(), ref.numpy())


def _data(shape, dtype=np.float32, seed=0):
    rng = np.random.default_rng(seed)
    if np.issubdtype(dtype, np.integer):
        return rng.integers(-20, 20, size=shape).astype(dtype)
    return rng.standard_normal(shape).astype(dtype)


def _tol(a):
    return 1e-12 if a.dtype.__name__ == "float64" else 1e-6


class TestFactories:
    @pytest.mark.parametrize("split", SPLITS)
    @pytest.mark.parametrize(
        "obj",
        [
            [[1.5, 2.0], [3.0, 4.0], [5.0, 6.0]],       # python floats → float32
            [[1, 2], [3, 4], [5, 6]],                   # python ints → int64
            np.arange(21, dtype=np.float64).reshape(7, 3),  # numpy f64 stays f64
            np.arange(21, dtype=np.int32).reshape(7, 3),
            np.array([[True, False], [False, True], [True, True]]),
        ],
    )
    def test_array(self, obj, split):
        _same(htt.array(obj, split=split), ht_tpu.array(obj, split=split))

    @pytest.mark.parametrize("split", SPLITS)
    def test_array_dtype_and_ndmin(self, split):
        obj = np.arange(5)
        _same(htt.array(obj, dtype=htt.float32, split=split),
              ht_tpu.array(obj, dtype=ht_tpu.float32, split=split))
        _same(htt.array(obj, ndmin=2), ht_tpu.array(obj, ndmin=2))

    @pytest.mark.parametrize("split", SPLITS)
    @pytest.mark.parametrize("name", ["zeros", "ones"])
    def test_zeros_ones(self, name, split):
        _same(getattr(htt, name)((9, 4), split=split),
              getattr(ht_tpu, name)((9, 4), split=split))
        _same(getattr(htt, name)((5,), dtype=htt.int32, split=split),
              getattr(ht_tpu, name)((5,), dtype=ht_tpu.int32, split=split))

    @pytest.mark.parametrize("split", SPLITS)
    def test_full_empty_like(self, split):
        _same(htt.full((6, 2), 2.5, split=split), ht_tpu.full((6, 2), 2.5, split=split))
        a, b = htt.array(_data((7, 3)), split=split), ht_tpu.array(_data((7, 3)), split=split)
        _same(htt.zeros_like(a), ht_tpu.zeros_like(b))
        _same(htt.ones_like(a), ht_tpu.ones_like(b))
        _same(htt.full_like(a, 7), ht_tpu.full_like(b, 7))
        e, f = htt.empty_like(a), ht_tpu.empty_like(b)
        assert (e.shape, e.split, e.dtype.__name__) == (f.shape, f.split, f.dtype.__name__)

    @pytest.mark.parametrize("split", SPLITS)
    @pytest.mark.parametrize("args", [(10,), (2, 11), (1, 20, 3), (0.0, 2.5, 0.5)])
    def test_arange(self, args, split):
        _same(htt.arange(*args, split=split), ht_tpu.arange(*args, split=split))

    def test_asarray_and_is_split(self):
        x = _data((8, 3))
        _same(htt.asarray(x), ht_tpu.asarray(x))
        _same(htt.array(x, is_split=0), ht_tpu.array(x, is_split=0))

    def test_astype_and_resplit(self):
        x = _data((9, 4))
        a, b = htt.array(x, split=0), ht_tpu.array(x, split=0)
        _same(a.astype(htt.float64), b.astype(ht_tpu.float64))
        _same(a.resplit(None), b.resplit(None))
        _same(htt.array(x).resplit(0), ht_tpu.array(x).resplit(0))


class TestBinaryOps:
    OPS = [("add", "+"), ("sub", "-"), ("mul", "*"), ("div", "/"), ("pow", "**")]

    @pytest.mark.parametrize("split", SPLITS)
    @pytest.mark.parametrize("op", [o for o, _ in OPS])
    @pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int64])
    def test_array_array(self, op, dtype, split):
        x = _data((7, 5), dtype, seed=1)
        y = _data((7, 5), dtype, seed=2)
        if op == "pow":
            x, y = np.abs(x) + 1, (np.abs(y) % 3).astype(dtype)
        if op == "div" and np.issubdtype(dtype, np.integer):
            y[y == 0] = 1
        got = getattr(htt, op)(htt.array(x, split=split), htt.array(y, split=split))
        ref = getattr(ht_tpu, op)(ht_tpu.array(x, split=split), ht_tpu.array(y, split=split))
        _same(got, ref, rtol=_tol(ref) if op == "pow" else 0.0)

    @pytest.mark.parametrize("split", SPLITS)
    @pytest.mark.parametrize("scalar", [2, 1.5])
    @pytest.mark.parametrize("dtype", [np.float32, np.int64])
    def test_array_scalar(self, scalar, dtype, split):
        x = _data((6, 3), dtype, seed=3)
        a, b = htt.array(x, split=split), ht_tpu.array(x, split=split)
        _same(a * scalar + 1, b * scalar + 1)
        _same(scalar - a, scalar - b)
        _same(a / scalar, b / scalar)
        _same(-a, -b)

    @pytest.mark.parametrize("split", SPLITS)
    def test_broadcast_against_replicated_row(self, split):
        x, v = _data((9, 4), seed=4), _data((4,), seed=5)
        _same(htt.array(x, split=split) - htt.array(v), ht_tpu.array(x, split=split) - ht_tpu.array(v))
        _same(htt.array(x, split=split) * htt.array(x), ht_tpu.array(x, split=split) * ht_tpu.array(x))

    def test_mismatched_splits_raise(self):
        x = _data((4, 4))
        with pytest.raises(ValueError, match="resplit"):
            htt.array(x, split=0) + htt.array(x, split=1)

    @pytest.mark.parametrize("split", SPLITS)
    @pytest.mark.parametrize("fn", ["exp", "sqrt", "log"])
    @pytest.mark.parametrize("dtype", [np.float32, np.int64])
    def test_exponential(self, fn, dtype, split):
        x = np.abs(_data((6, 4), dtype, seed=6)) + 1
        got = getattr(htt, fn)(htt.array(x, split=split))
        ref = getattr(ht_tpu, fn)(ht_tpu.array(x, split=split))
        _same(got, ref, rtol=_tol(ref))


class TestReductions:
    @pytest.mark.parametrize("split", SPLITS)
    @pytest.mark.parametrize("axis", [None, 0, 1])
    @pytest.mark.parametrize("keepdims", [False, True])
    @pytest.mark.parametrize("name", ["sum", "min", "max"])
    @pytest.mark.parametrize("dtype", [np.float32, np.int32])
    def test_sum_min_max(self, name, axis, keepdims, split, dtype):
        x = _data((11, 5), dtype, seed=7)
        got = getattr(htt, name)(htt.array(x, split=split), axis=axis, keepdims=keepdims)
        ref = getattr(ht_tpu, name)(ht_tpu.array(x, split=split), axis=axis, keepdims=keepdims)
        _same(got, ref, rtol=1e-6 if dtype == np.float32 and name == "sum" else 0.0)

    @pytest.mark.parametrize("split", SPLITS)
    @pytest.mark.parametrize("axis", [None, 0, 1])
    @pytest.mark.parametrize("name", ["mean", "var", "std"])
    @pytest.mark.parametrize("dtype", [np.float32, np.float64])
    def test_mean_var_std(self, name, axis, split, dtype):
        x = _data((13, 6), dtype, seed=8) * 3 + 2
        got = getattr(htt, name)(htt.array(x, split=split), axis=axis)
        ref = getattr(ht_tpu, name)(ht_tpu.array(x, split=split), axis=axis)
        # f32 moments: the summation order differs (the moments path is
        # Welford-merged), so 1e-5 relative; f64 to 1e-12
        _same(got, ref, rtol=1e-12 if dtype == np.float64 else 1e-5)

    def test_var_ddof(self):
        x = _data((10, 3), seed=9)
        for ddof in (0, 1):
            _same(htt.var(htt.array(x, split=0), axis=0, ddof=ddof),
                  ht_tpu.var(ht_tpu.array(x, split=0), axis=0, ddof=ddof), rtol=1e-5)
        with pytest.raises(ValueError):
            htt.var(htt.array(x), ddof=2)
