"""heat_tpu_torch's ``unique`` against heat_tpu: flat (NaNs as one) and
along an axis (rows with a NaN distinct), with ``return_inverse``, split
None, 0, 1 and 2.

One numpy input goes through both packages: heat_tpu on its 8-device CPU
mesh, heat_tpu_torch as a world of one rank on the CPU. Values, inverse,
type, split and lshape map over 8 ranks are exact. Each distributed
``unique`` of the JAX package compiles several programs (about 5 s on the
CPU), so the cases are chosen one per route. Several ranks (gloo) are in
``test_torch_manip_ranks.py``.
"""

import numpy as np
import pytest

import heat_tpu as ht_tpu

import heat_tpu_torch as htt
from heat_tpu_torch.core import communication as tcomm

MESH = 8


@pytest.fixture(autouse=True)
def on_cpu():
    htt.use_device("cpu")
    yield
    htt.use_device(None)


def _data(shape, dtype="float32", seed=0):
    rng = np.random.default_rng(seed)
    if dtype == "bool":
        return rng.integers(0, 2, size=shape).astype(bool)
    if dtype.startswith(("int", "uint")):
        return rng.integers(0, 9, size=shape).astype(dtype)
    return (rng.standard_normal(shape) * 3).astype(dtype)


def _values(x):
    """Host values; bf16 as float32 (torch has no bf16 ``numpy()``)."""
    if x.dtype.__name__ != "bfloat16":
        return np.asarray(x.numpy())
    if isinstance(x, htt.DNDarray):
        return x._global().float().numpy()
    return np.asarray(x.numpy()).astype(np.float32)


def _check(got, ref):
    """Same shape, split, type, lshape map over 8 ranks and values; for a
    tuple or list, each element."""
    if isinstance(ref, (tuple, list)):
        assert isinstance(got, (tuple, list)) and len(got) == len(ref)
        for g, r in zip(got, ref):
            _check(g, r)
        return
    if not hasattr(ref, "split"):
        assert got == ref
        return
    assert got.shape == tuple(ref.shape), (got.shape, ref.shape)
    assert got.split == ref.split, (got.split, ref.split)
    assert got.dtype.__name__ == ref.dtype.__name__, (got.dtype, ref.dtype)
    if got.ndim:
        np.testing.assert_array_equal(tcomm.lshape_map(got.shape, got.split, MESH),
                                      ref.lshape_map)
    np.testing.assert_array_equal(_values(got), _values(ref))


def _both(call, *inputs, splits):
    got = call(htt, *(htt.array(x, split=s) for x, s in zip(inputs, splits)))
    ref = call(ht_tpu, *(ht_tpu.array(x, split=s) for x, s in zip(inputs, splits)))
    _check(got, ref)


UNIQUE_INPUTS = {
    "int1d": np.array([3, 1, 3, 2, 7, 1, 0, 2, 2, 9, 3], dtype=np.int64),
    "float_nan": np.array([2.0, np.nan, 1.0, 2.0, np.nan, -0.0, 0.0, 5.0, 1.0], np.float32),
    "bool": np.array([True, False, True, True, False]),
    "int2d": np.array([[1, 2], [3, 1], [1, 2], [0, 0], [3, 1], [1, 2], [9, 9]], np.int32),
    "float2d": np.array([[1.0, 2.0], [np.nan, 1.0], [1.0, 2.0], [np.nan, 1.0], [0.5, 0.5],
                         [1.0, 2.0], [0.5, 0.5]], np.float32),
    "int3d": (np.arange(60).reshape(5, 3, 4) % 7).astype(np.int32),
}


UNIQUE_CASES = [  # (input, split, axis, return_inverse)
    ("int1d", 0, None, True), ("float_nan", 0, None, True), ("float_nan", None, None, False),
    ("int2d", 0, None, True), ("int2d", 1, 0, True), ("float2d", 0, 0, True),
    ("int3d", 2, 1, False), ("int1d", 0, 0, True), ("bool", None, None, True),
    ("int2d", None, 1, True), ("float2d", None, 0, False), ("int3d", None, None, True),
]


@pytest.mark.parametrize("name,split,axis,inverse", UNIQUE_CASES, ids=str)
def test_unique(name, split, axis, inverse):
    x = UNIQUE_INPUTS[name]
    _both(lambda ht, a: ht.unique(a, return_inverse=inverse, axis=axis), x, splits=[split])


def test_unique_method_and_numpy():
    """The method, and the flat and row routes against numpy on every split
    (world of one alone: the JAX package's routes are held above)."""
    for name, x in UNIQUE_INPUTS.items():
        for split in [None] + list(range(x.ndim)):
            a = htt.array(x, split=split)
            assert np.array_equal(a.unique(sorted=True).numpy(), np.unique(x), equal_nan=True)
            vals, inv = htt.unique(a, return_inverse=True)
            want, want_inv = np.unique(x, return_inverse=True)
            np.testing.assert_array_equal(vals.numpy(), want)
            np.testing.assert_array_equal(inv.numpy().reshape(-1), want_inv.reshape(-1))
            for axis in range(x.ndim):
                vals, inv = htt.unique(a, return_inverse=True, axis=axis)
                want, want_inv = np.unique(x, return_inverse=True, axis=axis)
                np.testing.assert_array_equal(vals.numpy(), want)
                np.testing.assert_array_equal(inv.numpy(), want_inv.reshape(-1))


