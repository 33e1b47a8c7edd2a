"""Exact-type products, the wide unsigned types, float ``arange`` and
``DNDarray.median`` of heat_tpu_torch against heat_tpu.

One numpy input, drawn from a seed over the whole range of its type (so
that unsigned values cross 2^31 and 2^63), goes through both packages:
heat_tpu on its 8-device CPU mesh with 64-bit types on, heat_tpu_torch as
a world of one rank on the CPU. Results of exact types must equal the
reference's bit for bit, with its type and split; float results within
1e-6 relative (float64 conversions of uint64 values, whose last bits
round).

* ``matmul``, ``dot``, ``outer`` and ``vecdot`` of bool and of every
  integer type wrap as the reference's product does (bool is True where
  some pair is); the 16-bit-limb route the port takes is also held to
  numpy with the contraction cut into chunks.
* ``uint16``, ``uint32`` and ``uint64`` take every elementwise operation,
  comparison, reduction, mask, ``where``, sort and product the reference
  takes.
* ``arange`` with float arguments gives numpy's (and ``jnp.arange``'s)
  elements exactly.
* ``x.median()`` is a method, as in the reference.
"""

import numpy as np
import pytest

import heat_tpu as ht_tpu

import heat_tpu_torch as htt
from heat_tpu_torch.core.linalg import basics


@pytest.fixture(autouse=True)
def on_cpu():
    htt.use_device("cpu")
    yield
    htt.use_device(None)


EXACT = ["bool", "int8", "int16", "int32", "int64", "uint8", "uint16", "uint32", "uint64"]
WIDE = ["uint16", "uint32", "uint64"]


def _data(dtype, shape, seed):
    rng = np.random.default_rng(seed)
    if dtype == "bool":
        return rng.integers(0, 2, shape).astype(bool)
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, shape, dtype=dtype, endpoint=True)


def _wide(dtype, seed=0):
    """(9, 4) values of ``dtype`` across its range, with 2^31 + 7 (2^15 + 7
    for uint16), the largest value and 3 among them."""
    a = _data(dtype, (9, 4), seed)
    a[0, 0] = 2 ** 15 + 7 if dtype == "uint16" else 2 ** 31 + 7
    a[1, 1] = np.iinfo(dtype).max
    a[2, 2] = 3
    if dtype == "uint64":
        a[3, 3] = 2 ** 63 + 11
    return a


def _check(got, ref, rtol=0.0):
    assert got.dtype.__name__ == ref.dtype.__name__
    assert got.shape == tuple(ref.shape) and got.split == ref.split
    g, r = got.numpy(), np.asarray(ref.numpy())
    if rtol:
        np.testing.assert_allclose(g, r, rtol=rtol)
    else:
        np.testing.assert_array_equal(g, r)


SPLIT_PAIRS = [(None, None), (0, None), (1, 0), (None, 1), (0, 1)]


@pytest.mark.parametrize("sa,sb", SPLIT_PAIRS)
@pytest.mark.parametrize("dtype", EXACT)
def test_matmul_of_exact_types_wraps_as_the_reference(dtype, sa, sb):
    a, b = _data(dtype, (7, 5), 1), _data(dtype, (5, 6), 2)
    _check(htt.array(a, split=sa) @ htt.array(b, split=sb),
           ht_tpu.array(a, split=sa) @ ht_tpu.array(b, split=sb))


@pytest.mark.parametrize("split", [None, 0])
@pytest.mark.parametrize("dtype", EXACT)
def test_dot_outer_vecdot_of_exact_types(dtype, split):
    a, b = _data(dtype, (11,), 3), _data(dtype, (11,), 4)
    for fn in (lambda ht, x, y: ht.dot(x, y), lambda ht, x, y: ht.outer(x, y),
               lambda ht, x, y: ht.vecdot(x, y)):
        _check(fn(htt, htt.array(a, split=split), htt.array(b, split=split)),
               fn(ht_tpu, ht_tpu.array(a, split=split), ht_tpu.array(b, split=split)))


@pytest.mark.parametrize("dtype", EXACT)
def test_exact_products_over_contraction_chunks(dtype, monkeypatch):
    """The limb products summed over contraction chunks (shrunk here to 4
    terms) equal numpy's product in the same type."""
    monkeypatch.setattr(basics, "_EXACT_K", 4)
    a, b = _data(dtype, (6, 13), 5), _data(dtype, (13, 3), 6)
    got = htt.array(a) @ htt.array(b)
    with np.errstate(over="ignore"):
        want = (a.astype(np.int64) @ b.astype(np.int64)) > 0 if dtype == "bool" else a @ b
    np.testing.assert_array_equal(got.numpy(), want)


WIDE_OPS = {
    "add": lambda ht, x, y: x + y,
    "add_scalar": lambda ht, x, y: x + 2,
    "gt": lambda ht, x, y: x > y,
    "gt_scalar": lambda ht, x, y: x > 2,
    "mask": lambda ht, x, y: x[x > 2],
    "max": lambda ht, x, y: ht.max(x),
    "min_axis": lambda ht, x, y: ht.min(x, axis=0),
    "argmax": lambda ht, x, y: ht.argmax(x),
    "argmin_axis": lambda ht, x, y: ht.argmin(x, axis=0),
    "where": lambda ht, x, y: ht.where(x > y, x, y),
    "matmul": lambda ht, x, y: x @ y.T,
    "dot": lambda ht, x, y: ht.dot(x[:, 0], y[:, 0]),
    "cumsum": lambda ht, x, y: ht.cumsum(x, 0),
    "sort": lambda ht, x, y: ht.sort(x, axis=0)[0],
}
MORE_OPS = {
    "sub": lambda ht, x, y: x - y,
    "mul": lambda ht, x, y: x * y,
    "floordiv": lambda ht, x, y: x // (y + 1),
    "mod": lambda ht, x, y: x % (y + 1),
    "mod_scalar": lambda ht, x, y: x % 5,
    "fmod": lambda ht, x, y: ht.fmod(x, y + 1),
    "div": lambda ht, x, y: x / (y + 1),
    "neg": lambda ht, x, y: -x,
    "abs": lambda ht, x, y: ht.abs(x),
    "sign": lambda ht, x, y: ht.sign(x),
    "pow": lambda ht, x, y: x ** 2,
    "le": lambda ht, x, y: x <= y,
    "eq": lambda ht, x, y: x == y,
    "gt_past_range": lambda ht, x, y: x > 70000,
    "where_nonzero": lambda ht, x, y: ht.where(x > 2),
    "maximum": lambda ht, x, y: ht.maximum(x, y),
    "minimum": lambda ht, x, y: ht.minimum(x, y),
    "clip": lambda ht, x, y: ht.clip(x, 3, 2 ** 31),
    "and": lambda ht, x, y: x & y,
    "xor": lambda ht, x, y: x ^ y,
    "invert": lambda ht, x, y: ~x,
    "left_shift": lambda ht, x, y: x << 1,
    "right_shift": lambda ht, x, y: x >> 1,
    "right_shift_3": lambda ht, x, y: x >> 3,
    "cumprod": lambda ht, x, y: ht.cumprod(x, 1),
    "diff": lambda ht, x, y: ht.diff(x, axis=0),
    "sum": lambda ht, x, y: ht.sum(x, 0),
    "prod": lambda ht, x, y: ht.prod(x, 1),
    "mean": lambda ht, x, y: ht.mean(x, 0),
    "to_float32": lambda ht, x, y: x.astype(ht.float32),
    "to_float64": lambda ht, x, y: x.astype(ht.float64),
    "to_int8": lambda ht, x, y: x.astype(ht.int8),
    "sort_descending": lambda ht, x, y: ht.sort(x, axis=1, descending=True)[0],
    "unique": lambda ht, x, y: ht.unique(x),
    "topk": lambda ht, x, y: ht.topk(x, 2, dim=0)[0],
    "percentile": lambda ht, x, y: ht.percentile(x, 50.0, axis=0),
    "flip": lambda ht, x, y: ht.flip(x, 0),
    "roll": lambda ht, x, y: ht.roll(x, 1, 0),
    "nonzero": lambda ht, x, y: ht.nonzero(x),
    "bincount": lambda ht, x, y: ht.bincount((x % 5).flatten()),
    "histc": lambda ht, x, y: ht.histc(x, bins=4),
    "outer": lambda ht, x, y: ht.outer(x[:, 0], y[:, 1]),
    "setitem_mask": lambda ht, x, y: x.__setitem__(x > 2, 0) or x,
}


def _run_wide(op, dtype, split):
    a, b = _wide(dtype, 0), _wide(dtype, 1)
    got = op(htt, htt.array(a, split=split), htt.array(b, split=split))
    ref = op(ht_tpu, ht_tpu.array(a, split=split), ht_tpu.array(b, split=split))
    inexact = ref.dtype.__name__.startswith("float")
    _check(got, ref, rtol=1e-6 if inexact else 0.0)


@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("name", list(WIDE_OPS))
@pytest.mark.parametrize("dtype", WIDE)
def test_wide_unsigned_operations_match_the_reference(dtype, name, split):
    _run_wide(WIDE_OPS[name], dtype, split)


@pytest.mark.parametrize("name", list(MORE_OPS))
@pytest.mark.parametrize("dtype", WIDE)
def test_more_wide_unsigned_operations_match_the_reference(dtype, name):
    _run_wide(MORE_OPS[name], dtype, 0)


def test_uint64_division_past_two_to_the_63():
    """Quotients and remainders of uint64 values and divisors on both sides
    of 2^63 equal numpy's."""
    big = np.array([2 ** 64 - 1, 2 ** 63 + 5, 2 ** 63 - 1, 12345, 2 ** 63, 0], dtype=np.uint64)
    div = np.array([3, 2 ** 63 + 1, 2 ** 63 - 1, 2 ** 64 - 1, 2 ** 63, 7], dtype=np.uint64)
    x, y = htt.array(big), htt.array(div)
    np.testing.assert_array_equal((x // y).numpy(), big // div)
    np.testing.assert_array_equal((x % y).numpy(), big % div)
    np.testing.assert_array_equal((x >> 61).numpy(), big >> np.uint64(61))


ARANGE = [
    ((0.5, 3.2, 0.7), None),
    ((0.5, 3.2, 0.7), "int32"),
    ((1, 10.5, 0.3), "float32"),
    ((0.1, 5.0, 0.1), "float64"),
    ((-3.3, 20.0, 1.7), "float16"),
    ((5.0, 1.0, -0.3), None),
    ((2, 30, 3), "float32"),
    ((3.0, 1.0, 0.5), None),
    ((10,), None),
]


@pytest.mark.parametrize("split", [None, 0])
@pytest.mark.parametrize("args,dtype", ARANGE)
def test_arange_with_float_arguments_matches_the_reference(args, dtype, split):
    kw = {} if dtype is None else {"dtype": getattr(htt, dtype)}
    kw_ref = {} if dtype is None else {"dtype": getattr(ht_tpu, dtype)}
    _check(htt.arange(*args, split=split, **kw), ht_tpu.arange(*args, split=split, **kw_ref))


def test_arange_float32_elements_exactly():
    np.testing.assert_array_equal(htt.arange(0.5, 3.2, 0.7).numpy(),
                                  np.array([0.5, 1.2, 1.9000001, 2.6000001], np.float32))


@pytest.mark.parametrize("axis", [None, 0, 1])
@pytest.mark.parametrize("split", [None, 0, 1])
def test_median_is_a_method(split, axis):
    x = np.random.default_rng(7).standard_normal((9, 5)).astype(np.float32)
    _check(htt.array(x, split=split).median(axis=axis),
           ht_tpu.array(x, split=split).median(axis=axis), rtol=1e-6)
    np.testing.assert_allclose(htt.array(x, split=split).median(axis=axis).numpy(),
                               np.median(x, axis=axis), rtol=1e-6)
