"""Result types, split broadcasting, boolean variance and the TF32 flag of
heat_tpu_torch against heat_tpu.

One numpy input goes through both packages, heat_tpu on its 8-device CPU
mesh with 64-bit types on and heat_tpu_torch as a world of one rank on the
CPU. The result type must be the reference's; the values must agree to
the result type's tolerance (both compute in that type, with libraries
that may round a transcendental function by an ulp or so): exact types
equal, float16 rtol 2e-3, float32 1e-6, float64 1e-12.

The unsigned types uint16, uint32 and uint64: ``promote_types`` of every
pair with one of them is the reference's; ``sum`` of an unsigned array is
uint64 with the reference's value, split and lshape map; the true
division and transcendental functions give the reference's types; and an
operation torch has no kernel for on them gives the reference's result.

Broadcasting along the split axis: the result's split and its lshape map
over the 8 ranks must be the reference's. Its values are held to numpy's
broadcast, not to the reference's: on a mesh of more than one device the
reference adds its size-1 operand's zero padding in place of the broadcast
row (or column) on every rank but the first.
"""

import numpy as np
import pytest
import torch

import heat_tpu as ht_tpu

import heat_tpu_torch as htt
from heat_tpu_torch.core import communication as tcomm
from heat_tpu_torch.core import types as ttypes


@pytest.fixture(autouse=True)
def on_cpu():
    htt.use_device("cpu")
    yield
    htt.use_device(None)


DTYPES = ["int8", "int16", "int32", "int64", "uint8", "bool", "float16", "float32"]
NP_SCALARS = [np.int8, np.int16, np.int32, np.int64, np.uint8, np.bool_, np.float16, np.float32,
              np.float64]
ZERO_D = ["int8", "int16", "int32", "int64", "uint8", "bool", "float16", "float32", "float64"]
RTOL = {"float16": 2e-3, "float32": 1e-6, "float64": 1e-12, "complex64": 1e-6,
        "complex128": 1e-12}

OPS = {
    "div_int": lambda ht, x: x / 2,
    "div_float": lambda ht, x: x / 2.5,
    "rdiv_int": lambda ht, x: 3 / x,
    "exp": lambda ht, x: ht.exp(x),
    "sqrt": lambda ht, x: ht.sqrt(x),
    "log": lambda ht, x: ht.log(x),
    "add_int": lambda ht, x: x + 2,
    "mul_float": lambda ht, x: x * 2.5,
    "add_bool": lambda ht, x: x + True,
    "add_complex": lambda ht, x: x + 1j,
    **{f"add_np_{s.__name__}": (lambda s: lambda ht, x: x + s(1))(s) for s in NP_SCALARS},
    **{f"add_0d_{t}": (lambda t: lambda ht, x: x + ht.array(np.array(1, dtype=t)))(t)
       for t in ZERO_D},
    **{f"div_0d_{t}": (lambda t: lambda ht, x: x / ht.array(np.array(2, dtype=t)))(t)
       for t in ZERO_D},
}


def _data(dtype):
    """Non-negative values (so that sqrt and log stay real), with zeros."""
    rng = np.random.default_rng(0)
    if dtype == "bool":
        return rng.integers(0, 2, size=(7, 3)).astype(bool)
    if dtype.startswith("float"):
        return (rng.random((7, 3)) * 5).astype(dtype)
    return rng.integers(0, 20, size=(7, 3)).astype(dtype)


def _check(got, ref):
    assert got.shape == ref.shape
    assert got.split == ref.split
    assert got.dtype.__name__ == ref.dtype.__name__
    want = ref.numpy()
    rtol = RTOL.get(ref.dtype.__name__)
    if rtol is None:
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=0)


@pytest.mark.parametrize("op", list(OPS))
@pytest.mark.parametrize("dtype", DTYPES)
def test_result_type_and_values_match_reference(dtype, op):
    data = _data(dtype)
    fn = OPS[op]
    _check(fn(htt, htt.array(data, split=0)), fn(ht_tpu, ht_tpu.array(data, split=0)))


def test_the_rule_is_not_one_width_for_all():
    """bool / 2 is float64 (bool joined with a python int is int64), while
    sqrt(bool) and int32 / 2 are float32."""
    b = htt.array(np.array([True, False, True]))
    assert (b / 2).dtype is htt.float64
    assert htt.sqrt(b).dtype is htt.float32
    assert (htt.array(np.arange(3, dtype=np.int32)) / 2).dtype is htt.float32
    assert (htt.array(np.arange(3, dtype=np.int64)) / 2).dtype is htt.float64


# (shape, split) of each operand; every case runs in both operand orders
BROADCAST = [
    (((1, 5), 0), ((7, 5), 0)),
    (((1, 5), 0), ((7, 5), None)),
    (((7, 1), 1), ((7, 5), 1)),
    (((7, 1), 1), ((7, 5), None)),
    (((1, 5), None), ((7, 5), 0)),
    (((1, 5), 1), ((7, 5), 1)),
]


@pytest.mark.parametrize("swap", [False, True])
@pytest.mark.parametrize("case", range(len(BROADCAST)))
def test_broadcast_along_the_split_axis(case, swap):
    rng = np.random.default_rng(case)
    (sa, pa), (sb, pb) = BROADCAST[case]
    a = rng.standard_normal(sa).astype(np.float32)
    b = rng.standard_normal(sb).astype(np.float32)
    operands = [(a, pa), (b, pb)]
    if swap:
        operands.reverse()
    (x, px), (y, py) = operands
    got = htt.array(x, split=px) - htt.array(y, split=py)
    ref = ht_tpu.array(x, split=px) - ht_tpu.array(y, split=py)
    assert got.shape == ref.shape == (7, 5)
    assert got.split == ref.split
    np.testing.assert_array_equal(tcomm.lshape_map(got.shape, got.split, 8), ref.lshape_map)
    np.testing.assert_array_equal(got.numpy(), x - y)


@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("axis", [None, 0, 1])
@pytest.mark.parametrize("name", ["var", "std"])
def test_var_std_of_bool(name, axis, split):
    data = np.array([[True, False, True], [False, False, True]])
    got = getattr(htt, name)(htt.array(data, split=split), axis=axis)
    ref = getattr(ht_tpu, name)(ht_tpu.array(data, split=split), axis=axis)
    _check(got, ref)
    if axis is None and name == "var":
        assert got.dtype is htt.float64 and float(got.numpy()) == 0.25


@pytest.fixture
def tf32_on():
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    yield
    torch.backends.cuda.matmul.allow_tf32 = before


def test_kmeans_leaves_the_tf32_flag_as_it_was(tf32_on):
    rng = np.random.default_rng(0)
    x = htt.array(rng.standard_normal((40, 3)).astype(np.float32), split=0)
    km = htt.cluster.KMeans(n_clusters=3, max_iter=5, random_state=0).fit(x)
    assert torch.backends.cuda.matmul.allow_tf32 is True
    km.predict(x)
    assert torch.backends.cuda.matmul.allow_tf32 is True


def test_d2_restores_the_tf32_flag_when_the_product_raises(tf32_on):
    from heat_tpu_torch.cluster._kcluster import _d2

    with pytest.raises(RuntimeError):
        _d2(torch.ones((4, 3)), torch.ones((2, 5)))
    assert torch.backends.cuda.matmul.allow_tf32 is True


ALL_TYPES = ["bool", "int8", "int16", "int32", "int64", "uint8", "uint16", "uint32", "uint64",
             "float16", "bfloat16", "float32", "float64", "complex64", "complex128"]
NEW_UNSIGNED = ["uint16", "uint32", "uint64"]


@pytest.mark.parametrize("other", ALL_TYPES)
@pytest.mark.parametrize("new", NEW_UNSIGNED)
def test_unsigned_promotion_matches_reference(new, other):
    for a, b in ((new, other), (other, new)):
        got = htt.promote_types(getattr(ttypes, a), getattr(ttypes, b))
        want = ht_tpu.promote_types(getattr(ht_tpu, a), getattr(ht_tpu, b))
        assert got.__name__ == want.__name__, (a, b)
        assert got.torch_type() == getattr(torch, want.__name__)


def _unsigned_data(dtype):
    data = np.arange(24, dtype=dtype).reshape(8, 3) * np.array(37, dtype=dtype)
    if dtype == "uint64":
        data[0, 0] = np.uint64(2 ** 64 - 5)  # the sum wraps modulo 2^64, as the reference's
    return data


@pytest.mark.parametrize("axis", [None, 0, 1])
@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("dtype", ["uint8", "uint16", "uint32", "uint64"])
def test_unsigned_sum_matches_reference(dtype, split, axis):
    data = _unsigned_data(dtype)
    got = htt.sum(htt.array(data, split=split), axis=axis)
    ref = ht_tpu.sum(ht_tpu.array(data, split=split), axis=axis)
    assert got.dtype is htt.uint64 and ref.dtype.__name__ == "uint64"
    assert got.shape == ref.shape and got.split == ref.split
    assert got.larray.dtype == torch.uint64
    np.testing.assert_array_equal(got.numpy(), ref.numpy())
    if got.split is not None:
        np.testing.assert_array_equal(tcomm.lshape_map(got.shape, got.split, 8), ref.lshape_map)


@pytest.mark.parametrize("op", ["div_int", "div_float", "rdiv_int", "exp", "sqrt", "log",
                                "mul_float"])
@pytest.mark.parametrize("dtype", NEW_UNSIGNED)
def test_unsigned_result_types_match_reference(dtype, op):
    data = _data("uint8").astype(dtype)
    fn = OPS[op]
    _check(fn(htt, htt.array(data, split=0)), fn(ht_tpu, ht_tpu.array(data, split=0)))


@pytest.mark.parametrize("dtype", NEW_UNSIGNED)
def test_unsigned_multiply_keeps_the_type(dtype):
    data = _data("uint8").astype(dtype)
    got = htt.array(data, split=0) * 3
    ref = ht_tpu.array(data, split=0) * 3
    _check(got, ref)
    assert got.larray.dtype == getattr(torch, dtype)


UNCOMPUTABLE = {
    "add_int": lambda ht, x: x + 1,
    "add_self": lambda ht, x: x + x,
    "sub_self": lambda ht, x: x - x,
    "max": lambda ht, x: ht.max(x),
    "min_axis": lambda ht, x: ht.min(x, axis=0),
}


@pytest.mark.parametrize("op", list(UNCOMPUTABLE))
@pytest.mark.parametrize("dtype", NEW_UNSIGNED)
def test_unsigned_op_torch_cannot_compute_raises_type_error(dtype, op):
    """The operations torch has no kernel for on these types run on the
    signed type of their width and give the reference's result."""
    data = np.arange(6, dtype=dtype).reshape(2, 3)
    _check(UNCOMPUTABLE[op](htt, htt.array(data, split=0)),
           UNCOMPUTABLE[op](ht_tpu, ht_tpu.array(data, split=0)))
