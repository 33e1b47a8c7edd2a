"""heat_tpu_torch's elementwise API against heat_tpu: the arithmetic
(bitwise, division and remainder, shifts, powers, ``copysign``, ``hypot``,
``prod``/``nanprod``/``nansum``, ``cumsum``/``cumprod``, ``diff``), the
exponential, trigonometric and complex functions, and printing.

One numpy input from a seeded ``np.random.default_rng`` goes through both
packages: heat_tpu on its 8-device CPU mesh, heat_tpu_torch as a world of
one rank on the CPU, split None, 0 and 1 over a ragged 10 x 3 shape (10
rows over 8 devices). Shape, split, type name and the lshape map over 8
ranks must be the reference's exactly; values exactly for exact types and
bool, within rtol 1e-6 (atol 1e-6 times the result's magnitude) for
float32 and 1e-12 for float64: the two libraries round a transcendental
function, and a sum or product along the split axis, differently by an ulp
or so. Printing must give the reference's text. Cumulative operations and
``diff`` along the split axis across three gloo ranks are held to a world of
one in ``test_torch_linalg.py``'s spawned world.
"""

import numpy as np
import pytest

import heat_tpu as ht_tpu

import heat_tpu_torch as htt
from heat_tpu_torch.core import communication as tcomm

MESH = 8
SHAPE = (10, 3)
SPLITS = [None, 0, 1]
RTOL = {"float32": 1e-6, "float64": 1e-12, "complex64": 1e-6, "complex128": 1e-12}


@pytest.fixture(autouse=True)
def on_cpu():
    htt.use_device("cpu")
    yield
    htt.use_device(None)


def _data(dtype, kind="any", seed=0):
    rng = np.random.default_rng(seed)
    if dtype == "bool":
        return rng.integers(0, 2, size=SHAPE).astype(bool)
    if dtype.startswith(("int", "uint")):
        lo = 1 if kind in ("positive", "shift") else -9
        hi = 5 if kind == "shift" else 10
        return rng.integers(lo, hi, size=SHAPE).astype(dtype)
    if dtype.startswith("complex"):
        return (rng.standard_normal(SHAPE) + 1j * rng.standard_normal(SHAPE)).astype(dtype)
    if kind == "unit":
        return (rng.random(SHAPE) * 1.8 - 0.9).astype(dtype)
    if kind == "positive":
        return (rng.random(SHAPE) * 4 + 1.0).astype(dtype)
    return (rng.standard_normal(SHAPE) * 3).astype(dtype)


def _check(got, ref, rtol=None):
    """Metadata exactly; values exactly for exact types, else within the
    tolerance of the type the values were computed in (``rtol``, when it
    is not the result's)."""
    assert got.shape == ref.shape
    assert got.split == ref.split
    assert got.dtype.__name__ == ref.dtype.__name__, (got.dtype, ref.dtype)
    if got.ndim:
        np.testing.assert_array_equal(tcomm.lshape_map(got.shape, got.split, MESH),
                                      ref.lshape_map)
    g, r = got.numpy(), np.asarray(ref.numpy())
    name = got.dtype.__name__
    if name in RTOL:
        rtol = RTOL[name] if rtol is None else rtol
        finite = np.abs(r[np.isfinite(r)])
        scale = max(1.0, float(finite.max())) if finite.size else 1.0
        np.testing.assert_allclose(g, r, rtol=rtol, atol=rtol * scale)
    else:
        np.testing.assert_array_equal(g, r)


UNARY = {
    "bitwise_not": (lambda ht, x: ht.bitwise_not(x), ["int32", "int8", "bool"], "any"),
    "invert": (lambda ht, x: ht.invert(x), ["int64"], "any"),
    "invert_op": (lambda ht, x: ~x, ["int16", "bool"], "any"),
    "negative": (lambda ht, x: ht.negative(x), ["int32", "float32"], "any"),
    "positive": (lambda ht, x: ht.positive(x), ["int64", "float64"], "any"),
    "pos": (lambda ht, x: +x, ["float32"], "any"),
    "expm1": (lambda ht, x: ht.expm1(x), ["float32", "int32", "float64"], "unit"),
    "exp2": (lambda ht, x: ht.exp2(x), ["float32", "int64"], "any"),
    "log2": (lambda ht, x: ht.log2(x), ["float32", "int32"], "positive"),
    "log10": (lambda ht, x: ht.log10(x), ["float64", "int16"], "positive"),
    "log1p": (lambda ht, x: ht.log1p(x), ["float32", "int64"], "positive"),
    "square": (lambda ht, x: ht.square(x), ["float32", "int32", "int64"], "any"),
    "sin": (lambda ht, x: ht.sin(x), ["float32", "int32", "bool"], "any"),
    "cos": (lambda ht, x: ht.cos(x), ["float64", "int8"], "any"),
    "tan": (lambda ht, x: ht.tan(x), ["float32"], "unit"),
    "sinh": (lambda ht, x: ht.sinh(x), ["float32"], "unit"),
    "cosh": (lambda ht, x: ht.cosh(x), ["float32"], "unit"),
    "tanh": (lambda ht, x: ht.tanh(x), ["float32", "int64"], "any"),
    "arcsin": (lambda ht, x: ht.arcsin(x), ["float32"], "unit"),
    "asin": (lambda ht, x: ht.asin(x), ["float64"], "unit"),
    "arccos": (lambda ht, x: ht.arccos(x), ["float32"], "unit"),
    "acos": (lambda ht, x: ht.acos(x), ["float64"], "unit"),
    "arctan": (lambda ht, x: ht.arctan(x), ["float32", "int32"], "any"),
    "atan": (lambda ht, x: ht.atan(x), ["float64"], "any"),
    "arcsinh": (lambda ht, x: ht.arcsinh(x), ["float32"], "any"),
    "asinh": (lambda ht, x: ht.asinh(x), ["float64"], "any"),
    "arccosh": (lambda ht, x: ht.arccosh(x), ["float32"], "positive"),
    "acosh": (lambda ht, x: ht.acosh(x), ["float64"], "positive"),
    "arctanh": (lambda ht, x: ht.arctanh(x), ["float32"], "unit"),
    "atanh": (lambda ht, x: ht.atanh(x), ["float64"], "unit"),
    "deg2rad": (lambda ht, x: ht.deg2rad(x), ["float32", "int32"], "any"),
    "radians": (lambda ht, x: ht.radians(x), ["float64"], "any"),
    "rad2deg": (lambda ht, x: ht.rad2deg(x), ["float32", "int64"], "any"),
    "degrees": (lambda ht, x: ht.degrees(x), ["float64"], "any"),
    "sin_method": (lambda ht, x: x.sin() + x.cos() * x.tanh(), ["float32"], "any"),
    "exp_methods": (lambda ht, x: x.exp2() + x.expm1() + x.square(), ["float32"], "unit"),
    "angle": (lambda ht, x: ht.angle(x), ["complex64", "float32", "int32"], "any"),
    "angle_deg": (lambda ht, x: ht.angle(x, deg=True), ["complex128", "float64"], "any"),
    "conj": (lambda ht, x: ht.conj(x), ["complex64", "float32"], "any"),
    "conjugate": (lambda ht, x: ht.conjugate(x), ["complex128", "int32"], "any"),
    "conj_method": (lambda ht, x: x.conj(), ["complex64"], "any"),
    "imag": (lambda ht, x: ht.imag(x), ["complex64", "float32", "int64"], "any"),
    "real": (lambda ht, x: ht.real(x), ["complex128", "float64"], "any"),
}


def _unary_cases():
    return [(name, dt) for name, (_, dts, _) in UNARY.items() for dt in dts]


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("name,dtype", _unary_cases())
def test_unary(name, dtype, split):
    fn, _, kind = UNARY[name]
    x = _data(dtype, kind)
    _check(fn(htt, htt.array(x, split=split)), fn(ht_tpu, ht_tpu.array(x, split=split)))


BINARY = {
    "bitwise_and": (lambda ht, a, b: ht.bitwise_and(a, b), ["int32", "bool"], "any"),
    "bitwise_or": (lambda ht, a, b: ht.bitwise_or(a, b), ["int64", "bool"], "any"),
    "bitwise_xor": (lambda ht, a, b: ht.bitwise_xor(a, b), ["int16", "bool"], "any"),
    "and_or_xor_ops": (lambda ht, a, b: (a & b) | (a ^ 3), ["int32"], "any"),
    "left_shift": (lambda ht, a, b: ht.left_shift(a, b), ["int32", "int64"], "shift"),
    "right_shift": (lambda ht, a, b: ht.right_shift(a, b), ["int32", "int8"], "shift"),
    "shift_ops": (lambda ht, a, b: (a << b) >> 1, ["int64"], "shift"),
    "divide": (lambda ht, a, b: ht.divide(a, b), ["float32", "int32"], "positive"),
    "floordiv": (lambda ht, a, b: ht.floordiv(a, b), ["float32", "int64"], "positive"),
    "floor_divide": (lambda ht, a, b: ht.floor_divide(a, b), ["int32"], "positive"),
    "floordiv_op": (lambda ht, a, b: a // b, ["float64"], "positive"),
    "fmod": (lambda ht, a, b: ht.fmod(a, b), ["float32", "int32"], "positive"),
    "mod": (lambda ht, a, b: ht.mod(a, b), ["float32", "int64"], "positive"),
    "remainder": (lambda ht, a, b: ht.remainder(-a, b), ["float64", "int32"], "positive"),
    "mod_op": (lambda ht, a, b: (-a) % b, ["int32"], "positive"),
    "multiply": (lambda ht, a, b: ht.multiply(a, b), ["float32", "int64", "bool"], "any"),
    "subtract": (lambda ht, a, b: ht.subtract(a, b), ["float32", "int32"], "any"),
    "power": (lambda ht, a, b: ht.power(a, b), ["float32", "int32"], "shift"),
    "copysign": (lambda ht, a, b: ht.copysign(a, b), ["float32", "int32"], "any"),
    "hypot": (lambda ht, a, b: ht.hypot(a, b), ["float32", "float64", "int64"], "any"),
    "logaddexp": (lambda ht, a, b: ht.logaddexp(a, b), ["float32", "int32"], "any"),
    "logaddexp2": (lambda ht, a, b: ht.logaddexp2(a, b), ["float64"], "any"),
    "arctan2": (lambda ht, a, b: ht.arctan2(a, b), ["float32", "int32"], "any"),
    "atan2": (lambda ht, a, b: ht.atan2(a, b), ["float64"], "any"),
    "maximum": (lambda ht, a, b: ht.maximum(a, b), ["float32", "int32"], "any"),
    "minimum": (lambda ht, a, b: ht.minimum(a, b), ["float64", "int64"], "any"),
    "scalar_mix": (lambda ht, a, b: ht.hypot(a, 2) + ht.fmod(a, 3) * ht.power(b, 2),
                   ["float32", "int32"], "positive"),
}


def _binary_cases():
    return [(name, dt) for name, (_, dts, _) in BINARY.items() for dt in dts]


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("name,dtype", _binary_cases())
def test_binary(name, dtype, split):
    fn, _, kind = BINARY[name]
    a, b = _data(dtype, kind, 0), _data(dtype, kind, 1)
    _check(fn(htt, htt.array(a, split=split), htt.array(b, split=split)),
           fn(ht_tpu, ht_tpu.array(a, split=split), ht_tpu.array(b, split=split)))


def test_bitwise_refuses_floats():
    for ht in (htt, ht_tpu):
        x = ht.array(np.ones(3, np.float32))
        for fn in (ht.bitwise_and, ht.bitwise_or, ht.left_shift):
            with pytest.raises(TypeError):
                fn(x, x)
        with pytest.raises(TypeError):
            ht.bitwise_not(x)
        with pytest.raises(TypeError):
            ht.bitwise_xor(ht.array(np.ones(3, np.int32)), 1.5)


REDUCTIONS = {
    "prod": lambda ht, x, ax, kd: ht.prod(x, axis=ax, keepdims=kd),
    "nansum": lambda ht, x, ax, kd: ht.nansum(x, axis=ax, keepdims=kd),
    "nanprod": lambda ht, x, ax, kd: ht.nanprod(x, axis=ax, keepdims=kd),
    "prod_method": lambda ht, x, ax, kd: x.prod(ax, keepdims=kd),
}


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("axis,keepdims", [(None, False), (0, False), (1, True), ((0, 1), True)])
@pytest.mark.parametrize("dtype", ["float32", "float64", "int32", "bool"])
@pytest.mark.parametrize("name", list(REDUCTIONS))
def test_products_and_nan_sums(name, dtype, axis, keepdims, split):
    x = _data(dtype, "unit")
    if dtype.startswith("float"):
        x = (x + 1.0).astype(dtype)
        x[2, 1] = x[7, 0] = np.nan
    fn = REDUCTIONS[name]
    _check(fn(htt, htt.array(x, split=split), axis, keepdims),
           fn(ht_tpu, ht_tpu.array(x, split=split), axis, keepdims))


CUMULATIVE = {
    "cumsum": lambda ht, x, ax: ht.cumsum(x, ax),
    "cumprod": lambda ht, x, ax: ht.cumprod(x, ax),
    "cumproduct": lambda ht, x, ax: ht.cumproduct(x, ax),
    "cumsum_dtype": lambda ht, x, ax: ht.cumsum(x, ax, dtype=ht.float64),
    "cumsum_method": lambda ht, x, ax: x.cumsum(ax),
    "cumprod_method": lambda ht, x, ax: x.cumprod(ax),
    "diff": lambda ht, x, ax: ht.diff(x, axis=ax),
    "diff_2": lambda ht, x, ax: ht.diff(x, n=2, axis=ax),
}


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("axis", [0, 1, -1])
@pytest.mark.parametrize("dtype", ["float32", "int32", "int64", "bool", "uint8"])
@pytest.mark.parametrize("name", list(CUMULATIVE))
def test_cumulative_and_diff(name, dtype, axis, split):
    x = _data(dtype, "unit")
    if dtype.startswith("float"):
        x = (x + 1.0).astype(dtype)
    if dtype == "uint8":
        x = np.abs(_data("int32")).astype("uint8") % 3
    fn = CUMULATIVE[name]
    # a float32 cumulation cast to float64 keeps float32's rounding
    _check(fn(htt, htt.array(x, split=split), axis), fn(ht_tpu, ht_tpu.array(x, split=split), axis),
           rtol=RTOL["float32"] if dtype == "float32" else None)


def test_cumulative_out_and_errors():
    x = np.arange(12, dtype=np.float32).reshape(4, 3)
    for ht in (htt, ht_tpu):
        out = ht.zeros((4, 3), dtype=ht.float64, split=0)
        res = ht.cumsum(ht.array(x, split=0), 0, out=out)
        assert res is out and out.dtype.__name__ == "float64"
        np.testing.assert_array_equal(out.numpy(), np.cumsum(x, 0))
        with pytest.raises(TypeError):
            ht.cumsum(ht.array(x), (0, 1))
        with pytest.raises(ValueError):
            ht.diff(ht.array(x), n=-1)
        assert ht.diff(ht.array(x), n=0).shape == (4, 3)


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("dtype", ["float32", "int32", "bool", "float64", "complex64"])
def test_printing_matches_heat_tpu(dtype, split):
    x = _data(dtype)
    assert str(htt.array(x, split=split)) == str(ht_tpu.array(x, split=split))
    assert repr(htt.array(x[:, :1], split=split)) == repr(ht_tpu.array(x[:, :1], split=split))


@pytest.mark.parametrize("split", [None, 0, 1, 2])
@pytest.mark.parametrize("shape", [(10, 7, 9), (3, 400, 2), (1001, 1, 1), (7, 3, 5)])
def test_summarised_printing_gathers_only_edge_items(shape, split, monkeypatch):
    """Above the threshold the text is the JAX package's, and the whole
    array is never gathered."""
    x = np.random.default_rng(3).standard_normal(shape).astype(np.float32) * 100
    ref = str(ht_tpu.array(x, split=split))
    a = htt.array(x, split=split)
    if x.size > np.get_printoptions()["threshold"]:
        monkeypatch.setattr(type(a), "numpy", lambda self: pytest.fail("gathered the whole array"))
    assert str(a) == ref
    with np.printoptions(edgeitems=1, threshold=20, precision=2):
        assert repr(htt.array(x, split=split)) == repr(ht_tpu.array(x, split=split))


def test_print_options():
    before = htt.get_printoptions()
    try:
        htt.set_printoptions(precision=2, edgeitems=1, threshold=5)
        assert htt.get_printoptions()["precision"] == 2
        x = np.linspace(0, 1, 40, dtype=np.float32).reshape(20, 2)
        assert str(htt.array(x, split=0)) == str(ht_tpu.array(x, split=0))
        htt.set_printoptions(profile="full")
        assert htt.get_printoptions()["threshold"] == ht_tpu.get_printoptions()["threshold"]
        htt.set_printoptions(profile="short")
        assert htt.get_printoptions() == ht_tpu.get_printoptions()
        htt.set_printoptions(profile="default")
        assert htt.get_printoptions()["precision"] == 4
    finally:
        np.set_printoptions(**{k: v for k, v in before.items() if k != "legacy"})


def test_exports_cover_the_reference():
    for module in ("arithmetics", "exponential", "trigonometrics", "complex_math", "printing"):
        ref = __import__(f"heat_tpu.core.{module}", fromlist=["__all__"]).__all__
        got = __import__(f"heat_tpu_torch.core.{module}", fromlist=["__all__"]).__all__
        assert sorted(got) == sorted(ref), module
        for name in ref:
            assert getattr(htt, name) is getattr(htt.core, name)
