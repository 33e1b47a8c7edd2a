"""heat_tpu_torch's distributed linear algebra and the operations under it,
against heat_tpu.

One numpy input from a seeded ``np.random.default_rng`` goes through both
packages: heat_tpu on its 8-device CPU mesh, heat_tpu_torch as a world of
one rank on the CPU. Shape, split, type name and the lshape map over the
8 ranks (the port's chunk rule at world size 8) must be the reference's
exactly; values exactly for exact types, within rtol 1e-5 for float32 over
a few hundred terms and 1e-12 for float64.

``qr`` and ``svd``: factors are unique up to column signs (the JAX
package's TSQR gives R-diagonal signs that differ from LAPACK's on the same
input, its CholeskyQR2 a positive diagonal), so Q and R are compared after
both are normalised to a non-negative R diagonal, within 1e-4 for these
well-conditioned inputs; Q·R ≈ A and QᵀQ ≈ I within 1e-5 (relative to |A|
for Q·R). A world of one takes the general path, so its R split is held to
the JAX package's on a one-device mesh, which takes the same path; the
three gloo ranks take the distributed paths and are held to the 8-device
mesh's splits.

Three gloo ranks (one spawned world) with uneven chunks, 7 rows as 3, 3, 1
and 2 columns as 1, 1, 0: the ``random`` draws split 0 and 1 and
``permutation`` of a split array (each rank draws its own chunk; bit for
bit the world of one's), ``cumsum``/``cumprod``/``diff`` along the split
axis, ``argmax``/``argmin`` ties across ranks, ``histogram``, ``histc``,
``bincount``, ``nanmean`` and ``prod``; the collectives (uint64 bits included),
``resplit`` 0 ↔ 1 through ``all_to_all`` with no ``allgather``, ``matmul``
in every split pair, TSQR with a chunk shorter than n and with
``tiles_per_proc=2``, CholeskyQR2 in both ring schedules (bit-identical)
and on a rank-deficient input (the shifted fallback), both wide paths and
``svd``; each rank against numpy, the world of one and the JAX package.
The same world runs the sparse arrays, the sparse graph paths and item
8c's estimators (``_SPARSE_CALLS``): each rank's shard (an empty shard and
m < p among them) bit for bit the JAX package's on three devices, every
product, transpose, the components, ``cg``/``lanczos``, the Laplacian (also
in blocks of 3 rows a rank), Spectral, KMedians, KMedoids' global argmin,
GaussianNB and KNN against the world of one and the JAX package.
"""

import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import heat_tpu as ht_tpu
from heat_tpu.core.communication import MeshCommunication

import heat_tpu_torch as htt
from heat_tpu_torch.core import communication as tcomm

REPO = Path(__file__).resolve().parent.parent
MESH = 8
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
        return rng.integers(-6 if dtype.startswith("int") else 0, 7, size=shape).astype(dtype)
    return (rng.standard_normal(shape) * 2).astype(dtype)


def _meta_equal(got, ref):
    assert got.shape == ref.shape
    assert got.split == ref.split
    assert got.dtype.__name__ == ref.dtype.__name__
    if got.ndim:
        np.testing.assert_array_equal(tcomm.lshape_map(got.shape, got.split, MESH),
                                      ref.lshape_map)


def _check(got, ref):
    """Metadata exactly; values exactly for exact types, else within the
    type's tolerance (scaled by the result's magnitude for f32 sums)."""
    _meta_equal(got, ref)
    g, r = got.numpy(), np.asarray(ref.numpy())
    name = got.dtype.__name__
    if name in RTOL:
        scale = max(1.0, float(np.abs(r).max())) if r.size else 1.0
        np.testing.assert_allclose(g, r, rtol=RTOL[name], atol=RTOL[name] * scale)
    else:
        np.testing.assert_array_equal(g, r)


def _both(fn, *operands):
    """``fn(ht, *arrays)`` through both packages; operands are
    ``(numpy array, split)`` pairs."""
    got = fn(htt, *(htt.array(x, split=s) for x, s in operands))
    ref = fn(ht_tpu, *(ht_tpu.array(x, split=s) for x, s in operands))
    return got, ref


SPLITS = [None, 0, 1]
MATMUL_TYPES = [("int32", "int32"), ("float32", "float32"), ("float64", "float64"),
                ("int32", "float32"), ("float32", "float64")]


@pytest.mark.parametrize("types", MATMUL_TYPES, ids=lambda t: "x".join(t))
@pytest.mark.parametrize("sb", SPLITS)
@pytest.mark.parametrize("sa", SPLITS)
def test_matmul_split_pairs(sa, sb, types):
    a, b = _data((7, 5), types[0], 1), _data((5, 3), types[1], 2)
    got, ref = _both(lambda ht, x, y: ht.matmul(x, y), (a, sa), (b, sb))
    _check(got, ref)
    got, ref = _both(lambda ht, x, y: x @ y, (a, sa), (b, sb))
    _check(got, ref)


VECTOR_CASES = {
    "vec@mat": ((5,), (5, 3)),
    "mat@vec": ((7, 5), (5,)),
    "vec@vec": ((5,), (5,)),
    "batched3d@mat": ((4, 7, 5), (5, 3)),
    "mat@batched3d": ((7, 5), (4, 5, 3)),
}


@pytest.mark.parametrize("case,sa,sb", [
    (case, sa, sb) for case, (sha, shb) in VECTOR_CASES.items()
    for sa in [None] + list(range(len(sha))) for sb in [None] + list(range(len(shb)))])
def test_matmul_vectors_and_batched(case, sa, sb):
    sha, shb = VECTOR_CASES[case]
    a, b = _data(sha, "float32", 3), _data(shb, "float32", 4)
    _check(*_both(lambda ht, x, y: ht.matmul(x, y), (a, sa), (b, sb)))


@pytest.mark.parametrize("s", SPLITS)
def test_dot_vecdot_projection(s):
    sv = s if s != 1 else 0
    a, b = _data((9,), "float32", 5), _data((9,), "float32", 6)
    _check(*_both(lambda ht, x, y: ht.dot(x, y), (a, sv), (b, None)))
    _check(*_both(lambda ht, x, y: ht.linalg.projection(x, y), (a, sv), (b, sv)))
    m, n = _data((7, 5), "float32", 7), _data((7, 5), "float32", 8)
    _check(*_both(lambda ht, x, y: ht.linalg.dot(x, y.T), (m, s), (n, s)))
    for axis in (None, 0, 1):
        for keepdims in (False, True):
            _check(*_both(lambda ht, x, y: ht.linalg.vecdot(x, y, axis=axis, keepdims=keepdims),
                          (m, s), (n, s)))


@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("sa,sb", [(None, None), (0, None), (None, 0), (0, 0)])
def test_outer(sa, sb, split):
    a, b = _data((7,), "float32", 9), _data((4,), "int32", 10)
    _check(*_both(lambda ht, x, y: ht.linalg.outer(x, y, split=split), (a, sa), (b, sb)))


@pytest.mark.parametrize("axes", [(0, 1), (1, 0)])
@pytest.mark.parametrize("offset", [-1, 0, 1])
@pytest.mark.parametrize("s", SPLITS)
@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_trace(dtype, s, offset, axes):
    a = _data((7, 5), dtype, 11)
    _check(*_both(lambda ht, x: ht.linalg.trace(x, offset=offset, axis1=axes[0], axis2=axes[1]),
                  (a, s)))


@pytest.mark.parametrize("s", SPLITS + [2])
def test_transpose_and_T(s):
    a = _data((4, 7, 5), "float32", 12)
    if s is not None:
        _check(*_both(lambda ht, x: x.T, (a, s)))
        _check(*_both(lambda ht, x: ht.linalg.transpose(x, (1, 0, 2)), (a, s)))
    m = _data((7, 5), "int32", 13)
    _check(*_both(lambda ht, x: x.T, (m, s if s != 2 else None)))
    _check(*_both(lambda ht, x: x.transpose(), (m, s if s != 2 else None)))


@pytest.mark.parametrize("k", [-1, 0, 1])
@pytest.mark.parametrize("s", SPLITS)
@pytest.mark.parametrize("op", ["tril", "triu"])
def test_tril_triu(op, s, k):
    m = _data((7, 5), "float32", 14)
    _check(*_both(lambda ht, x: getattr(ht.linalg, op)(x, k), (m, s)))
    _check(*_both(lambda ht, x: getattr(x, op)(k), (m, s)))
    if s != 1:
        v = _data((6,), "int32", 15)
        _check(*_both(lambda ht, x: getattr(ht.linalg, op)(x, k), (v, s)))


@pytest.mark.parametrize("ord", [None, 2, float("inf"), -float("inf"), 0, 3])
@pytest.mark.parametrize("s", SPLITS)
def test_vector_norm(s, ord):
    v = _data((9,), "float32", 16)
    v[2] = 0.0
    _check(*_both(lambda ht, x: ht.linalg.vector_norm(x, ord=ord), (v, s if s != 1 else 0)))
    m = _data((7, 5), "int32", 17)
    for axis in (0, 1):
        _check(*_both(lambda ht, x: ht.linalg.vector_norm(x, axis=axis, ord=ord, keepdims=True),
                      (m, s)))


@pytest.mark.parametrize("keepdims", [False, True])
@pytest.mark.parametrize("ord", [None, "fro", 1, -1, float("inf"), -float("inf")])
@pytest.mark.parametrize("s", SPLITS)
def test_matrix_norm_and_norm(s, ord, keepdims):
    m = _data((7, 5), "float32", 18)
    _check(*_both(lambda ht, x: ht.linalg.matrix_norm(x, ord=ord, keepdims=keepdims), (m, s)))
    _check(*_both(lambda ht, x: ht.linalg.matrix_norm(x, axis=(1, 0), ord=ord, keepdims=keepdims),
                  (m, s)))
    _check(*_both(lambda ht, x: ht.linalg.norm(x, ord=ord, keepdims=keepdims), (m, s)))
    _check(*_both(lambda ht, x: ht.linalg.norm(x), (m, s)))


ROUNDING = {
    "abs": lambda ht, x: ht.abs(x),
    "absolute_f64": lambda ht, x: ht.absolute(x, dtype=ht.float64),
    "fabs": lambda ht, x: ht.fabs(x),
    "ceil": lambda ht, x: ht.ceil(x),
    "floor": lambda ht, x: ht.floor(x),
    "trunc": lambda ht, x: ht.trunc(x),
    "round": lambda ht, x: ht.round(x),
    "round_1": lambda ht, x: ht.round(x * 1.37, 1),
    "round_-1": lambda ht, x: ht.round(x * 7.0, -1),
    "sign": lambda ht, x: ht.sign(x),
    "clip_int_bounds": lambda ht, x: ht.clip(x, -2, 3),
    "clip_float_bounds": lambda ht, x: ht.clip(x, -1.5, 2.5),
    "clip_min_only": lambda ht, x: ht.clip(x, 0, None),
    "modf_frac": lambda ht, x: ht.modf(x * 1.5)[0],
    "modf_int": lambda ht, x: ht.modf(x)[1],
    "method_abs": lambda ht, x: abs(x),
}
RELATIONAL = {name: (lambda name: lambda ht, x, y: getattr(ht, name)(x, y))(name)
              for name in ("eq", "ne", "lt", "le", "gt", "ge", "greater", "less_equal")}
RELATIONAL.update({
    "eq_scalar": lambda ht, x, y: x == 2,
    "lt_operator": lambda ht, x, y: x < y,
    "ne_operator": lambda ht, x, y: x != y,
})
LOGICAL = {
    "all": lambda ht, x, y: ht.all(x),
    "all_axis0": lambda ht, x, y: ht.all(x, axis=0),
    "any_axis1_keep": lambda ht, x, y: ht.any(x, axis=1, keepdims=True),
    "any": lambda ht, x, y: x.any(),
    "isclose": lambda ht, x, y: ht.isclose(x, y, atol=1.0),
    "isfinite": lambda ht, x, y: ht.isfinite(x / y),
    "isinf": lambda ht, x, y: ht.isinf(x / y),
    "isnan": lambda ht, x, y: ht.isnan(x / y),
    "isposinf": lambda ht, x, y: ht.isposinf(x / y),
    "isneginf": lambda ht, x, y: ht.isneginf(x / y),
    "logical_and": lambda ht, x, y: ht.logical_and(x, y),
    "logical_or": lambda ht, x, y: ht.logical_or(x, y),
    "logical_xor": lambda ht, x, y: ht.logical_xor(x, y),
    "logical_not": lambda ht, x, y: ht.logical_not(x),
    "signbit": lambda ht, x, y: ht.signbit(x),
}


@pytest.mark.parametrize("s", [None, 0])
@pytest.mark.parametrize("dtype", ["float32", "int32", "float64"])
@pytest.mark.parametrize("name", list(ROUNDING))
def test_rounding(name, dtype, s):
    x = _data((7, 3), dtype, 19)
    _check(*_both(ROUNDING[name], (x, s)))


# true division and signbit of bool arrays are left out: neither package
# defines them for bool the way numpy does
_BOOL_LEFT_OUT = ("isfinite", "isinf", "isnan", "isposinf", "isneginf", "signbit")


@pytest.mark.parametrize("s", [None, 0, 1])
@pytest.mark.parametrize("name,dtype", [
    (name, dtype) for name in list(RELATIONAL) + list(LOGICAL)
    for dtype in ("float32", "int32", "bool") if not (dtype == "bool" and name in _BOOL_LEFT_OUT)])
def test_relational_logical(name, dtype, s):
    fn = RELATIONAL.get(name) or LOGICAL[name]
    x, y = _data((7, 3), dtype, 20), _data((7, 3), dtype, 21)
    if dtype == "int32":
        y[0, 0] = 0  # x / 0: inf and nan
    _check(*_both(fn, (x, s), (y, s)))


def test_scalar_predicates():
    x = _data((7, 3), "float32", 22)
    for ht in (htt, ht_tpu):
        a, b = ht.array(x, split=0), ht.array(x + 1e-7, split=None)
        assert ht.equal(a, ht.array(x, split=1)) is True
        assert ht.equal(a, b) is False
        assert ht.allclose(a, b) is True
        assert ht.allclose(a, b + 1) is False
    with pytest.raises(TypeError):
        htt.sign(htt.array(np.array([True, False])))


def test_constants_memory_version():
    assert (htt.pi, htt.e, htt.Euler, htt.inf) == (ht_tpu.pi, ht_tpu.e, ht_tpu.Euler, ht_tpu.inf)
    assert np.isnan(htt.nan) and htt.Inf == htt.Infinity == htt.Infty == htt.inf
    assert htt.__version__ == htt.version.version
    x = htt.array(_data((7, 3), "float32", 23), split=0)
    y = htt.copy(x)
    assert y.larray.data_ptr() != x.larray.data_ptr()
    np.testing.assert_array_equal(y.numpy(), x.numpy())
    assert (y.split, y.shape, y.dtype) == (x.split, x.shape, x.dtype)
    assert htt.sanitize_memory_layout(x, "F") is x
    with pytest.raises(ValueError):
        htt.sanitize_memory_layout(x, "K")
    with pytest.raises(TypeError):
        htt.copy(x.larray)


def test_exports_cover_the_reference():
    names = (list(ht_tpu.core.linalg.basics.__all__) + ["qr", "svd"]
             + ht_tpu.core.rounding.__all__ + ht_tpu.core.relational.__all__
             + ht_tpu.core.logical.__all__)
    for name in names:
        assert callable(getattr(htt, name, None)), name
    for name in list(ht_tpu.core.linalg.basics.__all__) + ["qr", "svd"]:
        assert callable(getattr(htt.linalg, name)), name
    for name in ("constants", "copy", "sanitize_memory_layout"):
        assert hasattr(htt, name), name


# ------------------------------------------------------------- qr and svd

QR_CASES = [((20, 5), 0), ((64, 12), 0), ((50, 12), 1), ((10, 30), 0), ((10, 30), 1),
            ((9, 9), None)]


def _one_device():
    return MeshCommunication(devices=jax.devices()[:1])


def _sign_normalised(q, r):
    d = np.sign(np.diagonal(r))
    d[d == 0] = 1
    return q * d[None, :], r * d[:, None]


def _qr_checks(q, r, a, tol=1e-5):
    scale = max(1.0, float(np.abs(a).max()))
    np.testing.assert_allclose(q @ r, a, rtol=0, atol=tol * scale)
    np.testing.assert_allclose(q.T @ q, np.eye(q.shape[1]), rtol=0, atol=tol)


@pytest.mark.parametrize("shape,split", QR_CASES)
def test_qr_paths_match_heat_tpu(shape, split):
    a = _data(shape, "float32", 24)
    got = htt.linalg.qr(htt.array(a, split=split))
    ref = ht_tpu.linalg.qr(ht_tpu.array(a, split=split))
    one = ht_tpu.linalg.qr(ht_tpu.array(a, split=split, comm=_one_device()))
    for g, r, o in ((got.Q, ref.Q, one.Q), (got.R, ref.R, one.R)):
        assert g.shape == r.shape and g.dtype.__name__ == r.dtype.__name__
        assert g.split == o.split  # the world of one takes the one-device path
    assert got.Q.split == ref.Q.split
    gq, gr = _sign_normalised(got.Q.numpy(), got.R.numpy())
    rq, rr = _sign_normalised(np.asarray(ref.Q.numpy()), np.asarray(ref.R.numpy()))
    np.testing.assert_allclose(gq, rq, rtol=0, atol=1e-4)
    np.testing.assert_allclose(gr, rr, rtol=0, atol=1e-4 * max(1.0, float(np.abs(rr).max())))
    _qr_checks(got.Q.numpy(), got.R.numpy(), a)
    r_only = htt.linalg.qr(htt.array(a, split=split), calc_q=False)
    assert r_only.Q is None
    np.testing.assert_array_equal(r_only.R.numpy(), got.R.numpy())


@pytest.mark.parametrize("shape,split", QR_CASES[:3] + [((10, 30), 0), ((10, 30), 1)])
def test_svd_matches_heat_tpu(shape, split):
    a = _data(shape, "float32", 25)
    got = htt.linalg.svd(htt.array(a, split=split))
    ref = ht_tpu.linalg.svd(ht_tpu.array(a, split=split))
    one = ht_tpu.linalg.svd(ht_tpu.array(a, split=split, comm=_one_device()))
    for g, r, o in zip(got, ref, one):
        assert g.shape == r.shape and g.dtype.__name__ == r.dtype.__name__ and g.split == o.split
    np.testing.assert_allclose(got.S.numpy(), ref.S.numpy(), rtol=1e-5,
                               atol=1e-5 * float(ref.S.numpy().max()))
    u, s, v = got.U.numpy(), got.S.numpy(), got.V.numpy()
    np.testing.assert_allclose((u * s) @ v.T, a, rtol=0, atol=1e-5 * float(np.abs(a).max()))
    np.testing.assert_allclose(u.T @ u, np.eye(u.shape[1]), rtol=0, atol=1e-5)
    vals = htt.linalg.svd(htt.array(a, split=split), compute_uv=False)
    np.testing.assert_allclose(vals.numpy(), s, rtol=1e-5, atol=1e-6)


def test_qr_svd_float64_and_ints():
    a = _data((12, 4), "float64", 26)
    q, r = htt.linalg.qr(htt.array(a, split=0))
    assert q.dtype is htt.float64
    _qr_checks(q.numpy(), r.numpy(), a, tol=1e-12)
    ai = _data((12, 4), "int32", 27)
    got, ref = htt.linalg.qr(htt.array(ai)), ht_tpu.linalg.qr(ht_tpu.array(ai))
    assert got.R.dtype.__name__ == ref.R.dtype.__name__ == "float32"
    assert htt.linalg.svd(htt.array(ai)).S.dtype is htt.float32


# ------------------------------------------------------ flags and errors


def _flags():
    m = torch.backends.cuda.matmul
    return (m.allow_tf32, m.allow_bf16_reduced_precision_reduction,
            m.allow_fp16_reduced_precision_reduction)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("caller", [False, True])
def test_matmul_leaves_the_callers_flags(dtype, caller, monkeypatch):
    m = torch.backends.cuda.matmul
    before = _flags()
    try:
        m.allow_tf32 = caller
        m.allow_bf16_reduced_precision_reduction = caller
        m.allow_fp16_reduced_precision_reduction = caller
        tdt = getattr(torch, dtype)
        a = htt.array(torch.ones((4, 3), dtype=tdt), split=0)
        seen = []
        real = torch.matmul

        def spy(x, y):
            seen.append(_flags())
            return real(x, y)

        monkeypatch.setattr(torch, "matmul", spy)
        res = a @ a.T
        assert res.dtype.__name__ == dtype
        res.larray  # a deferred product (fusion) runs at the read
        assert seen
        reduced = {"bfloat16": 1, "float16": 2}.get(dtype)
        for flags in seen:
            assert flags[0] == caller  # f32: the caller's TF32 flag, read and never set
            if reduced is not None:
                assert flags[reduced] is False  # bf16/f16: f32 accumulation
        assert _flags() == (caller, caller, caller)

        def boom(x, y):
            raise RuntimeError("product failed")

        monkeypatch.setattr(torch, "matmul", boom)
        with pytest.raises(RuntimeError, match="product failed"):
            (a @ a.T).larray
        assert _flags() == (caller, caller, caller)
    finally:
        m.allow_tf32, m.allow_bf16_reduced_precision_reduction, \
            m.allow_fp16_reduced_precision_reduction = before


def test_matmul_does_not_copy_an_operand_of_the_result_type():
    a = htt.array(_data((6, 4), "float32", 28), split=0)
    b = htt.array(_data((4, 5), "float32", 29), split=0)
    seen = []
    real = torch.matmul

    def spy(x, y):
        seen.append((x.data_ptr(), y.data_ptr()))
        return real(x, y)

    torch.matmul, saved = spy, torch.matmul
    try:
        (a @ b).larray  # the product runs at the read when it is deferred (fusion)
    finally:
        torch.matmul = saved
    assert seen == [(a.larray.data_ptr(), b.larray.data_ptr())]


def test_errors():
    a = htt.array(_data((7, 5), "float32", 30), split=0)
    with pytest.raises(ValueError, match="last dimension"):
        htt.matmul(a, a)
    with pytest.raises(ValueError, match="not aligned"):
        htt.dot(htt.array(np.ones(3)), htt.array(np.ones(4)))
    with pytest.raises(TypeError):
        htt.matmul(a, a.larray)
    # the audit runs now (it raised until the telemetry port): a world of
    # one issues no collective, and the factors are the unaudited ones
    q, r = htt.linalg.qr(a, audit=True)
    q0, r0 = htt.linalg.qr(a)
    assert torch.equal(q.larray, q0.larray) and torch.equal(r.larray, r0.larray)
    with pytest.raises(ValueError, match="2-dimensional"):
        htt.linalg.qr(htt.array(np.ones(3)))
    with pytest.raises(TypeError, match="tiles_per_proc"):
        htt.linalg.qr(a, tiles_per_proc=1.5)
    with pytest.raises(ValueError, match="Invalid norm order"):
        htt.linalg.matrix_norm(a, ord=3)
    with pytest.raises(ValueError, match="either min or max"):
        htt.clip(a, None, None)
    for ht in (htt, ht_tpu):
        with pytest.raises(NotImplementedError, match="decimals < 0"):
            ht.round(ht.array(np.arange(4)), -1)
    comm = htt.get_comm()
    # the compressed wires run now (item 12): on a world of one the
    # reductions move nothing and a hop delivers the wire's round trip, the
    # JAX package's local_roundtrip bit for bit
    from heat_tpu.core import collective_prec as jcp

    assert comm.reduce_scatter(a.larray, 0, 7, precision="bf16") is a.larray
    assert comm.all_to_all(a.larray, 1, 0, 5, precision="int8") is a.larray
    for hop, mode in ((lambda m: comm.ring_permute(a.larray, precision=m), "blockwise"),
                      (lambda m: comm.ppermute(a.larray, [(0, 0)], precision=m), "bf16")):
        want = np.asarray(jcp.local_roundtrip(jax.numpy.asarray(a.larray.numpy()), mode))
        np.testing.assert_array_equal(hop(mode).numpy(), want)
    # the JAX package raises the same errors
    ra = ht_tpu.array(_data((7, 5), "float32", 30), split=0)
    with pytest.raises(ValueError, match="last dimension"):
        ht_tpu.matmul(ra, ra)


def test_collectives_world_of_one():
    comm = htt.get_comm()
    t = torch.arange(12.0).reshape(4, 3)
    assert comm.reduce_scatter(t, 0, 4) is t
    assert comm.all_to_all(t, 1, 0, 3) is t
    assert torch.equal(comm.ring_permute(t), t)
    assert torch.equal(comm.ppermute(t, [(0, 0)], async_op=True).wait(), t)
    assert torch.equal(comm.ppermute(t, []), torch.zeros_like(t))  # no source: zeros
    x = htt.array(t.numpy(), split=0)
    y = x.resplit(1)
    assert y.split == 1 and torch.equal(y.larray, t) and y.larray.data_ptr() != t.data_ptr()


# ------------------------------------------------- three gloo ranks

_WORKER = textwrap.dedent("""
    import os, sys, time
    import numpy as np
    import torch
    import torch.distributed as dist
    rank, world, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    import heat_tpu_torch as ht
    from heat_tpu_torch.core.communication import TorchCommunication
    ht.use_device("cpu")
    comm = ht.get_comm()
    res = {}

    def keep(name, x):
        res[name] = x.numpy()
        res[name + "_meta"] = np.array([x.dtype.__name__, str(x.split), str(tuple(x.lshape))])
        res[name + "_local"] = x.larray.numpy()

    rng = np.random.default_rng(0)
    base = rng.standard_normal((7, 4)).astype(np.float32)
    big = np.array([2 ** 63 + 5, 2 ** 64 - 3, 7, 2 ** 40], dtype=np.uint64)
    # reduce_scatter: every rank contributes (rank + 1) * base
    res["rs0"] = comm.reduce_scatter(torch.from_numpy(base * (rank + 1)), 0, 7).numpy()
    res["rs1"] = comm.reduce_scatter(torch.from_numpy(base * (rank + 1)), 1, 4).numpy()
    res["rs_max"] = comm.reduce_scatter(torch.from_numpy(base * (rank + 1)), 0, 7, "max").numpy()
    res["rs_u64"] = comm.reduce_scatter(torch.from_numpy(big * np.uint64(rank + 1)), 0, 4).numpy()
    # all_to_all: rows (3, 3, 1) in, columns (1, 1, 0) out
    x72 = rng.standard_normal((7, 2)).astype(np.float32)
    mine = ht.array(x72, split=0).larray
    res["a2a"] = comm.all_to_all(mine, 1, 0, 2, 7).numpy()
    res["a2a_found_n"] = comm.all_to_all(mine, 1, 0, 2).numpy()
    u72 = (np.arange(14, dtype=np.uint64) * np.uint64(2 ** 61)).reshape(7, 2)
    res["a2a_u64"] = comm.all_to_all(ht.array(u72, split=0).larray, 1, 0, 2, 7).numpy()
    # ring_permute and ppermute
    mark = torch.full((3,), float(rank))
    res["ring"] = comm.ring_permute(mark).numpy()
    res["ring_back"] = comm.ring_permute(mark, shift=-1).numpy()
    res["ring_async"] = comm.ring_permute(mark, async_op=True).wait().numpy()
    res["ring_u64"] = comm.ring_permute(torch.from_numpy(big + np.uint64(rank))).numpy()
    res["pperm"] = comm.ppermute(mark, [(0, 2), (2, 0)]).numpy()
    # resplit 0 <-> 1 through all_to_all, with allgather counted
    calls = []
    real = TorchCommunication.allgather
    x75 = rng.standard_normal((7, 5)).astype(np.float32)
    for s0, s1 in ((0, 1), (1, 0)):
        for name, data in (("x72", x72), ("x75", x75)):
            x = ht.array(data, split=s0)
            TorchCommunication.allgather = lambda self, *a, **k: (calls.append(1),
                                                                  real(self, *a, **k))[1]
            moved = x.resplit(s1)
            TorchCommunication.allgather = real
            keep(f"resplit_{name}_{s0}{s1}", moved)
    res["resplit_allgathers"] = np.array(len(calls))
    # matmul in every split pair, K = 5 and K = 2 (an empty chunk of K)
    for tag, (sa_, sb_) in (("75x53", ((7, 5), (5, 3))), ("72x25", ((7, 2), (2, 5)))):
        a = np.random.default_rng(1).standard_normal(sa_).astype(np.float32)
        b = np.random.default_rng(2).standard_normal(sb_).astype(np.float32)
        for sa in (None, 0, 1):
            for sb in (None, 0, 1):
                keep(f"mm_{tag}_{sa}_{sb}", ht.array(a, split=sa) @ ht.array(b, split=sb))
    v = np.random.default_rng(3).standard_normal(5).astype(np.float32)
    m = np.random.default_rng(1).standard_normal((7, 5)).astype(np.float32)
    b53 = np.random.default_rng(2).standard_normal((5, 3)).astype(np.float32)
    a3 = np.random.default_rng(4).standard_normal((4, 7, 5)).astype(np.float32)
    for sv in (None, 0):
        for sm in (None, 0, 1):
            keep(f"mv_{sm}_{sv}", ht.matmul(ht.array(m, split=sm), ht.array(v, split=sv)))
            keep(f"vm_{sv}_{sm}", ht.matmul(ht.array(v, split=sv), ht.array(b53, split=sm)))
    for s3 in (None, 0, 1, 2):
        for sb in (None, 0, 1):
            keep(f"b3_{s3}_{sb}", ht.matmul(ht.array(a3, split=s3), ht.array(b53, split=sb)))
    keep("trace_0", ht.linalg.trace(ht.array(m, split=0), offset=1))
    keep("trace_1", ht.linalg.trace(ht.array(m, split=1), offset=-1))
    keep("tril_0", ht.linalg.tril(ht.array(m, split=0), -1))
    keep("triu_1", ht.linalg.triu(ht.array(m, split=1), 1))
    keep("outer_1", ht.linalg.outer(ht.array(v, split=0), ht.array(v[:3], split=0), split=1))
    keep("dot", ht.dot(ht.array(v, split=0), ht.array(v, split=None)))
    keep("norm_1", ht.linalg.matrix_norm(ht.array(m, split=1), ord=1))
    # qr: TSQR (a chunk shorter than n: 7 rows as 3, 3, 1 against n = 5;
    # tiles_per_proc = 2 on 8-row chunks), CholeskyQR2 in both schedules,
    # the shifted fallback, both wide paths
    qa = {"tsqr_20x5": (np.random.default_rng(5).standard_normal((20, 5)), 0, 1),
          "tsqr_short_7x5": (np.random.default_rng(6).standard_normal((7, 5)), 0, 1),
          "tsqr_tiles_24x3": (np.random.default_rng(7).standard_normal((24, 3)), 0, 2),
          "chol_50x12": (np.random.default_rng(8).standard_normal((50, 12)), 1, 1),
          "chol_30x7": (np.random.default_rng(9).standard_normal((30, 7)), 1, 1),
          "wide0_10x30": (np.random.default_rng(10).standard_normal((10, 30)), 0, 1),
          "wide1_10x30": (np.random.default_rng(10).standard_normal((10, 30)), 1, 1)}
    for name, (data, split, tiles) in qa.items():
        q, r = ht.linalg.qr(ht.array(data.astype(np.float32), split=split), tiles_per_proc=tiles)
        keep(f"qr_{name}_Q", q)
        keep(f"qr_{name}_R", r)
    for knob in ("0", "1"):
        os.environ["HEAT_TPU_RING_OVERLAP"] = knob
        q, r = ht.linalg.qr(ht.array(qa["chol_30x7"][0].astype(np.float32), split=1))
        res[f"ring_{knob}_Q"], res[f"ring_{knob}_R"] = q.larray.numpy(), r.larray.numpy()
    os.environ.pop("HEAT_TPU_RING_OVERLAP")
    deficient = np.random.default_rng(11).standard_normal((30, 7)).astype(np.float32)
    deficient[:, 3] = 0.0
    shifted = []
    real_chol = torch.linalg.cholesky
    torch.linalg.cholesky = lambda g: (shifted.append(1), real_chol(g))[1]
    q, r = ht.linalg.qr(ht.array(deficient, split=1))
    torch.linalg.cholesky = real_chol
    keep("deficient_Q", q)
    keep("deficient_R", r)
    res["deficient_shifted"] = np.array(len(shifted))
    # svd: tall split 0, tall split 1, wide, values only
    for name, (data, split) in {"tall0": (qa["tsqr_20x5"][0], 0), "tall1": (qa["chol_50x12"][0], 1),
                                "wide0": (qa["wide0_10x30"][0], 0)}.items():
        u, s, vv = ht.linalg.svd(ht.array(data.astype(np.float32), split=split))
        keep(f"svd_{name}_U", u)
        keep(f"svd_{name}_S", s)
        keep(f"svd_{name}_V", vv)
        keep(f"svdvals_{name}", ht.linalg.svd(ht.array(data.astype(np.float32), split=split),
                                              compute_uv=False))
    # ht.random: each rank draws its own chunk of the global stream
    ht.random.seed(21)
    for name, draw in _RANDOM_CALLS(ht, base):
        keep(f"random_{name}", draw())
    # cumulative operations and diff along the split axis, argmax/argmin
    # with ties across ranks, histogram and bincount counted per rank
    for name, call in _SPLIT_AXIS_CALLS(ht, base):
        keep(f"axis_{name}", call())
    # Lasso, cg, lanczos, the Laplacian and Spectral across ranks
    for name, call in _SLICE_CALLS(ht):
        keep(f"slice_{name}", call())
    # the sparse arrays, the sparse graph paths and the estimators of item 8c
    for name, call in _SPARSE_CALLS(ht, {}):
        got = call()
        if isinstance(got, ht.sparse.SparseDNDarray):
            c = got.lnnz
            res[f"sparse_{name}_indptr"] = got.indptr.numpy()
            res[f"sparse_{name}_indices"] = got.indices[:c].numpy()
            res[f"sparse_{name}_values"] = got.values[:c].numpy()
            res[f"sparse_{name}_counts"] = got.counts
            res[f"sparse_{name}_cap"] = np.array(got.capacity)
            keep(f"sparse_{name}_dense", got.to_dense())
        else:
            keep(f"sparse_{name}", got)
    # printing above the threshold: each rank sends its edge items
    wide = np.arange(50 * 31, dtype=np.float32).reshape(50, 31) / 7
    for sp in (0, 1):
        res[f"printed_{sp}"] = np.array(str(ht.array(wide, split=sp)))
    # seed() without a value, each rank at another millisecond: rank 0's
    # clock is every rank's seed
    time.sleep(0.05 * rank)
    ht.random.seed()
    res["clock_seed"] = np.array(ht.random.get_state()[1])
    keep("random_clock_randperm", ht.random.randperm(13, split=0))
    np.savez(f"{out}/rank{rank}.npz", **res)
    dist.destroy_process_group()
""")

# the draws and the split-axis calls the gloo ranks make, in this order;
# the test makes the same calls as a world of one
_CALLS = textwrap.dedent("""
    def _RANDOM_CALLS(ht, base):
        return [
            ("rand_0", lambda: ht.random.rand(7, 4, split=0)),
            ("randn_1", lambda: ht.random.randn(7, 4, split=1)),
            ("randn_f64_0", lambda: ht.random.randn(7, 4, dtype=ht.float64, split=0)),
            ("randint_0", lambda: ht.random.randint(-5, 2 ** 31, (7, 4), dtype=ht.int64, split=0)),
            ("randint8_1", lambda: ht.random.randint(0, 100, (7, 4), dtype=ht.int8, split=1)),
            ("uniform_1", lambda: ht.random.uniform(-1.0, 2.0, (7, 4), split=1)),
            ("normal_0", lambda: ht.random.normal(3.0, 0.5, (9, 2), split=0)),
            ("randperm_0", lambda: ht.random.randperm(13, split=0)),
            ("permutation_x0", lambda: ht.random.permutation(ht.array(base, split=0))),
            ("permutation_x1", lambda: ht.random.permutation(ht.array(base, split=1))),
        ]


    def _SPLIT_AXIS_CALLS(ht, base):
        xi = (np.arange(28).reshape(7, 4) % 5 - 2).astype(np.int64)
        ties = np.zeros((7, 3), np.float32)
        ties[1], ties[4], ties[6] = 9, 9, 9  # rows of ranks 0, 1 and 2
        ties[5, 2] = 10
        return [
            ("cumsum_0", lambda: ht.cumsum(ht.array(xi, split=0), 0)),
            ("cumsum_f32_0", lambda: ht.cumsum(ht.array(base, split=0), 0)),
            ("cumprod_1", lambda: ht.cumprod(ht.array(xi + 3, split=1), 1)),
            ("cumprod_0", lambda: ht.cumprod(ht.array(base, split=0), 0)),
            ("diff_0", lambda: ht.diff(ht.array(xi, split=0), axis=0)),
            ("diff2_0", lambda: ht.diff(ht.array(base, split=0), n=2, axis=0)),
            ("diff_1", lambda: ht.diff(ht.array(xi, split=1), axis=1)),
            ("argmax_0", lambda: ht.argmax(ht.array(ties, split=0), axis=0)),
            ("argmax_flat", lambda: ht.argmax(ht.array(ties[:, :2], split=0))),
            ("argmin_0", lambda: ht.argmin(ht.array(-ties, split=0), axis=0, keepdims=True)),
            ("argmax_1", lambda: ht.argmax(ht.array(ties.T.copy(), split=1), axis=1)),
            ("histogram_0", lambda: ht.histogram(ht.array(base, split=0), bins=5)[0]),
            ("histogram_w_1", lambda: ht.histogram(ht.array(base, split=1), bins=4,
                                                   weights=ht.array(np.abs(base), split=1))[0]),
            ("histc_0", lambda: ht.histc(ht.array(base, split=0), bins=6)),
            ("bincount_0", lambda: ht.bincount(ht.array(np.arange(7) % 3, split=0), minlength=4)),
            ("bincount_w_0", lambda: ht.bincount(ht.array(np.arange(7) % 3, split=0),
                                                 weights=ht.array(base[:, 0], split=0))),
            ("nanmean_0", lambda: ht.nanmean(ht.array(np.where(base > 1, np.nan, base),
                                                      split=0), axis=0)),
            ("prod_0", lambda: ht.prod(ht.array(xi + 3, split=0), axis=0)),
        ]


    def _SLICE_CALLS(ht):
        rng = np.random.default_rng(12)
        x = rng.standard_normal((31, 5)).astype(np.float32)
        y = (x @ np.array([1.0, 0.0, -2.0, 0.5, 0.0], np.float32) + 0.3).astype(np.float32)
        m = rng.standard_normal((13, 13))
        spd = (m @ m.T + 13 * np.eye(13)).astype(np.float32)
        b = rng.standard_normal(13).astype(np.float32)
        centers = np.array([[0, 0], [6, 6], [0, 6]], np.float32)
        blobs = np.concatenate([c + 0.3 * rng.standard_normal((20, 2)) for c in centers])
        blobs = blobs[:59].astype(np.float32)
        rbf = lambda v: ht.spatial.rbf(v, sigma=1.0, quadratic_expansion=True)

        def lasso(split, y_split, **kw):
            return ht.regression.Lasso(lam=0.05, **kw).fit(ht.array(x, split=split),
                                                           ht.array(y, split=y_split))

        def partial():
            est = ht.regression.Lasso(lam=0.05, max_iter=4, tol=0.0)
            for lo, hi in ((0, 12), (12, 31)):
                est.partial_fit(ht.array(x[lo:hi], split=0), ht.array(y[lo:hi], split=0))
            return est.theta

        def spectral(split, metric):
            ht.random.seed(1)
            return ht.cluster.Spectral(n_clusters=3, gamma=1.0, metric=metric,
                                       n_lanczos=20).fit(ht.array(blobs, split=split)).labels_

        calls = [
            ("lasso_0", lambda: lasso(0, 0, max_iter=10, tol=0.0).theta),
            ("lasso_0_yrep", lambda: lasso(0, None, max_iter=10, tol=0.0).theta),
            ("lasso_1", lambda: lasso(1, None, max_iter=10, tol=0.0).theta),
            ("lasso_tol_iters", lambda: ht.array(np.array([lasso(0, 0, max_iter=100,
                                                                 tol=1e-6).n_iter]))),
            ("lasso_predict", lambda: lasso(0, 0, max_iter=10, tol=0.0).predict(
                ht.array(x, split=0))),
            ("lasso_partial", partial),
            ("cg_0", lambda: ht.linalg.cg(ht.array(spd, split=0), ht.array(b),
                                          ht.array(np.zeros(13, np.float32), split=0))),
            ("cg_1", lambda: ht.linalg.cg(ht.array(spd, split=1), ht.array(b, split=0),
                                          ht.array(np.zeros(13, np.float32)))),
            ("lanczos_V_0", lambda: ht.linalg.lanczos(ht.array(spd, split=0), 6)[0]),
            ("lanczos_T_0", lambda: ht.linalg.lanczos(ht.array(spd, split=0), 6)[1]),
            ("lanczos_T_1", lambda: ht.linalg.lanczos(ht.array(spd, split=1), 6)[1]),
        ]
        for definition in ("simple", "norm_sym"):
            for mode in ("fully_connected", "eNeighbour"):
                calls.append((f"laplacian_{definition}_{mode}", (
                    lambda d, md: lambda: ht.graph.Laplacian(
                        rbf, definition=d, mode=md, threshold_key="lower",
                        threshold_value=0.5).construct(ht.array(blobs[:20], split=0)))(
                            definition, mode)))
        calls += [
            ("spectral_rbf_0", lambda: spectral(0, "rbf")),
            ("spectral_rbf_1", lambda: spectral(1, "rbf")),
            ("spectral_manhattan_0", lambda: spectral(0, "manhattan")),
        ]
        return calls


    def _SPARSE_CALLS(ht, kw):
        # kw carries the JAX package's three-device communicator (empty for the port)
        rng = np.random.default_rng(31)
        a = (rng.standard_normal((7, 5)) * (rng.random((7, 5)) < 0.6)).astype(np.float32)
        a[1] = 0.0      # an empty row
        a[3:6] = 0.0    # rank 1's rows (3, 3, 1) all empty
        short = np.array([[0, 1.5, 0, 2], [3, 0, 0, 0]], np.float32)  # m < p: rank 2 has none
        sq = (rng.standard_normal((7, 7)) * (rng.random((7, 7)) < 0.4)).astype(np.float32)
        rows, cols = np.nonzero(sq)
        perm = rng.permutation(rows.shape[0])
        rows, cols = rows[perm], cols[perm]
        vals = sq[rows, cols]
        x5 = rng.standard_normal(5).astype(np.float32)
        X5 = rng.standard_normal((5, 3)).astype(np.float32)
        labels = np.arange(5, dtype=np.int64)[::-1].copy()
        graph = np.zeros((10, 10), np.float32)
        graph[[0, 2, 3, 5, 8, 9], [2, 7, 3, 6, 1, 4]] = 1.0  # directed edges
        m = rng.standard_normal((11, 11)) * (rng.random((11, 11)) < 0.3)
        spd = (m + m.T + np.diag(np.abs(m).sum(0) + np.abs(m).sum(1) + 1.0)).astype(np.float32)
        b = rng.standard_normal(11).astype(np.float32)
        centers = np.array([[0, 0], [6, 6], [0, 6]], np.float32)
        blobs = np.concatenate([c + 0.3 * rng.standard_normal((10, 2)) for c in centers])
        blobs = blobs[:29].astype(np.float32)
        truth = np.repeat(np.arange(3), 10)[:29]
        rbf = lambda v: ht.spatial.rbf(v, sigma=1.0, quadratic_expansion=True)
        pair = lambda u, v: ht.spatial.rbf(u, v, sigma=1.0, quadratic_expansion=True)
        A = lambda: ht.sparse.csr_from_dense(a, **kw)
        arr = lambda v, split=None: ht.array(v, split=split, **kw)

        def fitted(cls, **params):
            est = getattr(ht.cluster, cls)(n_clusters=3, random_state=2, **params)
            return est.fit(arr(blobs, 0))

        def laplacian(block_rows=None):
            # the port builds the graph in blocks of block_rows rows a rank
            mod = sys.modules[ht.graph.Laplacian.__module__]
            budget = getattr(mod, "_BLOCK_BUDGET", None)
            if block_rows is not None and budget is not None:
                mod._BLOCK_BUDGET = blobs.shape[0] * 4 * block_rows
            try:
                return ht.graph.Laplacian(
                    rbf, mode="eNeighbour", threshold_key="lower", threshold_value=0.5,
                    sparse=True, pair_similarity=pair).construct(arr(blobs, 0))
            finally:
                if budget is not None:
                    mod._BLOCK_BUDGET = budget

        def sparse_spectral():
            ht.random.seed(1)
            sp = ht.cluster.Spectral(n_clusters=3, gamma=0.5, laplacian="eNeighbour",
                                     threshold=0.05, boundary="lower", n_lanczos=20, sparse=True)
            return sp.fit(arr(blobs, 0)).labels_

        calls = [
            ("dense_np", A),
            ("dense_0", lambda: ht.sparse.csr_from_dense(arr(a, 0))),
            ("dense_none", lambda: ht.sparse.csr_from_dense(arr(a))),
            ("dense_1", lambda: ht.sparse.csr_from_dense(arr(a, 1))),
            ("short", lambda: ht.sparse.csr_from_dense(arr(short, 0))),
            ("diag_above", lambda: ht.sparse.csr_from_dense(sq, keep="above", threshold=0.3,
                                                            include_diagonal=True, **kw)),
            ("coo_host", lambda: ht.sparse.csr_from_coo(rows, cols, vals, (7, 7), **kw)),
            ("coo_0", lambda: ht.sparse.csr_from_coo(arr(rows, 0), arr(cols, 0), arr(vals, 0),
                                                     (7, 7))),
            ("T", lambda: A().transpose()),
            ("T_slab1", lambda: ht.sparse.transpose(A(), slab=1)),
            ("T_short", lambda: ht.sparse.transpose(ht.sparse.csr_from_dense(short, **kw),
                                                    slab=2)),
            ("pattern_min", lambda: ht.sparse.spmv(A(), arr(labels, 0), reduce="min",
                                                   pattern=True, out_split=None)),
            ("pattern_max_0", lambda: ht.sparse.spmv(A(), arr(labels), reduce="max",
                                                     pattern=True)),
            ("components", lambda: ht.graph.connected_components(
                ht.sparse.csr_from_dense(graph, **kw))),
            ("cg", lambda: ht.linalg.cg(ht.sparse.csr_from_dense(spd, **kw), arr(b),
                                        arr(np.zeros(11, np.float32), 0))),
            ("lanczos_V", lambda: ht.linalg.lanczos(ht.sparse.csr_from_dense(spd, **kw), 5)[0]),
            ("lanczos_T", lambda: ht.linalg.lanczos(ht.sparse.csr_from_dense(spd, **kw), 5)[1]),
            ("laplacian", laplacian),
            ("laplacian_blocks", lambda: laplacian(block_rows=3)),
            ("spectral", sparse_spectral),
            ("kmedians_labels", lambda: fitted("KMedians").labels_),
            ("kmedians_centers", lambda: fitted("KMedians").cluster_centers_),
            ("kmedoids_labels", lambda: fitted("KMedoids", init="probability_based").labels_),
            ("kmedoids_centers", lambda: fitted("KMedoids",
                                                init="probability_based").cluster_centers_),
            ("gnb", lambda: ht.naive_bayes.GaussianNB().fit(arr(blobs, 0), arr(truth, 0))
             .predict_proba(arr(blobs[::2] + 0.4, 0))),
            ("knn", lambda: ht.classification.KNeighborsClassifier(4).fit(
                arr(blobs, 0), arr(truth, 0)).predict(arr(blobs[::3] + 1.0, 0))),
        ]
        for xs in (None, 0):
            for os_ in (None, 0):
                for red in ("sum", "min", "max"):
                    calls.append((f"spmv_{xs}_{os_}_{red}", (
                        lambda xs, os_, red: lambda: ht.sparse.spmv(
                            A(), arr(x5, xs), out_split=os_, reduce=red))(xs, os_, red)))
                calls.append((f"spmm_{xs}_{os_}", (lambda xs, os_: lambda: ht.sparse.spmm(
                    A(), arr(X5, xs), out_split=os_))(xs, os_)))
        return calls
""")
_WORKER = _CALLS + _WORKER
exec(_CALLS)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def gloo_ranks(tmp_path_factory):
    """One spawned world of three gloo ranks; each rank's saved results."""
    out = tmp_path_factory.mktemp("linalg_gloo")
    world, port = 3, _free_port()
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    env.pop("HEAT_TPU_RING_OVERLAP", None)
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(r), str(world), str(port),
                               str(out)], cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=180)[0])
        finally:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(3)]


def _meta(rank_res, name):
    dtype, split, lshape = rank_res[name + "_meta"]
    return dtype, split, lshape


def _hold(ranks, name, ref, want_values=None, rtol=1e-5):
    """Every rank's result ``name`` has the reference's type, split and
    shape, this rank's ceil-rule chunk, and numpy's (or the given) values."""
    values = np.asarray(ref.numpy()) if want_values is None else want_values
    for rank, r in enumerate(ranks):
        dtype, split, lshape = _meta(r, name)
        assert dtype == ref.dtype.__name__ and split == str(ref.split), (name, dtype, split)
        want_lshape = tcomm.chunk(ref.shape, ref.split, rank, 3)[1]
        assert lshape == str(tuple(int(v) for v in want_lshape)), (name, rank, lshape)
        scale = max(1.0, float(np.abs(values).max())) if values.size else 1.0
        np.testing.assert_allclose(r[name], values, rtol=rtol, atol=rtol * scale, err_msg=name)
        if ref.split is not None:
            _, _, sl = tcomm.chunk(ref.shape, ref.split, rank, 3)
            np.testing.assert_allclose(r[name + "_local"], values[sl], rtol=rtol,
                                       atol=rtol * scale, err_msg=name)


def test_gloo_collectives(gloo_ranks):
    rng = np.random.default_rng(0)
    base = rng.standard_normal((7, 4)).astype(np.float32)
    big = np.array([2 ** 63 + 5, 2 ** 64 - 3, 7, 2 ** 40], dtype=np.uint64)
    total = base * 6
    total_u64 = big * np.uint64(1) + big * np.uint64(2) + big * np.uint64(3)
    x72 = rng.standard_normal((7, 2)).astype(np.float32)
    u72 = (np.arange(14, dtype=np.uint64) * np.uint64(2 ** 61)).reshape(7, 2)
    for rank, r in enumerate(gloo_ranks):
        rows = tcomm.chunk((7, 4), 0, rank, 3)[2]
        cols = tcomm.chunk((7, 4), 1, rank, 3)[2]
        np.testing.assert_allclose(r["rs0"], total[rows], rtol=1e-6)
        np.testing.assert_allclose(r["rs1"], total[cols], rtol=1e-6)
        np.testing.assert_allclose(r["rs_max"], np.maximum(base * 3, base)[rows], rtol=1e-6)
        np.testing.assert_array_equal(r["rs_u64"], total_u64[tcomm.chunk((4,), 0, rank, 3)[2]])
        assert r["rs_u64"].dtype == np.uint64
        own = tcomm.chunk((7, 2), 1, rank, 3)[2]
        np.testing.assert_array_equal(r["a2a"], x72[own])
        np.testing.assert_array_equal(r["a2a_found_n"], x72[own])
        np.testing.assert_array_equal(r["a2a_u64"], u72[own])
        assert r["a2a"].shape == ((7, 1), (7, 1), (7, 0))[rank]
        np.testing.assert_array_equal(r["ring"], np.full(3, (rank - 1) % 3))
        np.testing.assert_array_equal(r["ring_back"], np.full(3, (rank + 1) % 3))
        np.testing.assert_array_equal(r["ring_async"], r["ring"])
        np.testing.assert_array_equal(r["ring_u64"], big + np.uint64((rank - 1) % 3))
        np.testing.assert_array_equal(r["pperm"], np.full(3, {0: 2, 1: 0, 2: 0}[rank]))


def test_gloo_resplit_uses_all_to_all(gloo_ranks):
    rng = np.random.default_rng(0)
    rng.standard_normal((7, 4))
    x72 = rng.standard_normal((7, 2)).astype(np.float32)
    for r in gloo_ranks:
        assert int(r["resplit_allgathers"]) == 0
    for s0, s1 in ((0, 1), (1, 0)):
        ref = ht_tpu.array(x72, split=s0).resplit(s1)
        _hold(gloo_ranks, f"resplit_x72_{s0}{s1}", ref, x72, rtol=0)
    assert [_meta(r, "resplit_x72_01")[2] for r in gloo_ranks] == ["(7, 1)", "(7, 1)", "(7, 0)"]
    assert [_meta(r, "resplit_x72_10")[2] for r in gloo_ranks] == ["(3, 2)", "(3, 2)", "(1, 2)"]
    for r in gloo_ranks:
        np.testing.assert_array_equal(r["resplit_x75_01"], r["resplit_x75_10"])


def test_gloo_matmul_every_split_pair(gloo_ranks):
    for tag, (sa_, sb_) in (("75x53", ((7, 5), (5, 3))), ("72x25", ((7, 2), (2, 5)))):
        a = np.random.default_rng(1).standard_normal(sa_).astype(np.float32)
        b = np.random.default_rng(2).standard_normal(sb_).astype(np.float32)
        one = (htt.array(a) @ htt.array(b)).numpy()
        for sa in (None, 0, 1):
            for sb in (None, 0, 1):
                ref = ht_tpu.array(a, split=sa) @ ht_tpu.array(b, split=sb)
                _hold(gloo_ranks, f"mm_{tag}_{sa}_{sb}", ref)
                for r in gloo_ranks:
                    np.testing.assert_allclose(r[f"mm_{tag}_{sa}_{sb}"], one, rtol=1e-5, atol=1e-5)
    v = np.random.default_rng(3).standard_normal(5).astype(np.float32)
    m = np.random.default_rng(1).standard_normal((7, 5)).astype(np.float32)
    b53 = np.random.default_rng(2).standard_normal((5, 3)).astype(np.float32)
    a3 = np.random.default_rng(4).standard_normal((4, 7, 5)).astype(np.float32)
    for sv in (None, 0):
        for sm in (None, 0, 1):
            _hold(gloo_ranks, f"mv_{sm}_{sv}",
                  ht_tpu.matmul(ht_tpu.array(m, split=sm), ht_tpu.array(v, split=sv)))
            _hold(gloo_ranks, f"vm_{sv}_{sm}",
                  ht_tpu.matmul(ht_tpu.array(v, split=sv), ht_tpu.array(b53, split=sm)))
    for s3 in (None, 0, 1, 2):
        for sb in (None, 0, 1):
            _hold(gloo_ranks, f"b3_{s3}_{sb}",
                  ht_tpu.matmul(ht_tpu.array(a3, split=s3), ht_tpu.array(b53, split=sb)))


def test_gloo_basics(gloo_ranks):
    v = np.random.default_rng(3).standard_normal(5).astype(np.float32)
    m = np.random.default_rng(1).standard_normal((7, 5)).astype(np.float32)
    T = ht_tpu
    _hold(gloo_ranks, "trace_0", T.linalg.trace(T.array(m, split=0), offset=1))
    _hold(gloo_ranks, "trace_1", T.linalg.trace(T.array(m, split=1), offset=-1))
    _hold(gloo_ranks, "tril_0", T.linalg.tril(T.array(m, split=0), -1))
    _hold(gloo_ranks, "triu_1", T.linalg.triu(T.array(m, split=1), 1))
    _hold(gloo_ranks, "outer_1", T.linalg.outer(T.array(v, split=0), T.array(v[:3], split=0),
                                                split=1))
    _hold(gloo_ranks, "dot", T.dot(T.array(v, split=0), T.array(v, split=None)))
    _hold(gloo_ranks, "norm_1", T.linalg.matrix_norm(T.array(m, split=1), ord=1))


QR_GLOO = {"tsqr_20x5": ((20, 5), 5, 0), "tsqr_short_7x5": ((7, 5), 6, 0),
           "tsqr_tiles_24x3": ((24, 3), 7, 0), "chol_50x12": ((50, 12), 8, 1),
           "chol_30x7": ((30, 7), 9, 1), "wide0_10x30": ((10, 30), 10, 0),
           "wide1_10x30": ((10, 30), 10, 1)}


@pytest.mark.parametrize("name", list(QR_GLOO))
def test_gloo_qr_paths(gloo_ranks, name):
    shape, seed, split = QR_GLOO[name]
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    ref = ht_tpu.linalg.qr(ht_tpu.array(a, split=split))
    rq, rr = _sign_normalised(np.asarray(ref.Q.numpy()), np.asarray(ref.R.numpy()))
    one = htt.linalg.qr(htt.array(a))
    oq, orr = _sign_normalised(one.Q.numpy(), one.R.numpy())
    for rank, r in enumerate(gloo_ranks):
        q, rr_ = r[f"qr_{name}_Q"], r[f"qr_{name}_R"]
        _qr_checks(q, rr_, a)
        gq, gr = _sign_normalised(q, rr_)
        for wq, wr in ((rq, rr), (oq, orr)):
            np.testing.assert_allclose(gq, wq, rtol=0, atol=1e-4)
            np.testing.assert_allclose(gr, wr, rtol=0, atol=1e-4 * float(np.abs(wr).max()))
        for part, refpart in (("Q", ref.Q), ("R", ref.R)):
            dtype, split, lshape = _meta(r, f"qr_{name}_{part}")
            assert (dtype, split) == (refpart.dtype.__name__, str(refpart.split)), (name, part)
            want = tcomm.chunk(refpart.shape, refpart.split, rank, 3)[1]
            assert lshape == str(tuple(int(x) for x in want))


def test_gloo_cholqr_schedules_and_fallback(gloo_ranks):
    for r in gloo_ranks:
        np.testing.assert_array_equal(r["ring_0_Q"], r["ring_1_Q"])
        np.testing.assert_array_equal(r["ring_0_R"], r["ring_1_R"])
        assert int(r["deficient_shifted"]) > 0
    deficient = np.random.default_rng(11).standard_normal((30, 7)).astype(np.float32)
    deficient[:, 3] = 0.0  # G is singular in any rounding: both packages shift
    ref = ht_tpu.linalg.qr(ht_tpu.array(deficient, split=1))
    for r in gloo_ranks:
        q, rr = r["deficient_Q"], r["deficient_R"]
        np.testing.assert_allclose(q @ rr, deficient, rtol=0, atol=1e-4 * np.abs(deficient).max())
        np.testing.assert_allclose(q @ rr, np.asarray(ref.Q.numpy()) @ np.asarray(ref.R.numpy()),
                                   rtol=0, atol=1e-4 * np.abs(deficient).max())
        assert _meta(r, "deficient_R")[1] == str(ref.R.split) == "1"


@pytest.mark.parametrize("name,qr_name,split", [("tall0", "tsqr_20x5", 0),
                                                ("tall1", "chol_50x12", 1),
                                                ("wide0", "wide0_10x30", 0)])
def test_gloo_svd(gloo_ranks, name, qr_name, split):
    shape, seed, _ = QR_GLOO[qr_name]
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    ref = ht_tpu.linalg.svd(ht_tpu.array(a, split=split))
    s_ref = np.asarray(ref.S.numpy())
    for r in gloo_ranks:
        u, s, v = r[f"svd_{name}_U"], r[f"svd_{name}_S"], r[f"svd_{name}_V"]
        np.testing.assert_allclose(s, s_ref, rtol=1e-5, atol=1e-5 * s_ref.max())
        np.testing.assert_allclose(r[f"svdvals_{name}"], s_ref, rtol=1e-5, atol=1e-5 * s_ref.max())
        np.testing.assert_allclose((u * s) @ v.T, a, rtol=0, atol=1e-5 * np.abs(a).max())
        np.testing.assert_allclose(u.T @ u, np.eye(u.shape[1]), rtol=0, atol=1e-5)
        for part, refpart in (("U", ref.U), ("S", ref.S), ("V", ref.V)):
            assert _meta(r, f"svd_{name}_{part}")[:2] == (refpart.dtype.__name__,
                                                         str(refpart.split)), (name, part)


def _world_of_one(calls):
    return {name: call() for name, call in calls}


def _base():
    return np.random.default_rng(0).standard_normal((7, 4)).astype(np.float32)


def test_gloo_random_draws_equal_a_world_of_one(gloo_ranks):
    """Each of three ranks drew only its own chunk; the global arrays are
    the world of one's (and so the JAX package's) bit for bit, and each
    rank's chunk is its ceil-rule part of them."""
    base = _base()
    htt.random.seed(21)
    one = {name: draw() for name, draw in _RANDOM_CALLS(htt, base)}
    ht_tpu.random.seed(21)
    ref = {name: draw() for name, draw in _RANDOM_CALLS(ht_tpu, base)}
    for name, want in one.items():
        if not name.startswith(("randn", "normal")):  # the normals: within 4 ulp, elsewhere
            np.testing.assert_array_equal(want.numpy(), np.asarray(ref[name].numpy()))
        _hold(gloo_ranks, f"random_{name}", want, want.numpy(), rtol=0)
    rows = gloo_ranks[0]["random_permutation_x0"]
    assert sorted(map(tuple, rows)) == sorted(map(tuple, base))


def test_gloo_split_axis_operations_equal_a_world_of_one(gloo_ranks):
    """cumsum/cumprod/diff along the split axis, argmax/argmin with ties on
    every rank (the lowest global index wins), histograms and bincount: each
    rank's result is the world of one's, exactly for exact results and
    within 1e-6 relative for float32 scans (the carry adds in another
    order)."""
    ref = _world_of_one(_SPLIT_AXIS_CALLS(ht_tpu, _base()))
    for name, want in _world_of_one(_SPLIT_AXIS_CALLS(htt, _base())).items():
        rtol = 1e-6 if want.dtype.__name__.startswith("float") else 0
        _hold(gloo_ranks, f"axis_{name}", want, want.numpy(), rtol=rtol)
        # the world of one against the JAX package on its 8-device mesh:
        # exact types bit for bit, float32 within 1e-5 relative
        got, exp = want.numpy(), np.asarray(ref[name].numpy())
        assert (want.dtype.__name__, want.split, got.shape) == \
            (ref[name].dtype.__name__, ref[name].split, exp.shape), name
        if want.dtype.__name__.startswith("float"):
            np.testing.assert_allclose(got, exp, rtol=1e-5, atol=1e-5, err_msg=name)
        else:
            np.testing.assert_array_equal(got, exp, err_msg=name)
    assert gloo_ranks[1]["axis_argmax_0"].tolist() == [1, 1, 5]
    assert int(gloo_ranks[2]["axis_argmax_flat"]) == 2


def test_gloo_lasso_solvers_laplacian_spectral_equal_a_world_of_one(gloo_ranks):
    """Lasso (rows split, y cut to x's chunks or replicated, feature split
    resplit once, partial_fit), cg and lanczos on a split matrix (matvecs of
    local rows and one allgather), the Laplacian of row-split data (only the
    degree vector gathered) and Spectral on three ranks: each rank holds the
    world of one's result (float32 within 1e-5 relative to the largest
    value: sums across ranks add in another order; Spectral's labels equal
    up to a relabelling, and the iteration counts exactly), and the world of
    one holds the JAX package's within the same tolerance."""
    ref_calls = dict(_SLICE_CALLS(ht_tpu))
    for name, want in _world_of_one(_SLICE_CALLS(htt)).items():
        key = f"slice_{name}"
        # the JAX package's Lasso needs y split as x is: no reference for that case
        ref = {} if name == "lasso_0_yrep" else {name: ref_calls[name]()}
        if name.startswith("spectral"):
            for r in gloo_ranks:
                assert _meta(r, key)[:2] == (want.dtype.__name__, str(want.split)), name
                pairs = set(zip(r[key].tolist(), want.numpy().tolist()))
                assert len(pairs) == len(set(r[key].tolist())) == 3, name
            pairs = set(zip(want.numpy().tolist(), np.asarray(ref[name].numpy()).tolist()))
            assert len(pairs) == 3, name
            continue
        if not ref:
            _hold(gloo_ranks, key, want, want.numpy(), rtol=1e-5)
            continue
        if name.startswith("lanczos_T"):  # the Ritz values: the basis' signs may differ
            for r in gloo_ranks:
                np.testing.assert_allclose(np.linalg.eigvalsh(r[key].astype(np.float64)),
                                           np.linalg.eigvalsh(want.numpy().astype(np.float64)),
                                           rtol=1e-5, atol=1e-4, err_msg=name)
            continue
        _hold(gloo_ranks, key, want, want.numpy(), rtol=0 if name.endswith("iters") else 1e-5)
        got, exp = want.numpy(), np.asarray(ref[name].numpy())
        assert (want.dtype.__name__, want.split, got.shape) == \
            (ref[name].dtype.__name__, ref[name].split, exp.shape), name
        np.testing.assert_allclose(got, exp, rtol=1e-5, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("split", [0, 1])
def test_gloo_summarised_printing(gloo_ranks, split):
    """A split array above the threshold prints on three ranks as in the
    JAX package, from the edge items each rank holds."""
    wide = np.arange(50 * 31, dtype=np.float32).reshape(50, 31) / 7
    want = str(ht_tpu.array(wide, split=split))
    assert "..." in want
    assert [str(r[f"printed_{split}"]) for r in gloo_ranks] == [want] * 3


def test_gloo_seed_without_value_takes_rank_zeros_clock(gloo_ranks):
    """``seed()`` on three ranks that read their clocks apart: every rank
    holds rank 0's seed, so ``randperm(13, split=0)`` is one permutation,
    the same on every rank and the world of one's under that seed."""
    seeds = {int(r["clock_seed"]) for r in gloo_ranks}
    assert len(seeds) == 1, seeds
    htt.random.seed(seeds.pop())
    want = htt.random.randperm(13, split=0)
    assert sorted(want.numpy().tolist()) == list(range(13))
    _hold(gloo_ranks, "random_clock_randperm", want, want.numpy(), rtol=0)


# the sparse arrays, the sparse graph paths and item 8c's estimators on three
# ranks: against the world of one and the JAX package on three devices

_SPARSE_NAMES = [name for name, _ in _SPARSE_CALLS(htt, {})]
# results that sum floats in an order that depends on the ranks or the
# package: relative tolerance; every other result bit for bit
_SPARSE_RTOL = {"laplacian": 1e-5, "laplacian_blocks": 1e-5, "cg": 1e-5, "lanczos_V": 1e-4, "lanczos_T": 1e-5,
                "gnb": 1e-10, **{f"spmv_{xs}_{os_}_sum": 1e-6 for xs in (None, 0)
                                  for os_ in (None, 0)},
                **{f"spmm_{xs}_{os_}": 1e-6 for xs in (None, 0) for os_ in (None, 0)}}


def _three_devices():
    return MeshCommunication(devices=jax.devices()[:3])


@pytest.mark.parametrize("name", _SPARSE_NAMES)
def test_gloo_sparse_paths_equal_a_world_of_one_and_the_reference(gloo_ranks, name):
    """Each rank's shard of a sparse result (indptr, the first counts[rank]
    indices and values, counts, capacity) is the JAX package's shard on three
    devices, bit for bit (an empty shard and m < p included); dense results
    hold the world of one's values on every rank, and the world of one holds
    the JAX package's (float sums within the stated tolerance; Spectral's
    labels up to a relabelling; Lanczos' T by its Ritz values)."""
    one = dict(_SPARSE_CALLS(htt, {}))[name]()
    ref = dict(_SPARSE_CALLS(ht_tpu, {"comm": _three_devices()}))[name]()
    rtol = _SPARSE_RTOL.get(name, 0)
    key = f"sparse_{name}"
    if isinstance(one, htt.sparse.SparseDNDarray):
        r, cap = ref.row_chunk, ref.capacity
        ip = np.asarray(ref.indptr).reshape(3, r + 1)
        ix = np.asarray(ref.indices).reshape(3, cap)
        vals = np.asarray(ref.values).reshape(3, cap)
        for rank, res in enumerate(gloo_ranks):
            assert res[f"{key}_counts"].tolist() == ref.counts.tolist(), (name, rank)
            assert int(res[f"{key}_cap"]) == cap, (name, rank)
            np.testing.assert_array_equal(res[f"{key}_indptr"], ip[rank])
            c = int(ref.counts[rank])
            np.testing.assert_array_equal(res[f"{key}_indices"], ix[rank, :c])
            np.testing.assert_allclose(res[f"{key}_values"], vals[rank, :c], rtol=rtol, atol=rtol)
        dense = one.to_dense()
        _hold(gloo_ranks, f"{key}_dense", dense, dense.numpy(), rtol=rtol)
        np.testing.assert_allclose(dense.numpy(), np.asarray(ref.to_dense().numpy()), rtol=rtol,
                                   atol=rtol)
        return
    want = one.numpy()
    if name == "spectral":
        for res in gloo_ranks:
            assert len(set(zip(res[key].tolist(), want.tolist()))) == 3
        assert len(set(zip(want.tolist(), np.asarray(ref.numpy()).tolist()))) == 3
        return
    if name == "lanczos_T":  # the Ritz values
        ritz = lambda t: np.linalg.eigvalsh(np.asarray(t, np.float64))
        for res in gloo_ranks:
            np.testing.assert_allclose(ritz(res[key]), ritz(want), rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(ritz(want), ritz(ref.numpy()), rtol=1e-5, atol=1e-4)
        return
    if name.endswith(("None_min", "None_max")):
        # an empty row of a replicated float min/max is +-finfo.max on three
        # ranks and +-inf on one, in both packages: the ranks are held to the
        # JAX package on three devices, the world of one on the other rows
        rows = np.isfinite(want)
        want = np.where(rows, want, np.asarray(ref.numpy()))
        assert (~rows).any()
    _hold(gloo_ranks, key, one, want, rtol=rtol)
    assert (one.dtype.__name__, one.split, one.shape) == \
        (ref.dtype.__name__, ref.split, tuple(ref.shape)), name
    want = one.numpy()
    if rtol:
        np.testing.assert_allclose(want, np.asarray(ref.numpy()), rtol=rtol, atol=rtol)
    else:
        rows = np.isfinite(want) if want.dtype.kind == "f" else slice(None)
        np.testing.assert_array_equal(want[rows], np.asarray(ref.numpy())[rows])
