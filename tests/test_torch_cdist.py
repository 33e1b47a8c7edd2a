"""The cdist kernel module and ``spatial.cdist``/``rbf`` against heat_tpu.

On the CPU ``euclid`` runs its plain version; it is held against heat_tpu's
``euclid_pallas`` run by the Pallas interpreter at ``precision="HIGHEST"``
(exact f32 there), on ragged m, n and k and with both epilogues.
Tolerances: 1e-5 relative off the diagonal (two f32 GEMM-form expansions
that sum in different orders). On the cdist(X, X) diagonal the expansion
cancels to a few ulps of |x|^2, which sqrt magnifies (2.8e-3 at |x|^2 = 64),
so the diagonal is held in squared form: |d_got^2 - d_want^2| <= 8 ulps of
|x|^2, i.e. 8 * eps(f32) * |x|^2.

The strategies of HEAT_TPU_CDIST_PREC: ``cdist_precision`` gives the JAX
function's answer and warning for every value; ``euclid_plain``'s 3xTF32
emulation matches ``euclid_pallas``'s bf16x3 split product at the JAX
package's own tolerance (rtol = atol = 2e-4, tests/test_pallas_cdist.py),
its exact form matches ``"HIGHEST"`` at 1e-5, and its one TF32 pass stays
within 2e-3 (|x|^2 + |y|^2) of exact f32 on d2 (each operand's TF32
truncation is <= 2^-10 relative, so a product's <= 2^-9, and
2 |x.y| <= |x|^2 + |y|^2). The plain product is exact f32 whatever the
caller's TF32 flag, which it restores."""

import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import heat_tpu as ht_tpu
from heat_tpu.spatial import pallas_cdist as jax_cdist

import heat_tpu_torch as htt
from heat_tpu_torch.spatial import cuda_cdist

RTOL = 1e-5
OFF_ATOL = 1e-6
DIAG_ULPS = 8


@pytest.fixture(autouse=True)
def on_cpu():
    htt.use_device("cpu")
    yield
    htt.use_device(None)


def _assert_dist_close(got, want, norms2=None):
    """``norms2`` (the rows' |x|^2) marks a self-distance matrix."""
    got, want = np.asarray(got), np.asarray(want)
    off = np.ones_like(want, dtype=bool)
    if norms2 is not None:
        np.fill_diagonal(off, False)
        limit = DIAG_ULPS * np.finfo(np.float32).eps * norms2
        assert (np.abs(np.diag(got) ** 2 - np.diag(want) ** 2) <= limit).all()
    np.testing.assert_allclose(got[off], want[off], rtol=RTOL, atol=OFF_ATOL)


@pytest.mark.parametrize("m,n,k", [(16, 24, 8), (130, 257, 33), (129, 129, 128), (7, 300, 1)])
@pytest.mark.parametrize("epilogue", ["dist", "rbf"])
def test_plain_matches_jax_kernel_interpret(m, n, k, epilogue):
    rng = np.random.default_rng(m + n + k)
    x = rng.random((m, k)).astype(np.float32)
    y = rng.random((n, k)).astype(np.float32)
    gamma = 0.5 / k
    want = jax_cdist.euclid_pallas(jnp.asarray(x), jnp.asarray(y), gamma, epilogue=epilogue,
                                   interpret=True, precision="HIGHEST")
    got = cuda_cdist.euclid(torch.from_numpy(x), torch.from_numpy(y), gamma, epilogue)
    _assert_dist_close(got.numpy(), want)


@pytest.mark.parametrize("m,k", [(100, 64), (33, 128)])
def test_self_distance_diagonal(m, k):
    x = np.random.default_rng(1).standard_normal((m, k)).astype(np.float32)
    want = jax_cdist.euclid_pallas(jnp.asarray(x), jnp.asarray(x), interpret=True,
                                   precision="HIGHEST")
    got = cuda_cdist.euclid(torch.from_numpy(x), torch.from_numpy(x))
    _assert_dist_close(got.numpy(), want, (x.astype(np.float64) ** 2).sum(1))
    assert (got.numpy() >= 0).all()


def test_gate_matches_jax_gate_without_backend(monkeypatch):
    monkeypatch.setattr(jax_cdist.jax, "default_backend", lambda: "tpu")
    for k, dt in [(128, "float32"), (512, "float32"), (513, "float32"), (64, "float64")]:
        assert cuda_cdist.pallas_cdist_applicable(k, getattr(torch, dt)) == \
            jax_cdist.pallas_cdist_applicable(k, jnp.dtype(dt))


@pytest.mark.parametrize("xsplit,ysplit", [(None, None), (0, None), (0, 0), (None, 0)])
@pytest.mark.parametrize("quadratic", [True, False])
def test_public_cdist_matches(xsplit, ysplit, quadratic):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((37, 9)).astype(np.float32)
    y = rng.standard_normal((21, 9)).astype(np.float32)
    got = htt.spatial.cdist(htt.array(x, split=xsplit), htt.array(y, split=ysplit),
                            quadratic_expansion=quadratic)
    ref = ht_tpu.spatial.cdist(ht_tpu.array(x, split=xsplit), ht_tpu.array(y, split=ysplit),
                               quadratic_expansion=quadratic)
    assert got.shape == ref.shape and got.split == ref.split
    assert got.dtype.__name__ == ref.dtype.__name__
    _assert_dist_close(got.numpy(), ref.numpy())


@pytest.mark.parametrize("split", [None, 0])
def test_public_self_cdist_matches(split):
    x = np.random.default_rng(6).standard_normal((40, 16)).astype(np.float32)
    got = htt.spatial.cdist(htt.array(x, split=split), quadratic_expansion=True)
    ref = ht_tpu.spatial.cdist(ht_tpu.array(x, split=split), quadratic_expansion=True)
    _assert_dist_close(got.numpy(), ref.numpy(), (x.astype(np.float64) ** 2).sum(1))


@pytest.mark.parametrize("split", [None, 0])
@pytest.mark.parametrize("quadratic", [True, False])
def test_public_rbf_matches(split, quadratic):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((30, 5)).astype(np.float32)
    y = rng.standard_normal((12, 5)).astype(np.float32)
    got = htt.spatial.rbf(htt.array(x, split=split), htt.array(y), sigma=1.5,
                          quadratic_expansion=quadratic)
    ref = ht_tpu.spatial.rbf(ht_tpu.array(x, split=split), ht_tpu.array(y), sigma=1.5,
                             quadratic_expansion=quadratic)
    assert got.shape == ref.shape and got.split == ref.split
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=RTOL, atol=OFF_ATOL)


def test_float64_input_keeps_float64():
    x = np.random.default_rng(8).standard_normal((10, 4))
    got = htt.spatial.cdist(htt.array(x), quadratic_expansion=True)
    ref = ht_tpu.spatial.cdist(ht_tpu.array(x), quadratic_expansion=True)
    assert got.dtype.__name__ == ref.dtype.__name__ == "float64"
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-10, atol=1e-6)



@pytest.mark.parametrize("value", [None, "", "bf16x3", "default", "high", "highest", " HIGH ",
                                   "Default", "fastest", "bf16"])
def test_cdist_precision_matches_jax(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("HEAT_TPU_CDIST_PREC", raising=False)
    else:
        monkeypatch.setenv("HEAT_TPU_CDIST_PREC", value)
    with warnings.catch_warnings(record=True) as got_w:
        warnings.simplefilter("always")
        got = cuda_cdist.cdist_precision()
    with warnings.catch_warnings(record=True) as want_w:
        warnings.simplefilter("always")
        want = jax_cdist.cdist_precision()
    assert got == want
    assert [str(w.message) for w in got_w] == [str(w.message) for w in want_w]
    assert [w.category for w in got_w] == [w.category for w in want_w]


@pytest.mark.parametrize("m,n,k", [(65, 33, 17), (130, 257, 33), (40, 40, 128), (7, 300, 512)])
@pytest.mark.parametrize("epilogue", ["dist", "rbf"])
def test_plain_tiers_match_jax_kernel_interpret(m, n, k, epilogue):
    rng = np.random.default_rng(10 * m + k)
    x = rng.standard_normal((m, k)).astype(np.float32)
    y = rng.standard_normal((n, k)).astype(np.float32)
    gamma = 0.5 / k
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    split = jax_cdist.euclid_pallas(jnp.asarray(x), jnp.asarray(y), gamma, epilogue=epilogue,
                                    interpret=True, precision="bf16x3")
    np.testing.assert_allclose(cuda_cdist.euclid_plain(tx, ty, gamma, epilogue, "bf16x3").numpy(),
                               np.asarray(split), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(cuda_cdist.euclid_plain(tx, ty, gamma, epilogue, "HIGH").numpy(),
                               np.asarray(split), rtol=2e-4, atol=2e-4)
    exact = jax_cdist.euclid_pallas(jnp.asarray(x), jnp.asarray(y), gamma, epilogue=epilogue,
                                    interpret=True, precision="HIGHEST")
    _assert_dist_close(cuda_cdist.euclid_plain(tx, ty, gamma, epilogue, "HIGHEST").numpy(), exact)
    # one TF32 pass, held on d2 (for rbf: on exp, times gamma)
    one = cuda_cdist.euclid_plain(tx, ty, gamma, epilogue, "DEFAULT").numpy().astype(np.float64)
    ex = np.asarray(exact).astype(np.float64)
    scale = (x.astype(np.float64) ** 2).sum(1)[:, None] + (y.astype(np.float64) ** 2).sum(1)[None]
    lhs = np.abs(one - ex) if epilogue == "rbf" else np.abs(one ** 2 - ex ** 2)
    assert (lhs <= (gamma if epilogue == "rbf" else 1.0) * (2e-3 * scale + 1e-6)).all()


def test_tf32_emulation_clears_the_low_mantissa_bits():
    v = torch.tensor([1.0 + 2.0 ** -10 + 2.0 ** -11, -3.0000002, 0.0], dtype=torch.float32)
    t = cuda_cdist._tf32(v)
    assert (t.view(torch.int32) & 0x1FFF).eq(0).all()
    assert t[0].item() == 1.0 + 2.0 ** -10 and t[2].item() == 0.0
    assert ((v - t).abs() <= v.abs() * 2.0 ** -10).all()


@pytest.fixture
def tf32_on():
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    yield
    torch.backends.cuda.matmul.allow_tf32 = before


@pytest.mark.parametrize("precision", ["HIGHEST", "bf16x3", "DEFAULT"])
def test_euclid_plain_is_exact_f32_and_restores_the_tf32_flag(tf32_on, precision):
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal((50, 64)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal((30, 64)).astype(np.float32))
    got = cuda_cdist.euclid_plain(x, y, precision=precision)
    assert torch.backends.cuda.matmul.allow_tf32 is True
    torch.backends.cuda.matmul.allow_tf32 = False
    want = cuda_cdist.euclid_plain(x, y, precision=precision)
    torch.backends.cuda.matmul.allow_tf32 = True
    assert torch.equal(got, want)
    with pytest.raises(RuntimeError):
        cuda_cdist._mm_f32(torch.ones((4, 3)), torch.ones((2, 5)))
    assert torch.backends.cuda.matmul.allow_tf32 is True


def test_euclid_on_cpu_is_exact_whatever_the_strategy(monkeypatch):
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.standard_normal((20, 8)).astype(np.float32))
    want = cuda_cdist.euclid_plain(x, x)
    for value in ("default", "high", "highest", "bf16x3"):
        monkeypatch.setenv("HEAT_TPU_CDIST_PREC", value)
        assert torch.equal(cuda_cdist.euclid(x, x), want)
        for precision in ("DEFAULT", "bf16x3"):
            assert torch.equal(cuda_cdist.euclid(x, x, precision=precision), want)


def test_unknown_precision_argument_raises():
    x = torch.ones((3, 4))
    with pytest.raises(ValueError, match="precision"):
        cuda_cdist.euclid_plain(x, x, precision="fastest")


# which kernel each shape takes on a card: (k, aligned) -> variant, per tier
_ROUTES = {
    "3xtf32": {(0, True): "f32_fma_stream", (18, True): "f32_fma_stream",
               (18, False): "f32_fma_stream", (32, True): "3xtf32_wgmma",
               (32, False): "f32_fma_stream", (33, True): "f32_fma_stream",
               (33, False): "f32_fma_stream", (128, True): "3xtf32_wgmma",
               (128, False): "f32_fma_stream"},
    "tf32": {(0, True): "f32_fma_stream", (18, True): "f32_fma_stream",
             (18, False): "f32_fma_stream", (32, True): "tf32_wgmma",
             (32, False): "f32_fma_stream", (33, True): "f32_fma_stream",
             (33, False): "f32_fma_stream", (128, True): "tf32_wgmma",
             (128, False): "f32_fma_stream"},
    "f32": {key: "f32_fma_stream" for key in [(0, True), (18, True), (18, False), (32, True),
                                              (32, False), (33, True), (33, False),
                                              (128, True), (128, False)]},
}


@pytest.mark.parametrize("k,aligned", sorted(_ROUTES["f32"]))
@pytest.mark.parametrize("tier", ["3xtf32", "tf32", "f32"])
def test_variant_routes_each_shape(k, tier, aligned):
    """The kernel chosen by shape alone: the tensor cores inside their gate
    (k % 4 == 0, 16-byte aligned data, not the exact tier), else the
    streamed exact f32 FMAs at every k (an empty tensor's data_ptr() is 0:
    k = 0 has no misaligned form)."""
    m, n = 300, 257
    x = torch.zeros((m * k + 1,))[(0 if aligned else 1):][:m * k].view(m, k)
    y = torch.zeros((n, k))
    assert (x.data_ptr() % 16 == 0) == aligned and y.data_ptr() % 16 == 0
    assert cuda_cdist._variant(x, y, tier) == _ROUTES[tier][(k, aligned)]


@pytest.mark.parametrize("tier", ["3xtf32", "tf32", "f32"])
@pytest.mark.parametrize("big", ["x", "y"])
def test_variant_past_int32_rows_takes_the_tile_kernel(tier, big):
    """m or n past 2^31 - 129 rows, which the streamed kernel's and the
    tensor-core kernel's int32 tile coordinates do not reach: the tile
    kernel, whatever the tier (a broadcast view: no memory)."""
    rows = cuda_cdist._MAX_ROWS + 1
    a = torch.zeros((1, 32)).expand(rows, 32)
    b = torch.zeros((257, 32))
    x, y = (a, b) if big == "x" else (b, a)
    assert x.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0
    assert cuda_cdist._variant(x, y, tier) == "f32_fma"
