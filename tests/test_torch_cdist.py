"""The cdist kernel module and ``spatial.cdist``/``rbf`` against heat_tpu.

On the CPU ``euclid`` runs its plain version; it is held against heat_tpu's
``euclid_pallas`` run by the Pallas interpreter at ``precision="HIGHEST"``
(exact f32 there), on ragged m, n and k and with both epilogues.
Tolerances: 1e-5 relative off the diagonal (two f32 GEMM-form expansions
that sum in different orders). On the cdist(X, X) diagonal the expansion
cancels to a few ulps of |x|^2, which sqrt magnifies (2.8e-3 at |x|^2 = 64),
so the diagonal is held in squared form: |d_got^2 - d_want^2| <= 8 ulps of
|x|^2, i.e. 8 * eps(f32) * |x|^2."""

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

