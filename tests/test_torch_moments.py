"""The moments kernel module against the JAX package's moments kernel.

On the CPU ``column_moments`` runs its plain version; it is held against
heat_tpu's ``column_moments`` run by the Pallas interpreter, on ragged
shapes and with a row limit. Tolerances: mean to 1e-5 relative (plus
1e-6 absolute for means near 0), M2 to 1e-4 relative, since the two sum
in different orders (row blocks merged by Chan/Welford against two
passes). The kernel itself is tested on the card in test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import heat_tpu as ht_tpu
from heat_tpu.core import pallas_moments as jax_moments

import heat_tpu_torch as htt
from heat_tpu_torch.core import cuda_moments

MEAN_RTOL, MEAN_ATOL = 1e-5, 1e-6
M2_RTOL = 1e-4


@pytest.fixture(autouse=True)
def on_cpu():
    htt.use_device("cpu")
    yield
    htt.use_device(None)


@pytest.mark.parametrize(
    "m,d,lim",
    [(300, 5, 300), (257, 33, 250), (64, 64, 64), (1000, 100, 999), (9, 3, 0)],
)
def test_plain_matches_jax_kernel_interpret(m, d, lim):
    rng = np.random.default_rng(m + d)
    x = (rng.standard_normal((m, d)) * 2 + 5).astype(np.float32)
    want_mu, want_m2 = jax_moments.column_moments(jnp.asarray(x), lim, block_m=64, interpret=True)
    got_mu, got_m2 = cuda_moments.column_moments(torch.from_numpy(x), lim)
    np.testing.assert_allclose(got_mu.numpy(), np.asarray(want_mu), rtol=MEAN_RTOL, atol=MEAN_ATOL)
    np.testing.assert_allclose(got_m2.numpy(), np.asarray(want_m2), rtol=M2_RTOL, atol=1e-5)


def test_large_offset_is_stable():
    # a large common offset: the E[x^2]-E[x]^2 form would lose the variance
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((1000, 4)) + 1e4).astype(np.float32)
    mu, m2 = cuda_moments.column_moments(torch.from_numpy(x))
    np.testing.assert_allclose(m2.numpy() / 1000, x.astype(np.float64).var(axis=0), rtol=1e-3)


@pytest.mark.parametrize(
    "a,b",
    [((3.0, 1.0, 2.0), (5.0, -1.0, 4.0)), ((0.0, 0.0, 0.0), (4.0, 2.0, 1.0)),
     ((7.0, 0.5, 3.0), (0.0, 9.0, 9.0))],
)
def test_chan_merge_is_the_jax_packages(a, b):
    assert cuda_moments.chan_merge(*a, *b) == jax_moments.chan_merge(*a, *b)


def test_gate_matches_jax_gate_without_backend(monkeypatch):
    monkeypatch.setattr(jax_moments.jax, "default_backend", lambda: "tpu")
    cases = [
        (1, None, 2, 0, 64, "float32"), (8, 0, 2, 0, 64, "float32"), (8, None, 2, 0, 64, "float32"),
        (1, None, 3, 0, 64, "float32"), (1, None, 2, 1, 64, "float32"),
        (1, None, 2, 0, 5000, "float32"), (1, None, 2, 0, 64, "float64"),
    ]
    for size, split, ndim, axis, d, dt in cases:
        want = jax_moments.pallas_moments_applicable(size, split, ndim, axis, d, jnp.dtype(dt))
        got = cuda_moments.pallas_moments_applicable(size, split, ndim, axis, d, getattr(torch, dt))
        assert got == want


@pytest.mark.parametrize("split", [None, 0])
@pytest.mark.parametrize("m,d", [(50, 7), (16, 64), (3, 1)])
def test_public_mean_var_std_match(split, m, d):
    rng = np.random.default_rng(m * d)
    x = (rng.standard_normal((m, d)) * 3 + 1).astype(np.float32)
    for name in ("mean", "var", "std"):
        got = getattr(htt, name)(htt.array(x, split=split) * 2 + 1, axis=0)
        ref = getattr(ht_tpu, name)(ht_tpu.array(x, split=split) * 2 + 1, axis=0)
        assert got.shape == ref.shape and got.split == ref.split
        assert got.dtype.__name__ == ref.dtype.__name__
        rtol = MEAN_RTOL if name == "mean" else M2_RTOL
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=rtol, atol=MEAN_ATOL)


def test_cpu_wrapper_counts_no_launch():
    htt.reset_launch_counts()
    cuda_moments.column_moments(torch.ones(10, 3))
    assert htt.launch_counts()["moments"] == 0

