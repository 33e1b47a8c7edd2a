"""The Lloyd kernel module and ``cluster.KMeans`` against heat_tpu.

On the CPU the Lloyd pass runs its plain version. The fit is held against
heat_tpu's ``lloyd_fit_pallas`` run by the Pallas interpreter at
``precision="HIGHEST"`` (exact f32 there), and the public ``KMeans.fit``
(``init`` a DNDarray) against heat_tpu's. The data are well separated blobs,
so no assignment is a near-tie: labels and ``n_iter`` must be identical;
centers agree to 1e-5 (sums taken in another order), inertia to 1e-4
relative: it is summed from GEMM-form distances x^2 + c^2 - 2 x.c, which
cancel at blob spread 10 against noise 1 (|x|^2 is ~100x the inertia), so
each term carries ~100x the f32 rounding of a direct sum."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import heat_tpu as ht_tpu
from heat_tpu.cluster import pallas_lloyd as jax_lloyd

import heat_tpu_torch as htt
from heat_tpu_torch.cluster import cuda_lloyd

CENTER_ATOL = 1e-5
INERTIA_RTOL = 1e-4


@pytest.fixture(autouse=True)
def on_cpu():
    htt.use_device("cpu")
    yield
    htt.use_device(None)


def _blobs(n, d, k, seed):
    rng = np.random.default_rng(seed)
    protos = (rng.standard_normal((k, d)) * 10).astype(np.float32)
    lab = rng.integers(0, k, n)
    x = (protos[lab] + rng.standard_normal((n, d))).astype(np.float32)
    c0 = (protos + 0.5 * rng.standard_normal((k, d))).astype(np.float32)
    return x, c0


@pytest.mark.parametrize("n,d,k", [(300, 5, 7), (257, 3, 9), (128, 64, 4)])
def test_fit_matches_jax_kernel_interpret(n, d, k):
    x, c0 = _blobs(n, d, k, seed=n)
    want_c, want_l, want_i, want_it = jax_lloyd.lloyd_fit_pallas(
        jnp.asarray(x), jnp.asarray(c0), n, 20, jnp.float32(0.0), block_m=64,
        interpret=True, precision="HIGHEST",
    )
    got_c, got_it = cuda_lloyd.lloyd_fit(torch.from_numpy(x), torch.from_numpy(c0), 20, 0.0)
    assert got_it == int(want_it)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=0, atol=CENTER_ATOL)
    got_l = torch.argmin(torch.cdist(torch.from_numpy(x), got_c), 1).numpy()
    np.testing.assert_array_equal(got_l, np.asarray(want_l))


def test_update_counts_match_one_hot_form():
    x, c0 = _blobs(200, 4, 6, seed=1)
    sums, counts = cuda_lloyd.lloyd_update(torch.from_numpy(x), torch.from_numpy(c0), lim=150)
    d2 = ((x[:150, None, :] - c0[None]) ** 2).sum(-1)
    lab = d2.argmin(1)
    np.testing.assert_array_equal(counts.numpy(), np.bincount(lab, minlength=6))
    want = np.stack([x[:150][lab == j].sum(0) for j in range(6)])
    np.testing.assert_allclose(sums.numpy(), want, rtol=1e-5, atol=1e-4)


def test_gate_matches_jax_gate_without_backend(monkeypatch):
    monkeypatch.setattr(jax_lloyd.jax, "default_backend", lambda: "tpu")
    for size, split, d, k, dt in [(1, None, 64, 64, "float32"), (8, 0, 512, 1024, "float32"),
                                  (8, None, 64, 64, "float32"), (1, None, 513, 8, "float32"),
                                  (1, None, 8, 1025, "float32"), (1, None, 8, 8, "float64")]:
        assert cuda_lloyd.pallas_lloyd_applicable(size, split, d, k, getattr(torch, dt)) == \
            jax_lloyd.pallas_lloyd_applicable(size, split, d, k, jnp.dtype(dt))


def _both_fits(x, c0, split, max_iter=30, tol=1e-4):
    k = c0.shape[0]
    got = htt.cluster.KMeans(n_clusters=k, init=htt.array(c0), max_iter=max_iter, tol=tol)
    got.fit(htt.array(x, split=split))
    ref = ht_tpu.cluster.KMeans(n_clusters=k, init=ht_tpu.array(c0), max_iter=max_iter, tol=tol)
    ref.fit(ht_tpu.array(x, split=split))
    return got, ref


@pytest.mark.parametrize("split", [None, 0])
@pytest.mark.parametrize("n,d,k,tol", [(403, 6, 5, 1e-4), (64, 2, 3, 0.0), (300, 17, 9, 1e-4)])
def test_public_fit_matches(split, n, d, k, tol):
    x, c0 = _blobs(n, d, k, seed=d)
    got, ref = _both_fits(x, c0, split, tol=tol)
    assert got.n_iter_ == ref.n_iter_
    assert got.labels_.split == ref.labels_.split
    assert got.labels_.dtype.__name__ == ref.labels_.dtype.__name__
    np.testing.assert_array_equal(got.labels_.numpy(), ref.labels_.numpy())
    np.testing.assert_allclose(got.cluster_centers_.numpy(), ref.cluster_centers_.numpy(),
                               rtol=0, atol=CENTER_ATOL)
    np.testing.assert_allclose(got.inertia_, ref.inertia_, rtol=INERTIA_RTOL)


def test_float64_fit_takes_plain_path_and_matches():
    x, c0 = _blobs(120, 3, 4, seed=9)
    got, ref = _both_fits(x.astype(np.float64), c0.astype(np.float64), 0)
    assert got.n_iter_ == ref.n_iter_
    np.testing.assert_array_equal(got.labels_.numpy(), ref.labels_.numpy())
    np.testing.assert_allclose(got.cluster_centers_.numpy(), ref.cluster_centers_.numpy(),
                               rtol=0, atol=1e-10)


def test_from_state_predicts_like_the_jax_estimator():
    x, c0 = _blobs(250, 5, 6, seed=4)
    ref = ht_tpu.cluster.KMeans(n_clusters=6, init=ht_tpu.array(c0), max_iter=20).fit(
        ht_tpu.array(x, split=0))
    state = {"cluster_centers": ref.cluster_centers_.numpy(), "n_iter": ref.n_iter_,
             "inertia": ref.inertia_}
    got = htt.interop.KMeans.from_state(state)
    xs, _ = _blobs(90, 5, 6, seed=5)
    np.testing.assert_array_equal(got.predict(htt.interop.array_from_numpy(xs, split=0)).numpy(),
                                  ref.predict(ht_tpu.array(xs, split=0)).numpy())
    assert (got.n_iter_, got.inertia_) == (ref.n_iter_, ref.inertia_)


def test_random_init_is_seeded_and_deterministic():
    x, _ = _blobs(200, 4, 5, seed=6)
    fits = [htt.cluster.KMeans(n_clusters=5, init="random", random_state=3, max_iter=15)
            .fit(htt.array(x, split=0)) for _ in range(2)]
    np.testing.assert_array_equal(fits[0].cluster_centers_.numpy(), fits[1].cluster_centers_.numpy())
    np.testing.assert_array_equal(fits[0].labels_.numpy(), fits[1].labels_.numpy())
    # k-means++ seeding is ported too: seeded and deterministic as well
    pp = [htt.cluster.KMeans(n_clusters=5, init="probability_based", random_state=3, max_iter=15)
          .fit(htt.array(x, split=0)) for _ in range(2)]
    np.testing.assert_array_equal(pp[0].cluster_centers_.numpy(), pp[1].cluster_centers_.numpy())
    with pytest.raises(ValueError):
        htt.cluster.KMeans(n_clusters=3, init=htt.array(np.zeros((2, 4), np.float32))).fit(htt.array(x))

