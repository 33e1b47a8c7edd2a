"""``linalg.cg`` and ``linalg.lanczos`` of heat_tpu_torch against heat_tpu
and numpy.

One numpy matrix (symmetric positive definite, from a seed) goes through
both packages: heat_tpu on its 8-device CPU mesh, heat_tpu_torch as a
world of one rank on the CPU. Tolerances:

* ``cg``: within 1e-6 of the reference's solution and of
  ``numpy.linalg.solve`` in float64 (the system is well conditioned);
* ``lanczos``: the Ritz values (eigenvalues of ``T``) within 1e-4 of the
  largest eigenvalue of the reference's (float32 Krylov steps drift in
  another summation order), ``VᵀV = I`` and the Krylov relation
  ``A V = V T + β_m v_{m+1} e_mᵀ`` (checked as ``VᵀAV = T``) within 1e-4;
  in float64 within 1e-10. A breakdown (a matrix with three eigenvalues
  and m = 6) restarts from the reference's vector: V and T within 1e-6.
"""

import numpy as np
import torch
import pytest

import heat_tpu as ht_tpu

import heat_tpu_torch as htt


@pytest.fixture(autouse=True)
def on_cpu():
    htt.use_device("cpu")
    yield
    htt.use_device(None)


def _spd(n, seed=3, dtype=np.float32):
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((n, n))
    return (m @ m.T + n * np.eye(n)).astype(dtype), rng.standard_normal(n).astype(dtype)


@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("n", [37, 16])
def test_cg_matches_reference_and_numpy(n, split):
    a, b = _spd(n)
    x0 = np.zeros(n, np.float32)
    got = htt.linalg.cg(htt.array(a, split=split), htt.array(b), htt.array(x0))
    ref = ht_tpu.linalg.cg(ht_tpu.array(a, split=split), ht_tpu.array(b), ht_tpu.array(x0))
    assert got.dtype.__name__ == ref.dtype.__name__ and got.split == ref.split
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.linalg.solve(a.astype(np.float64), b), atol=1e-6)


def test_cg_out_x0_split_and_errors():
    a, b = _spd(12)
    x0 = np.ones(12, np.float32)
    out = htt.zeros(12, split=0)
    res = htt.linalg.cg(htt.array(a), htt.array(b), htt.array(x0, split=0), out=out)
    assert res is out and out.split == 0
    np.testing.assert_allclose(out.numpy(), np.linalg.solve(a.astype(np.float64), b), atol=1e-6)
    singular = np.diag([1.0, -1.0, 0.0]).astype(np.float32)
    for ht in (htt, ht_tpu):
        with pytest.raises(RuntimeError, match="non-finite"):
            ht.linalg.cg(ht.array(singular), ht.array(np.array([1.0, 1.0, 1.0], np.float32)),
                         ht.array(np.zeros(3, np.float32)))
        with pytest.raises(RuntimeError):
            ht.linalg.cg(ht.array(b), ht.array(b), ht.array(b))
    for ht in (htt, ht_tpu):  # the windows' argument errors, as in the JAX package
        with pytest.raises(ValueError, match="requires checkpoint_path"):
            ht.linalg.cg(ht.array(a), ht.array(b), ht.array(x0), checkpoint_every=2)
        with pytest.raises(ValueError, match="must be positive"):
            ht.linalg.cg(ht.array(a), ht.array(b), ht.array(x0), checkpoint_every=0,
                         checkpoint_path="ckpt")

    class Operator:  # any object with the solver hook: cg calls its matvec
        ndim, shape, dtype = 2, a.shape, htt.float32

        def _matvec_spec(self, dt):
            dense = torch.as_tensor(a).to(dt.torch_type())
            return lambda v: dense @ v

    np.testing.assert_allclose(htt.linalg.cg(Operator(), htt.array(b), htt.array(x0)).numpy(),
                               np.linalg.solve(a.astype(np.float64), b), atol=1e-6)


def _ritz(t):
    return np.linalg.eigvalsh(np.asarray(t, dtype=np.float64))


@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-4), (np.float64, 1e-10)])
def test_lanczos_ritz_values_and_krylov_relation(dtype, tol, split):
    a, _ = _spd(37, seed=4, dtype=dtype)
    got_v, got_t = htt.linalg.lanczos(htt.array(a, split=split), 12)
    ref_v, ref_t = ht_tpu.linalg.lanczos(ht_tpu.array(a, split=split), 12)
    assert (got_v.shape, got_v.split, got_v.dtype.__name__) == \
        (ref_v.shape, ref_v.split, ref_v.dtype.__name__)
    assert (got_t.shape, got_t.split) == (ref_t.shape, ref_t.split)
    scale = np.abs(np.linalg.eigvalsh(a.astype(np.float64))).max()
    np.testing.assert_allclose(_ritz(got_t.numpy()), _ritz(ref_t.numpy()), atol=tol * scale)
    v, t = got_v.numpy().astype(np.float64), got_t.numpy().astype(np.float64)
    np.testing.assert_allclose(v.T @ v, np.eye(12), atol=tol)
    np.testing.assert_allclose(v.T @ a.astype(np.float64) @ v, t, atol=tol * scale)
    np.testing.assert_allclose(np.triu(t, 2), 0)


def test_lanczos_start_vector_and_outputs():
    a, _ = _spd(20, seed=5)
    v0 = np.random.default_rng(9).standard_normal(20).astype(np.float32)
    got_v, got_t = htt.linalg.lanczos(htt.array(a), 8, v0=htt.array(v0))
    ref_v, ref_t = ht_tpu.linalg.lanczos(ht_tpu.array(a), 8, v0=ht_tpu.array(v0))
    np.testing.assert_allclose(got_v.numpy()[:, 0], v0 / np.linalg.norm(v0), atol=1e-6)
    np.testing.assert_allclose(got_t.numpy(), ref_t.numpy(), atol=1e-4 * 60)
    vo, to = htt.zeros((20, 8)), htt.zeros((8, 8))
    res = htt.linalg.lanczos(htt.array(a), 8, V_out=vo, T_out=to)
    assert res[0] is vo and res[1] is to
    np.testing.assert_array_equal(to.numpy(), htt.linalg.lanczos(htt.array(a), 8)[1].numpy())
    for bad in (0, 2.5):
        with pytest.raises(TypeError):
            htt.linalg.lanczos(htt.array(a), bad)
    with pytest.raises(RuntimeError):
        htt.linalg.lanczos(htt.array(a[:, :5]), 3)
    for ht in (htt, ht_tpu):
        with pytest.raises(ValueError, match="requires checkpoint_every"):
            ht.linalg.lanczos(ht.array(a), 3, resume=True)


@pytest.mark.parametrize("split", [None, 0])
def test_lanczos_breakdown_restarts_from_the_reference_vector(split):
    """Three distinct eigenvalues exhaust the Krylov space after three
    steps: step 3 restarts from normal(fold_in(PRNGKey(0), 3), (n,)), drawn
    by the port's threefry as the JAX package draws it."""
    d = np.diag(np.repeat([1.0, 2.0, 3.0], 5)).astype(np.float32)
    got_v, got_t = htt.linalg.lanczos(htt.array(d, split=split), 6)
    ref_v, ref_t = ht_tpu.linalg.lanczos(ht_tpu.array(d, split=split), 6)
    assert got_t.numpy()[3, 2] == 0.0 and ref_t.numpy()[3, 2] == 0.0
    np.testing.assert_allclose(got_t.numpy(), ref_t.numpy(), atol=1e-6)
    np.testing.assert_allclose(got_v.numpy(), ref_v.numpy(), atol=1e-6)


# -- the checkpoint windows -----------------------------------------------------------


def _killed_after(monkeypatch, saves: int):
    """Make the solver's checkpoint save raise after ``saves`` saves (a
    kill between two windows)."""
    from heat_tpu_torch.core.linalg import solver

    real, count = solver._save_carry, [0]

    def save(*args, **kwargs):
        real(*args, **kwargs)
        count[0] += 1
        if count[0] == saves:
            raise KeyboardInterrupt("killed")

    monkeypatch.setattr(solver, "_save_carry", save)
    return lambda: monkeypatch.setattr(solver, "_save_carry", real)


@pytest.mark.parametrize("algo,every", [("cg", 3), ("cg", 5), ("lanczos", 2), ("lanczos", 4)])
def test_windows_resume_bit_for_bit(monkeypatch, tmp_path, algo, every):
    """A solve run in windows, killed after its second checkpoint and
    resumed, equals the uninterrupted solve bit for bit (the JAX package's
    contract), and the uninterrupted solve equals the JAX package's within
    the tolerances above."""
    a, b = _spd(24, seed=7)
    path = str(tmp_path / "ck")
    if algo == "cg":
        args = (htt.array(a, split=0), htt.array(b), htt.array(np.zeros(24, np.float32)))
        solve = lambda **kw: (htt.linalg.cg(*args, **kw).numpy(),)  # noqa: E731
        ref = ht_tpu.linalg.cg(ht_tpu.array(a, split=0), ht_tpu.array(b),
                               ht_tpu.array(np.zeros(24, np.float32))).numpy()
    else:
        solve = lambda **kw: tuple(  # noqa: E731
            t.numpy() for t in htt.linalg.lanczos(htt.array(a, split=0), 10, **kw))
        ref = ht_tpu.linalg.lanczos(ht_tpu.array(a, split=0), 10)[1].numpy()
    whole = solve()
    windowed = solve(checkpoint_every=every, checkpoint_path=path + "_w")
    restore = _killed_after(monkeypatch, 2)
    with pytest.raises(KeyboardInterrupt):
        solve(checkpoint_every=every, checkpoint_path=path)
    restore()
    resumed = solve(checkpoint_every=every, checkpoint_path=path, resume=True)
    for w, g, r in zip(whole, windowed, resumed):
        assert np.array_equal(w, g) and np.array_equal(w, r)
    if algo == "cg":
        np.testing.assert_allclose(whole[0], ref, atol=1e-6)
    else:
        np.testing.assert_allclose(_ritz(whole[1]), _ritz(ref), atol=1e-4 * 60)


def test_windows_refuse_another_algorithms_checkpoint(tmp_path):
    a, b = _spd(8)
    path = str(tmp_path / "ck")
    htt.linalg.lanczos(htt.array(a), 4, checkpoint_every=2, checkpoint_path=path)
    with pytest.raises(htt.resilience.CheckpointError, match="not cg"):
        htt.linalg.cg(htt.array(a), htt.array(b), htt.array(np.zeros(8, np.float32)),
                      checkpoint_every=2, checkpoint_path=path, resume=True)
