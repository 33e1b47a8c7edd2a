"""heat_tpu_torch.random against heat_tpu.random, and the KMeans seeding.

The same seed and call sequence go through both packages: heat_tpu on its
8-device CPU mesh, heat_tpu_torch as a world of one rank on the CPU (the
plain threefry draw, ``core/_threefry.py``). Shapes, splits, type names and
the lshape map over 8 ranks must be the reference's. Values bit for bit for
the bits, ``rand``, ``uniform``, ``random_sample`` and its aliases,
``randint`` (int8/16/32/64, spans up to and above 2^31, the out-of-range
``maxval``), ``randperm``, ``permutation`` and the KMeans ``'random'`` and
``'probability_based'`` rows; ``randn``, ``normal`` and ``standard_normal``
within 4 ulp in float32 and float64 (the inverse error function is XLA's
polynomial, evaluated on torch's ``log1p`` in float32). The draws on three
gloo ranks are held to a world of one in ``test_torch_linalg.py``'s spawned
world; the kernel on the card in ``test_torch_cuda.py``.

The golden values that ``chip_smoke.py`` holds the card's draws to are
pinned here against the JAX package: ``seed(0); randn(8_000_000, 64)``'s
first four values (heat_tpu's own draw of a smaller array: the stream
depends on the flat index alone) and last four (JAX's threefry2x32
primitive at those counters, through the same transform), the 64 rows of
``KMeans(64, init='random', random_state=1)`` over 2,000,000 rows, and
``seed(0); randint(0, 8, (8192, 1))``'s first 16.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import heat_tpu as ht_tpu

import heat_tpu_torch as htt
from heat_tpu_torch.core import _threefry as tf
from heat_tpu_torch.core import communication as tcomm

REPO = Path(__file__).resolve().parent.parent
MESH = 8
ULP = 4


@pytest.fixture(autouse=True)
def on_cpu():
    htt.use_device("cpu")
    yield
    htt.use_device(None)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _meta(got, ref):
    assert got.shape == ref.shape
    assert got.split == ref.split
    assert got.dtype.__name__ == ref.dtype.__name__
    if got.ndim:
        np.testing.assert_array_equal(tcomm.lshape_map(got.shape, got.split, MESH),
                                      ref.lshape_map)


def _ulps(a: np.ndarray, b: np.ndarray) -> int:
    if a.size == 0:
        return 0
    ints = {4: np.int32, 8: np.int64}[a.dtype.itemsize]
    return int(np.abs(a.view(ints).astype(np.int64) - b.view(ints).astype(np.int64)).max())


def _values(got, ref):
    """Both results as numpy arrays of the same type (bfloat16, which
    numpy lacks, widened to float32 on both sides: exact)."""
    if got.dtype.__name__ == "bfloat16":
        return got._global().float().numpy(), np.asarray(ref.numpy()).astype(np.float32)
    return got.numpy(), np.asarray(ref.numpy())


def _both(call, seed=3):
    htt.random.seed(seed)
    ht_tpu.random.seed(seed)
    return call(htt), call(ht_tpu)


# ------------------------------------------------------------- the stream


def test_keys_match_jax():
    for seed in (0, 1, 7, 2 ** 40 + 3, -5):
        key = jax.random.PRNGKey(seed)
        assert tf.prng_key(seed) == tuple(int(v) for v in np.asarray(key))
        for data in (0, 1, 12345, 2 ** 32 - 1):
            folded = np.asarray(jax.random.fold_in(key, data))
            assert tf.fold_in(tf.prng_key(seed), data) == tuple(int(v) for v in folded)
        split = np.asarray(jax.random.split(key, 3))
        assert tf.split(tf.prng_key(seed), 3) == tuple(tuple(int(v) for v in k) for k in split)


@pytest.mark.parametrize("shape", [(1,), (37, 11), (2, 3, 5), ()])
def test_bits_match_jax(shape):
    key = jax.random.fold_in(jax.random.PRNGKey(7), 3)
    k = tf.fold_in(tf.prng_key(7), 3)
    sl = tf.Slice.whole(shape)
    ref32 = np.asarray(jax.random.bits(key, shape, jnp.uint32))
    ref64 = np.asarray(jax.random.bits(key, shape, jnp.uint64))
    np.testing.assert_array_equal(tf.draw_plain(k, sl, "bits32").numpy().view(np.uint32), ref32)
    np.testing.assert_array_equal(tf.draw_plain(k, sl, "bits64").numpy().view(np.uint64), ref64)
    # the python-int hash gives the same words as the tensor one
    if shape:
        idx = int(np.prod(shape)) - 1
        x0, x1 = tf.threefry2x32_int(k[0], k[1], idx >> 32, idx & tf.M32)
        assert (x0 ^ x1) == int(ref32.reshape(-1)[-1])


@pytest.mark.parametrize("split,start,length", [(0, 5, 9), (1, 3, 8), (2, 0, 1), (0, 37, 0)])
def test_slices_are_the_global_stream(split, start, length):
    k = tf.fold_in(tf.prng_key(11), 2)
    shape = (40, 12, 3)
    whole = tf.draw_plain(k, tf.Slice.whole(shape), "bits32").numpy()
    part = tf.draw_plain(k, tf.Slice(shape, split, start, length), "bits32").numpy()
    index = [slice(None)] * 3
    index[split] = slice(start, start + length)
    np.testing.assert_array_equal(part, whole[tuple(index)])


# -------------------------------------------------------- draws vs heat_tpu

SHAPES = [((10, 3), 0), ((10, 3), 1), ((10, 3), None), ((7, 4, 5), 1), ((13,), 0)]


def _draw_cases():
    exact = [
        ("rand", lambda ht, s, sp: ht.random.rand(*s, split=sp)),
        ("rand_f64", lambda ht, s, sp: ht.random.rand(*s, dtype=ht.float64, split=sp)),
        ("random_sample", lambda ht, s, sp: ht.random.random_sample(s, split=sp)),
        ("random", lambda ht, s, sp: ht.random.random(s, split=sp)),
        ("ranf", lambda ht, s, sp: ht.random.ranf(s, split=sp)),
        ("sample", lambda ht, s, sp: ht.random.sample(s, split=sp)),
        ("uniform", lambda ht, s, sp: ht.random.uniform(-2.5, 7.25, s, split=sp)),
        ("uniform_f64", lambda ht, s, sp: ht.random.uniform(1.0, 3.0, s, dtype=ht.float64,
                                                            split=sp)),
        ("uniform_f16", lambda ht, s, sp: ht.random.uniform(size=s, dtype=ht.float16, split=sp)),
        ("uniform_bf16", lambda ht, s, sp: ht.random.uniform(size=s, dtype=ht.bfloat16,
                                                             split=sp)),
        # erf_inv in float32 on the 16-bit uniform, rounded once: exact here
        ("randn_f16", lambda ht, s, sp: ht.random.randn(*s, dtype=ht.float16, split=sp)),
        ("randn_bf16", lambda ht, s, sp: ht.random.randn(*s, dtype=ht.bfloat16, split=sp)),
    ]
    for dtype in ("int8", "int16", "int32", "int64"):
        for lo, hi in ((0, 8), (-5, 100), (-3, 2 ** 31)):
            if dtype in ("int8", "int16") and hi > 2 ** 15:
                continue
            exact.append((f"randint_{dtype}_{lo}_{hi}",
                          lambda ht, s, sp, dtype=dtype, lo=lo, hi=hi: ht.random.randint(
                              lo, hi, s, dtype=getattr(ht, dtype), split=sp)))
    exact.append(("randint_int64_wide", lambda ht, s, sp: ht.random.randint(
        -2 ** 35, 2 ** 62, s, dtype=ht.int64, split=sp)))
    exact.append(("random_integer", lambda ht, s, sp: ht.random.random_integer(9, size=s,
                                                                              split=sp)))
    close = [
        ("randn", lambda ht, s, sp: ht.random.randn(*s, split=sp)),
        ("randn_f64", lambda ht, s, sp: ht.random.randn(*s, dtype=ht.float64, split=sp)),
        ("normal", lambda ht, s, sp: ht.random.normal(1.5, 0.25, s, split=sp)),
        ("standard_normal", lambda ht, s, sp: ht.random.standard_normal(s, split=sp)),
    ]
    return [(n, f, True) for n, f in exact] + [(n, f, False) for n, f in close]


@pytest.mark.parametrize("shape,split", SHAPES, ids=lambda v: str(v))
@pytest.mark.parametrize("name,draw,exact", _draw_cases(), ids=lambda v: v if isinstance(v, str) else "")
def test_draws_match_heat_tpu(name, draw, exact, shape, split):
    got, ref = _both(lambda ht: draw(ht, shape, split))
    _meta(got, ref)
    g, r = _values(got, ref)
    if exact:
        np.testing.assert_array_equal(g.view(np.uint8), r.view(np.uint8))
    else:
        assert _ulps(g, r) <= ULP, name
    # the rank's chunk is its part of the global draw
    if split is not None:
        np.testing.assert_array_equal(got.larray.float().numpy() if got.dtype.__name__ ==
                                      "bfloat16" else got.larray.numpy(),
                                      g[tcomm.chunk(shape, split, 0, 1)[2]])


def test_array_bounds_broadcast():
    low = np.linspace(-1, 1, 6).astype(np.float32)
    high = (low + np.arange(1, 7)).astype(np.float32)
    for size, split in ((None, 0), ((4, 6), 1), ((4, 6), None)):
        got, ref = _both(lambda ht: ht.random.uniform(low, high, size, split=split))
        _meta(got, ref)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref.numpy()))


def test_randint_out_of_range_maxval():
    # maxval above the type's range widens the span by one, as in jax
    for dtype, lo, hi in (("int8", -128, 128), ("int8", 0, 300), ("int16", -5, 2 ** 15),
                          ("int32", 0, 2 ** 31), ("int32", -2 ** 31, 2 ** 31),
                          ("uint8", 0, 256)):
        got, ref = _both(lambda ht: ht.random.randint(lo, hi, (64,), dtype=getattr(ht, dtype),
                                                      split=0))
        _meta(got, ref)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref.numpy()))
    key = tf.prng_key(5)
    for lo, hi in ((0, 2 ** 32 + 7), (-2 ** 63, 2 ** 63 - 1), (3, 3 + 2 ** 40)):
        want = np.asarray(jax.random.randint(jax.random.PRNGKey(5), (50,), lo, hi, jnp.int64))
        got = tf.randint(key, tf.Slice.whole((50,)), lo, hi, torch.int64).numpy()
        np.testing.assert_array_equal(got, want)


def test_state_round_trip():
    htt.random.seed(12)
    ht_tpu.random.seed(12)
    assert htt.random.get_state() == ht_tpu.random.get_state() == ("Threefry", 12, 0, 0, 0.0)
    htt.random.rand(3)
    ht_tpu.random.rand(3)
    state = htt.random.get_state()
    assert state == ht_tpu.random.get_state() == ("Threefry", 12, 1, 0, 0.0)
    a = htt.random.randn(5, 2).numpy()
    htt.random.set_state(state)
    np.testing.assert_array_equal(htt.random.randn(5, 2).numpy(), a)
    htt.random.set_state(("Threefry", 12, 1))
    np.testing.assert_array_equal(htt.random.randn(5, 2).numpy(), a)
    for bad in (("Threefry", 1), ["Threefry", 1, 2], ("MT", 1, 2)):
        with pytest.raises(ValueError):
            htt.random.set_state(bad)
        with pytest.raises(ValueError):
            ht_tpu.random.set_state(bad)
    htt.random.seed()
    assert htt.random.get_state()[2] == 0


@pytest.mark.parametrize("n", [1, 2, 10, 1000, 70001])
@pytest.mark.parametrize("split", [None, 0])
def test_randperm_matches_heat_tpu(n, split):
    got, ref = _both(lambda ht: ht.random.randperm(n, split=split))
    _meta(got, ref)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref.numpy()))
    got, ref = _both(lambda ht: ht.random.randperm(n, dtype=ht.int32))
    _meta(got, ref)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref.numpy()))
    got, ref = _both(lambda ht: ht.random.permutation(n))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref.numpy()))


@pytest.mark.parametrize("split", [None, 0, 1])
def test_permutation_of_an_array(split):
    data = np.random.default_rng(0).standard_normal((10, 3)).astype(np.float32)
    got, ref = _both(lambda ht: ht.random.permutation(ht.array(data, split=split)))
    _meta(got, ref)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref.numpy()))
    assert sorted(map(tuple, got.numpy())) == sorted(map(tuple, data))


def test_errors_match_heat_tpu():
    for ht in (htt, ht_tpu):
        with pytest.raises(ValueError):
            ht.random.randint(5, 5)
        with pytest.raises(ValueError):
            ht.random.randint(0, 5, dtype=ht.float32)
        with pytest.raises(ValueError):
            ht.random.rand(2, dtype=ht.int32)
        with pytest.raises(ValueError):
            ht.random.normal(shape=(2,), dtype=ht.int64)
        with pytest.raises(TypeError):
            ht.random.randperm(3.0)
        with pytest.raises(TypeError):
            ht.random.permutation([1, 2, 3])


def test_choice_matches_jax():
    key, k = jax.random.PRNGKey(4), tf.prng_key(4)
    np.testing.assert_array_equal(
        tf.choice(k, 5000, (64,), replace=False).numpy(),
        np.asarray(jax.random.choice(key, 5000, (64,), replace=False)))
    np.testing.assert_array_equal(
        tf.choice(k, 50, (7, 3)).numpy(), np.asarray(jax.random.choice(key, 50, (7, 3))))
    p = np.random.default_rng(1).random(300).astype(np.float32)
    p /= p.sum()
    for i in range(10):
        want = int(jax.random.choice(jax.random.fold_in(key, i), 300, p=jnp.asarray(p)))
        assert int(tf.choice(tf.fold_in(k, i), 300, p=torch.from_numpy(p))) == want
    with pytest.raises(ValueError):
        tf.choice(k, 3, (4,), replace=False)


# ------------------------------------------------------------- golden values


def test_golden_values_are_the_jax_packages():
    smoke = _chip_smoke()
    first, last = smoke.GOLDEN_RANDN_FIRST4, smoke.GOLDEN_RANDN_LAST4
    n_rows, n_cols = smoke.GOLDEN_RANDN_SHAPE
    # first four: heat_tpu's own randn after seed(0), on a smaller array
    ht_tpu.random.seed(0)
    ref_first = np.asarray(ht_tpu.random.randn(100, n_cols, split=0).numpy()).reshape(-1)[:4]
    np.testing.assert_array_equal(np.float32(first), ref_first)
    # last four: JAX's threefry2x32 primitive at those counters under the
    # key heat_tpu draws with, then normal's transform in jax
    from jax._src import prng

    key = np.asarray(jax.random.fold_in(jax.random.PRNGKey(0), 0))
    total = n_rows * n_cols
    idx = np.arange(total - 4, total, dtype=np.uint64)
    hi = jnp.asarray((idx >> np.uint64(32)).astype(np.uint32))
    lo = jnp.asarray((idx & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    x0, x1 = prng.threefry2x32_p.bind(jnp.uint32(key[0]), jnp.uint32(key[1]), hi, lo)
    bits = x0 ^ x1
    floats = jax.lax.bitcast_convert_type((bits >> 9) | jnp.uint32(0x3F800000), jnp.float32) - 1
    lo_f = np.nextafter(np.float32(-1), np.float32(0))
    u = jnp.maximum(lo_f, floats * (jnp.float32(1) - lo_f) + lo_f)
    ref_last = np.asarray(jnp.float32(np.sqrt(2)) * jax.lax.erf_inv(u))
    assert _ulps(np.float32(last), ref_last) <= ULP
    # the same route gives heat_tpu's first four
    idx0 = jnp.arange(4, dtype=jnp.uint32)
    y0, y1 = prng.threefry2x32_p.bind(jnp.uint32(key[0]), jnp.uint32(key[1]),
                                      jnp.zeros(4, jnp.uint32), idx0)
    f0 = jax.lax.bitcast_convert_type(((y0 ^ y1) >> 9) | jnp.uint32(0x3F800000), jnp.float32) - 1
    u0 = jnp.maximum(lo_f, f0 * (jnp.float32(1) - lo_f) + lo_f)
    assert _ulps(np.asarray(jnp.float32(np.sqrt(2)) * jax.lax.erf_inv(u0)), ref_first) <= ULP
    # the port draws the same values at those indices of the split array
    sl_first = tf.Slice((n_rows, n_cols), 0, 0, 1)
    sl_last = tf.Slice((n_rows, n_cols), 0, n_rows - 1, 1)
    k = tf.fold_in(tf.prng_key(0), 0)
    assert _ulps(tf.normal(k, sl_first, torch.float32).numpy().reshape(-1)[:4],
                 ref_first) <= ULP
    assert _ulps(tf.normal(k, sl_last, torch.float32).numpy().reshape(-1)[-4:],
                 ref_last) <= ULP
    # KMeans 'random' over 2,000,000 rows with random_state=1: the rows
    n_k, k_k = smoke.GOLDEN_KMEANS_ROWS_OF
    want = np.asarray(jax.random.choice(jax.random.PRNGKey(1), n_k, (k_k,), replace=False))
    np.testing.assert_array_equal(np.asarray(smoke.GOLDEN_KMEANS_ROWS), want)
    np.testing.assert_array_equal(tf.choice(tf.prng_key(1), n_k, (k_k,), replace=False).numpy(),
                                  want)
    # randint(0, 8, (8192, 1)) after seed(0)
    ht_tpu.random.seed(0)
    ref = np.asarray(ht_tpu.random.randint(0, 8, (8192, 1)).numpy()).reshape(-1)[:16]
    np.testing.assert_array_equal(np.asarray(smoke.GOLDEN_RANDINT_FIRST16), ref)
    htt.random.seed(0)
    np.testing.assert_array_equal(htt.random.randint(0, 8, (8192, 1)).numpy().reshape(-1)[:16],
                                  ref)


# ------------------------------------------------------------------ KMeans


def _blobs(n, d, k, seed):
    rng = np.random.default_rng(seed)
    protos = (rng.standard_normal((k, d)) * 10).astype(np.float32)
    return (protos[rng.integers(0, k, n)] + rng.standard_normal((n, d))).astype(np.float32)


@pytest.mark.parametrize("init", ["random", "probability_based", "kmeans++"])
@pytest.mark.parametrize("split", [None, 0])
def test_kmeans_seeding_picks_the_jax_packages_rows(init, split):
    x = _blobs(203, 5, 6, seed=3)
    for state in (None, 4):
        got = htt.cluster.KMeans(n_clusters=6, init=init, random_state=state)
        ref = ht_tpu.cluster.KMeans(n_clusters=6, init=init, random_state=state)
        c_got = got._initialize_cluster_centers(htt.array(x, split=split)).numpy()
        c_ref = np.asarray(ref._initialize_cluster_centers(ht_tpu.array(x, split=split)))
        np.testing.assert_array_equal(c_got, c_ref)


@pytest.mark.parametrize("init", ["random", "probability_based"])
def test_kmeans_fit_matches_heat_tpu(init):
    x = _blobs(301, 8, 5, seed=1)
    got = htt.cluster.KMeans(n_clusters=5, init=init, max_iter=30, tol=0.0, random_state=2).fit(
        htt.array(x, split=0))
    ref = ht_tpu.cluster.KMeans(n_clusters=5, init=init, max_iter=30, tol=0.0,
                                random_state=2).fit(ht_tpu.array(x, split=0))
    assert got.n_iter_ == ref.n_iter_
    np.testing.assert_array_equal(got.labels_.numpy(), np.asarray(ref.labels_.numpy()))
    np.testing.assert_allclose(got.cluster_centers_.numpy(),
                               np.asarray(ref.cluster_centers_.numpy()), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.inertia_, ref.inertia_, rtol=1e-5)
