"""heat_tpu_torch's ``sort`` and ``topk`` against heat_tpu, and the
odd-even merge-split network alone.

One numpy input from a seeded ``np.random.default_rng`` goes through both
packages: heat_tpu on its 8-device CPU mesh, heat_tpu_torch as a world of
one rank on the CPU, split None, 0 and 1, 11 rows (8 does not divide them).
Values and indices are exact, as are the type, split and lshape map over
8 ranks; integer data drawn from 9 values makes ties, which break by
index. The types are every one torch sorts: the floats (bf16 and f16
too), the signed and unsigned integers, bool.

The one stated exception is the sort of a split float array that holds a
NaN: the JAX package fills its tail pads with ``+inf``, which sorts ahead
of the NaN, so its result ends in ``inf`` with an index out of range
(ROADMAP §3). The port sorts the NaN last, as numpy does; that case holds
the values and indices to numpy and the split and lshape map to heat_tpu.

The network is also run alone, ranks simulated as a list of blocks: by the
0-1 principle it sorts every input if it sorts every 0-1 input, which is
checked for the chunk layouts (1, 1, 0), (3, 3, 1) and (2, 2, 2, 1), with
NaN, ties and sentinels besides. Several ranks (gloo) are in
``test_torch_manip_ranks.py``.
"""

import itertools

import numpy as np
import pytest
import torch

import heat_tpu as ht_tpu

import heat_tpu_torch as htt
from heat_tpu_torch.core import communication as tcomm
from heat_tpu_torch.core import manipulations as tman

MESH = 8


@pytest.fixture(autouse=True)
def on_cpu():
    htt.use_device("cpu")
    yield
    htt.use_device(None)


def _data(shape, dtype="float32", seed=0):
    rng = np.random.default_rng(seed)
    if dtype == "bool":
        return rng.integers(0, 2, size=shape).astype(bool)
    if dtype.startswith(("int", "uint")):
        return rng.integers(0, 9, size=shape).astype(dtype)
    return (rng.standard_normal(shape) * 3).astype(dtype)


def _values(x):
    """Host values; bf16 as float32 (torch has no bf16 ``numpy()``)."""
    if x.dtype.__name__ != "bfloat16":
        return np.asarray(x.numpy())
    if isinstance(x, htt.DNDarray):
        return x._global().float().numpy()
    return np.asarray(x.numpy()).astype(np.float32)


def _check(got, ref):
    """Same shape, split, type, lshape map over 8 ranks and values; for a
    tuple or list, each element."""
    if isinstance(ref, (tuple, list)):
        assert isinstance(got, (tuple, list)) and len(got) == len(ref)
        for g, r in zip(got, ref):
            _check(g, r)
        return
    if not hasattr(ref, "split"):
        assert got == ref
        return
    assert got.shape == tuple(ref.shape), (got.shape, ref.shape)
    assert got.split == ref.split, (got.split, ref.split)
    assert got.dtype.__name__ == ref.dtype.__name__, (got.dtype, ref.dtype)
    if got.ndim:
        np.testing.assert_array_equal(tcomm.lshape_map(got.shape, got.split, MESH),
                                      ref.lshape_map)
    np.testing.assert_array_equal(_values(got), _values(ref))


def _both(call, *inputs, splits):
    got = call(htt, *(htt.array(x, split=s) for x, s in zip(inputs, splits)))
    ref = call(ht_tpu, *(ht_tpu.array(x, split=s) for x, s in zip(inputs, splits)))
    _check(got, ref)


X2 = _data((11, 6))

# ------------------------------------------------------------------- sort

SORT_TYPES = ["float32", "float64", "int32", "int64", "int8", "uint8", "bool", "float16",
              "bfloat16", "uint16", "uint32", "uint64"]


def _sortable(shape, dtype, seed=0):
    if dtype == "bfloat16":
        return _data(shape, "float32", seed)
    return _data(shape, dtype, seed)


def _cast(ht, x, dtype):
    return x.astype(ht.bfloat16) if dtype == "bfloat16" else x


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("dtype", SORT_TYPES)
def test_sort(dtype, split, descending):
    """Values and indices of both axes, ties broken by index (int data
    from 9 values)."""
    x = _sortable((11, 5), dtype)
    for axis in (0, 1, -1):
        _both(lambda ht, a: ht.sort(_cast(ht, a, dtype), axis=axis, descending=descending), x,
              splits=[split])


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("split", [None, 0])
@pytest.mark.parametrize("n", [1, 2, 7, 16, 23])
def test_sort_1d(n, split, descending):
    x = np.round(_data((n,), seed=n))
    _both(lambda ht, a: ht.sort(a, axis=0, descending=descending), x, splits=[split])
    got_v, got_i = htt.sort(htt.array(x, split=split), descending=descending)
    want = np.argsort(-x if descending else x, kind="stable")
    np.testing.assert_array_equal(got_i.numpy(), want)


def test_sort_out_and_values_from_indices():
    x = htt.array(X2, split=0)
    out = htt.zeros_like(x)
    v, i = htt.sort(x, axis=0, out=out)
    assert out is not v and np.array_equal(out.numpy(), v.numpy())
    np.testing.assert_array_equal(np.take_along_axis(X2, i.numpy(), axis=0), v.numpy())


@pytest.mark.parametrize("split", [None, 0])
def test_sort_nan_caveat(split):
    """A NaN with tail pads: the JAX package's split result ends in inf with
    an index out of range; the port's values and indices are numpy's, its
    split and lshape map the JAX package's."""
    x = np.array([3, np.nan, 1, 2, 5, 4, 0, 9, 8, 7, 6], dtype=np.float32)
    for descending in (False, True):
        got_v, got_i = htt.sort(htt.array(x, split=split), axis=0, descending=descending)
        ref_v, ref_i = ht_tpu.sort(ht_tpu.array(x, split=split), axis=0, descending=descending)
        nan, rest = np.flatnonzero(np.isnan(x)), np.flatnonzero(~np.isnan(x))
        if descending:  # NaN first, then the values descending
            order = np.concatenate([nan, rest[np.argsort(-x[rest], kind="stable")]])
        else:
            order = np.concatenate([rest[np.argsort(x[rest], kind="stable")], nan])
        np.testing.assert_array_equal(got_i.numpy(), order)
        np.testing.assert_array_equal(got_v.numpy(), x[order])
        for g, r in ((got_v, ref_v), (got_i, ref_i)):
            assert (g.split, g.dtype.__name__) == (r.split, r.dtype.__name__)
            np.testing.assert_array_equal(tcomm.lshape_map(g.shape, g.split, MESH), r.lshape_map)
    if split is None:  # the JAX package's single-device path is right
        _both(lambda ht, a: ht.sort(a, axis=0), x, splits=[None])


# ------------------------------------------------------ the network alone


def _simulate(blocks_of, c, descending, dtype):
    """The merge-split network over ranks simulated as a list of blocks."""
    order = tman._lane_order(descending, dtype)
    ranks = []
    for blocks in blocks_of:
        perm = order(blocks)
        ranks.append([tman._gather(t, perm) for t in blocks])
    p = len(ranks)
    for r in range(p):
        new = list(ranks)
        for lo in range(r % 2, p - 1, 2):
            assert (lo, lo + 1) in tman._oddeven_partners(p, r)
            new[lo] = tman._merge_pair(ranks[lo], ranks[lo + 1], order, c, True)
            new[lo + 1] = tman._merge_pair(ranks[lo + 1], ranks[lo], order, c, False)
        ranks = new
    return ranks


def _network_sort(x, counts, descending=False):
    n, p = len(x), len(counts)
    c = tcomm.chunk_size(n, p)
    assert list(counts) == list(tcomm.counts_displs(n, p)[0])
    t = torch.as_tensor(x)
    blocks_of, off = [], 0
    for cnt in counts:
        blocks_of.append(tman._lane_blocks(t[off:off + cnt][None], off, c))
        off += cnt
    ranks = _simulate(blocks_of, c, descending, t.dtype)
    vals = torch.cat([b[1][0, :cnt] for b, cnt in zip(ranks, counts)])
    idx = torch.cat([b[2][0, :cnt] for b, cnt in zip(ranks, counts)])
    assert all((b[0][0, :cnt] == 0).all() and (b[0][0, cnt:] == 1).all()
               for b, cnt in zip(ranks, counts))  # the sentinels end where the chunks end
    return vals.numpy(), idx.numpy()


@pytest.mark.parametrize("counts", [(1, 1, 0), (3, 3, 1), (2, 2, 2, 1)], ids=str)
def test_network_sorts_every_zero_one_input(counts):
    n = sum(counts)
    for bits in itertools.product((0, 1), repeat=n):
        x = np.array(bits, dtype=np.int32)
        for descending in (False, True):
            vals, idx = _network_sort(x, counts, descending)
            want = np.argsort(-x if descending else x, kind="stable")
            np.testing.assert_array_equal(idx, want)
            np.testing.assert_array_equal(vals, x[want])


@pytest.mark.parametrize("counts", [(1, 1, 0), (3, 3, 1), (2, 2, 2, 1)], ids=str)
def test_network_nan_ties_and_sentinels(counts):
    rng = np.random.default_rng(sum(counts))
    n = sum(counts)
    for _ in range(20):
        x = rng.integers(0, 3, n).astype(np.float32)
        x[rng.random(n) < 0.3] = np.nan
        x[rng.random(n) < 0.2] = np.inf
        vals, idx = _network_sort(x, counts)
        want = np.argsort(x, kind="stable")
        np.testing.assert_array_equal(idx, want)
        np.testing.assert_array_equal(vals, x[want])
        vals, idx = _network_sort(x, counts, descending=True)
        want = torch.sort(torch.as_tensor(x), stable=True, descending=True)[1].numpy()
        np.testing.assert_array_equal(idx, want)


# ------------------------------------------------------------ topk, unique


@pytest.mark.parametrize("largest", [True, False])
@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("dtype", ["float32", "int32", "bool", "float64"])
def test_topk(dtype, split, largest):
    x = _data((11, 6), dtype)
    for dim, k in ((0, 3), (1, 2), (0, 1), (1, 6)):
        _both(lambda ht, a: ht.topk(a, k, dim=dim, largest=largest), x, splits=[split])


def test_topk_out():
    x = htt.array(X2, split=0)
    out = (htt.zeros((2, 6)), htt.zeros((2, 6), dtype=htt.int64))
    v, i = htt.topk(x, 2, dim=0, out=out)
    assert np.array_equal(out[0].numpy(), v.numpy()) and np.array_equal(out[1].numpy(), i.numpy())


