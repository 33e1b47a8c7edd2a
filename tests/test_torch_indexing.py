"""heat_tpu_torch's indexing against heat_tpu: ``x[key]``, ``x[key] = v``,
``nonzero``, ``where`` and the DNDarray methods the indexing slice added.

One numpy input from a seeded ``np.random.default_rng`` goes through both
packages: heat_tpu on its 8-device CPU mesh, heat_tpu_torch as a world of
one rank on the CPU, split None, 0 and 1 (and 2 for a 3-D array), with row
counts that 8 does not divide. The key table is taken from
``tests/test_indexing.py`` and ``tests/test_indexing_deep.py``: steps and
negative steps, ``None`` and ``Ellipsis``, integer arrays with negative
entries, full and row masks (as arrays and as split DNDarrays), a boolean
array inside a tuple, and keys out of range, which raise ``IndexError`` in
both. Results are exact: values, type, split and the lshape map over 8
ranks. The JAX package sends some setitem keys through a host numpy copy
with a ``UserWarning``; the port applies them on the device and must not
warn. Several ranks (gloo) are in ``test_torch_manip_ranks.py``.
"""

import warnings

import numpy as np
import pytest
import torch

import heat_tpu as ht_tpu

import heat_tpu_torch as htt
from heat_tpu_torch.core import communication as tcomm

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
        return rng.integers(0, 50, size=shape).astype(dtype)
    return rng.standard_normal(shape).astype(dtype)


def _check(got, ref):
    """Same shape, split, type, lshape map over 8 ranks and values."""
    assert got.shape == tuple(ref.shape), (got.shape, ref.shape)
    assert got.split == ref.split, (got.split, ref.split)
    assert got.dtype.__name__ == ref.dtype.__name__, (got.dtype, ref.dtype)
    if got.ndim:
        np.testing.assert_array_equal(tcomm.lshape_map(got.shape, got.split, MESH),
                                      ref.lshape_map)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref.numpy()))


X2 = _data((11, 7))
X3 = _data((9, 5, 4), seed=1)
MASK2 = X2 > 0.3
ROWS = np.array([1, 0, 1, 1, 0, 0, 1, 0, 0, 1, 1], dtype=bool)

GET_KEYS_2D = {
    "int": 3, "neg_int": -1, "int_pair": (3, 4), "neg_pair": (-2, -7),
    "slice": slice(2, 9), "step": slice(1, 10, 3), "neg_step": slice(None, None, -1),
    "neg_step2": slice(9, 1, -3), "empty": slice(5, 5), "col": (slice(None), 2),
    "cols": (slice(None), slice(1, 4)), "cols_step": (slice(None), slice(None, None, -2)),
    "ellipsis": (Ellipsis, 0), "none": None, "none_mid": (slice(2, 8), None, 1),
    "int_slice": (4, slice(1, 6, 2)), "slice_int": (slice(1, 10, 4), -3),
    "iarr": np.array([1, -1, 4, 4, 0]), "iarr_list": [2, 7, 3],
    "iarr_cols": (slice(None), np.array([6, 0, -2])),
    "int_iarr": (2, np.array([1, 3])), "slice_iarr": (slice(1, 9, 2), np.array([0, 6, 5])),
    "iarr_slice": (np.array([8, 1]), slice(2, 5)),
    "pair": (np.array([1, 2, 10]), np.array([3, 4, 0])),
    "pair_bcast": (np.array([5]), np.array([0, 2, 6])),
    "mask": MASK2, "rowmask": ROWS, "mask_in_tuple": (ROWS, 2),
    "mask_slice": (ROWS, slice(1, 5)), "iarr_2d": np.array([[1, 2], [3, -1]]),
    "two_iarr_ellipsis": (Ellipsis, np.array([0, 2])),
}


@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("name", sorted(GET_KEYS_2D))
def test_getitem_2d(name, split):
    key = GET_KEYS_2D[name]
    got = htt.array(X2, split=split)[key]
    ref = ht_tpu.array(X2, split=split)[key]
    _check(got, ref)


GET_KEYS_3D = {
    "int0": 4, "int1": (slice(None), 3), "int2": (Ellipsis, 1), "step0": slice(None, None, 2),
    "negstep1": (slice(None), slice(None, None, -1)), "negstep2": (Ellipsis, slice(3, 0, -2)),
    "mixed": (slice(1, 8, 3), 2, slice(None, None, -1)), "none_front": (None, 2),
    "iarr1": (slice(None), np.array([4, 0, -1])), "iarr2": (slice(None), slice(None), [3, 1]),
    "int_iarr_int": (3, np.array([0, 2]), 1), "pair12": (slice(None), np.array([1, 2]),
                                                          np.array([3, 0])),
    "mask": X3 > 0, "rowmask": np.arange(9) % 3 == 0,
}


@pytest.mark.parametrize("split", [None, 0, 1, 2])
@pytest.mark.parametrize("name", sorted(GET_KEYS_3D))
def test_getitem_3d(name, split):
    key = GET_KEYS_3D[name]
    _check(htt.array(X3, split=split)[key], ht_tpu.array(X3, split=split)[key])


@pytest.mark.parametrize("dtype", ["int32", "bool", "float64", "uint8", "int8", "uint32"])
@pytest.mark.parametrize("split", [None, 0])
def test_getitem_types(dtype, split):
    x = _data((10, 3), dtype)
    for key in (slice(None, None, -3), np.array([9, 0, 4]), 7, (slice(1, 8), 1)):
        _check(htt.array(x, split=split)[key], ht_tpu.array(x, split=split)[key])


@pytest.mark.parametrize("mask_split", [None, 0, 1])
@pytest.mark.parametrize("split", [None, 0, 1])
def test_getitem_dndarray_masks(split, mask_split):
    """Full-shape masks and row masks given as DNDarrays of any split."""
    got = htt.array(X2, split=split)[htt.array(MASK2, split=mask_split)]
    ref = ht_tpu.array(X2, split=split)[ht_tpu.array(MASK2, split=mask_split)]
    _check(got, ref)
    if mask_split != 1:
        got = htt.array(X2, split=split)[htt.array(ROWS, split=mask_split)]
        ref = ht_tpu.array(X2, split=split)[ht_tpu.array(ROWS, split=mask_split)]
        _check(got, ref)


def test_getitem_index_dndarray_split():
    idx = np.array([10, 3, -2, 0])
    for s in (None, 0):
        _check(htt.array(X2, split=0)[htt.array(idx, split=s)],
               ht_tpu.array(X2, split=0)[ht_tpu.array(idx, split=s)])


@pytest.mark.parametrize("key", [11, -12, (0, 7), np.array([11]), np.array([0, -12]),
                                 (slice(None), np.array([7]))], ids=str)
@pytest.mark.parametrize("split", [None, 0])
def test_getitem_out_of_range_raises(key, split):
    with pytest.raises(IndexError):
        ht_tpu.array(X2, split=split)[key]
    with pytest.raises(IndexError):
        htt.array(X2, split=split)[key]


@pytest.mark.parametrize("key", [1.5, (0, 1.5), np.array([1.5]), (Ellipsis, Ellipsis), (0, 0, 0),
                                 "a", np.zeros((4, 4), bool)], ids=str)
def test_getitem_invalid_keys_raise(key):
    """Keys numpy rejects raise the JAX package's exception type."""
    with pytest.raises(Exception) as ref:
        ht_tpu.array(X2, split=0)[key]
    with pytest.raises(ref.type):
        htt.array(X2, split=0)[key]


SET_CASES = {
    "int": (3, -1.0), "int_pair": ((3, 4), -2.5), "row_vec": (2, np.full(7, 9.0, np.float32)),
    "block": ((slice(2, 7), slice(1, 3)), 0.5), "all": (slice(None), 1.0),
    "neg_int": (-1, 7.0), "step": (slice(1, 10, 3), np.arange(7, dtype=np.float32)),
    "neg_step": (slice(None, None, -2), np.arange(6, dtype=np.float32)[:, None]),
    "iarr": (np.array([1, -1]), 4.0), "iarr_rows": (np.array([0, 5, 9]),
                                                    np.arange(21, dtype=np.float32).reshape(3, 7)),
    "col": ((slice(None), 3), np.arange(11, dtype=np.float32)), "none": ((None, 4), 3.0),
    "ellipsis": ((Ellipsis, -2), 8.0), "mask_scalar": (MASK2, 0.0),
    "mask_full": (MASK2, -X2), "mask_ragged": (MASK2, np.arange(MASK2.sum(), dtype=np.float32)),
    "rowmask": (ROWS, 5.0), "rowmask_rows": (ROWS, np.arange(7, dtype=np.float32)),
    "bool_tuple": ((ROWS, 2), 42.0),
    "bool_tuple_vec": ((ROWS, 2), np.arange(ROWS.sum(), dtype=np.float32)),
    "bool_tuple_negstep": ((ROWS, slice(None, None, -2)),
                           np.arange(ROWS.sum() * 4, dtype=np.float32).reshape(-1, 4)),
    "bool_tuple_2d": ((MASK2[:, :1].repeat(7, 1) & MASK2, ), 1.5),
    "iarr_cols": ((slice(1, 9), np.array([0, -1])), -3.0),
    "pair": ((np.array([1, 2, 10]), np.array([3, 4, 0])), np.array([1.0, 2.0, 3.0], np.float32)),
}


@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("name", sorted(SET_CASES))
def test_setitem(name, split):
    key, value = SET_CASES[name]
    got = htt.array(X2, split=split)
    ref = ht_tpu.array(X2, split=split)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # the JAX package's host path
        ref[key] = value
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # the port never falls back quietly
        got[key] = value
    _check(got, ref)


@pytest.mark.parametrize("value_split", [None, 0, 1])
@pytest.mark.parametrize("split", [None, 0, 1])
def test_setitem_dndarray_values(split, value_split):
    """A value held as a DNDarray of another split lands where numpy puts it."""
    cases = [(slice(2, 9), _data((7, 7), seed=3)), (slice(None, None, -1), _data((11, 7), seed=4)),
             (MASK2, _data((11, 7), seed=5))]
    for key, v in cases:
        got, ref = htt.array(X2, split=split), ht_tpu.array(X2, split=split)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            ref[key] = ht_tpu.array(v, split=value_split)
        got[key] = htt.array(v, split=value_split)
        _check(got, ref)
    ragged = np.arange(MASK2.sum(), dtype=np.float32)
    for mask_split in (None, 0):
        got, ref = htt.array(X2, split=split), ht_tpu.array(X2, split=split)
        ref[ht_tpu.array(MASK2, split=mask_split)] = ht_tpu.array(ragged, split=value_split and 0)
        got[htt.array(MASK2, split=mask_split)] = htt.array(ragged, split=value_split and 0)
        _check(got, ref)


@pytest.mark.parametrize("dtype", ["int32", "bool", "int64", "float64", "uint16", "uint64"])
@pytest.mark.parametrize("split", [None, 0, 1])
def test_setitem_types(dtype, split):
    x = _data((9, 4), dtype)
    for key, value in ((slice(1, 8, 2), 1), (np.array([0, -1]), 0), (x > 10 if dtype != "bool"
                                                                      else x, 1)):
        got, ref = htt.array(x, split=split), ht_tpu.array(x, split=split)
        ref[key] = value
        got[key] = value
        _check(got, ref)


@pytest.mark.parametrize("split", [None, 0])
def test_setitem_errors(split):
    for key, value, exc in ((11, 0.0, IndexError), (np.array([0, 12]), 5.0, IndexError),
                            (MASK2, np.ones(2, np.float32), ValueError)):
        with pytest.raises(exc):
            ht_tpu.array(X2, split=split)[key] = value
        with pytest.raises(exc):
            htt.array(X2, split=split)[key] = value


def test_setitem_copies_a_shared_chunk():
    """A write never reaches an array that shares the chunk (a getitem or a
    reshape result), as in the JAX package, whose arrays never alias."""
    x = htt.array(X2, split=0)
    y = x[2:5]
    r = htt.reshape(x, (7, 11))
    x[:] = 0.0
    np.testing.assert_array_equal(y.numpy(), X2[2:5])
    np.testing.assert_array_equal(r.numpy(), X2.reshape(7, 11))
    assert (x.numpy() == 0).all()


@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("dtype", ["float32", "int32", "bool"])
def test_nonzero(dtype, split):
    x = _data((11, 6), dtype)
    x = np.where(np.arange(66).reshape(11, 6) % 4 == 0, 0, x).astype(dtype)
    _check(htt.nonzero(htt.array(x, split=split)), ht_tpu.nonzero(ht_tpu.array(x, split=split)))
    _check(htt.where(htt.array(x, split=split)), ht_tpu.where(ht_tpu.array(x, split=split)))


@pytest.mark.parametrize("split", [None, 0, 1])
def test_where(split):
    c, y = MASK2, _data((11, 7), seed=2)
    _check(htt.where(htt.array(c, split=split), htt.array(X2, split=split), htt.array(y)),
           ht_tpu.where(ht_tpu.array(c, split=split), ht_tpu.array(X2, split=split),
                        ht_tpu.array(y)))
    _check(htt.where(htt.array(c, split=split), htt.array(X2, split=split), 0.0),
           ht_tpu.where(ht_tpu.array(c, split=split), ht_tpu.array(X2, split=split), 0.0))
    _check(htt.where(htt.array(c, split=split), 1, htt.array(y[0])),
           ht_tpu.where(ht_tpu.array(c, split=split), 1, ht_tpu.array(y[0])))
    if split is not None:
        with pytest.raises(ValueError):
            ht_tpu.where(ht_tpu.array(c, split=split), ht_tpu.array(X2, split=1 - split), 0.0)
        with pytest.raises(ValueError):
            htt.where(htt.array(c, split=split), htt.array(X2, split=1 - split), 0.0)


@pytest.mark.parametrize("split", [None, 0, 1])
def test_dndarray_methods(split):
    """The metadata, conversions and layout methods of the DNDarray."""
    got, ref = htt.array(X2, split=split), ht_tpu.array(X2, split=split)
    for name in ("gshape", "gnumel", "nbytes", "gnbytes", "ndim", "size"):
        assert getattr(got, name) == getattr(ref, name), name
    assert got.lnumel == int(np.prod(got.lshape)) and got.lnbytes == got.lnumel * 4
    assert got.strides == got.stride() == (7, 1)
    assert got.padded_shape == X2.shape and got.pad_count == 0  # a world of one stores no pad
    assert got.is_distributed() is False and got.is_balanced() and got.balance_() is None
    np.testing.assert_array_equal(got.create_lshape_map(), got.lshape_map)
    assert got.tolist() == ref.tolist()
    np.testing.assert_array_equal(np.asarray(got), X2)
    one = htt.array(X2[:1, :1], split=split)
    assert one.item() == float(X2[0, 0]) and float(one) == float(X2[0, 0])
    s1 = None if split is None else 0
    assert bool(htt.array([1], split=s1)) and int(htt.array([7], split=s1)) == 7
    assert complex(htt.array([2.0])) == 2 + 0j and [1, 2, 3][htt.array(1)] == 2
    with pytest.raises(ValueError):
        got.item()
    with pytest.raises(TypeError):
        float(got)
    rows = list(iter(got))
    assert len(rows) == 11 and np.array_equal(rows[4].numpy(), X2[4])
    assert got.cpu().device == htt.cpu and np.array_equal(got.cpu().numpy(), X2)
    cplx = htt.array((X2 + 2j * X2).astype(np.complex64), split=split)
    np.testing.assert_array_equal(cplx.real.numpy(), X2)
    np.testing.assert_array_equal(cplx.imag.numpy(), 2 * X2)
    assert got.lloc[0, 0].item() == X2[0, 0]
    got.lloc[0, 0] = 99.0
    assert got.numpy()[0, 0] == 99.0
    moved = htt.array(X2, split=split).resplit_(0 if split != 0 else 1)
    assert moved.split == (0 if split != 0 else 1) and np.array_equal(moved.numpy(), X2)
    got.redistribute_(target_map=got.lshape_map)
    with pytest.raises(NotImplementedError):
        got.redistribute_(target_map=np.array([[5, 7]]) if split == 0 else np.array([[11, 3]]))
    for s in (None, 0, 1):
        f, r = htt.array(X2, split=s), ht_tpu.array(X2, split=s)
        f.fill_diagonal(-4.0)
        r.fill_diagonal(-4.0)
        _check(f, r)
    with pytest.raises(ValueError):
        htt.array(X3).fill_diagonal(0)
    with pytest.raises(TypeError):
        len(htt.array(3.0))


def test_halos_world_of_one():
    x = htt.array(X2, split=0)
    assert x.get_halo(2) is None and x.halo_prev is None and x.halo_next is None
    assert torch.equal(x.array_with_halos(2), x.larray)
    with pytest.raises(ValueError):
        x.get_halo(0)


def test_padded_shape_follows_the_chunk_rule():
    """On p ranks ``padded_shape`` is the JAX package's ``ceil(n/p)*p``."""
    ref = ht_tpu.array(X2, split=0)
    assert ref.padded_shape == (tcomm.padded_size(11, MESH), 7)
    assert ref.pad_count == tcomm.padded_size(11, MESH) - 11
