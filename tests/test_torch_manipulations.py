"""heat_tpu_torch's manipulations against heat_tpu: every name of
``manipulations.__all__``, with the DNDarray methods it attaches.

One numpy input from a seeded ``np.random.default_rng`` goes through both
packages: heat_tpu on its 8-device CPU mesh, heat_tpu_torch as a world of
one rank on the CPU, split None, 0 and 1 (2 for a 3-D array), row counts
that 8 does not divide. Results are exact: values, indices, type, split
and the lshape map over 8 ranks. The cases come from
``tests/test_manipulations*.py``, ``tests/test_sort_distributed.py`` and
``tests/test_concatenate_cases.py``.
``sort``, ``topk`` and the merge-split network are in
``test_torch_sort.py``, ``unique`` in ``test_torch_unique.py``, several
ranks (gloo) in ``test_torch_manip_ranks.py``.
"""

import numpy as np
import pytest

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
X3 = _data((7, 5, 4), seed=1)
V1 = _data((13,), seed=2)

CASES_2D = {
    "balance": lambda ht, x: ht.balance(x, copy=True),
    "column_stack": lambda ht, x: ht.column_stack([x, x[:, :2]]),
    "concatenate0": lambda ht, x: ht.concatenate([x, x[:4]], axis=0),
    "concatenate1": lambda ht, x: ht.concatenate([x, x[:, 1:]], axis=1),
    "concatenate3": lambda ht, x: ht.concatenate([x[:3], x, x[5:]], axis=0),
    "diag": lambda ht, x: ht.diag(x, 1),
    "diag_neg": lambda ht, x: ht.diag(x, -3),
    "diagonal": lambda ht, x: ht.diagonal(x),
    "diagonal_t": lambda ht, x: ht.diagonal(x, offset=2, dim1=1, dim2=0),
    "expand_dims": lambda ht, x: ht.expand_dims(x, 1),
    "expand_dims_neg": lambda ht, x: x.expand_dims(-1),
    "flatten": lambda ht, x: ht.flatten(x),
    "flip": lambda ht, x: ht.flip(x),
    "flip0": lambda ht, x: ht.flip(x, 0),
    "flip1": lambda ht, x: ht.flip(x, 1),
    "fliplr": lambda ht, x: ht.fliplr(x),
    "flipud": lambda ht, x: ht.flipud(x),
    "hsplit": lambda ht, x: ht.hsplit(x, 3),
    "hstack": lambda ht, x: ht.hstack([x, x]),
    "moveaxis": lambda ht, x: ht.moveaxis(x, 0, 1),
    "pad": lambda ht, x: ht.pad(x, ((1, 2), (0, 3)), constant_values=(7, -1)),
    "pad_edge": lambda ht, x: ht.pad(x, 2, mode="edge"),
    "pad_reflect": lambda ht, x: ht.pad(x, ((3, 1), (2, 4)), mode="reflect"),
    "pad_symmetric": lambda ht, x: ht.pad(x, 3, mode="symmetric"),
    "pad_wrap": lambda ht, x: ht.pad(x, ((2, 9), (1, 1)), mode="wrap"),
    "ravel": lambda ht, x: ht.ravel(x),
    "redistribute": lambda ht, x: ht.redistribute(x, target_map=x.lshape_map),
    "repeat": lambda ht, x: ht.repeat(x, 2),
    "repeat0": lambda ht, x: ht.repeat(x, 3, axis=0),
    "repeat1": lambda ht, x: ht.repeat(x, 2, axis=1),
    "repeat_arr": lambda ht, x: ht.repeat(x, [1, 0, 2, 1, 1, 3], axis=1),
    "reshape": lambda ht, x: ht.reshape(x, (6, 11)),
    "reshape_3d": lambda ht, x: ht.reshape(x, (3, 2, 11), new_split=2),
    "reshape_neg": lambda ht, x: x.reshape(-1, 3),
    "reshape_ns0": lambda ht, x: ht.reshape(x, (33, 2), new_split=0),
    "reshape_ns1": lambda ht, x: ht.reshape(x, (2, 33), new_split=1),
    "reshape_keep": lambda ht, x: ht.reshape(x, (11, 2, 3)),
    "resplit_none": lambda ht, x: ht.resplit(x, None),
    "resplit0": lambda ht, x: ht.resplit(x, 0),
    "resplit1": lambda ht, x: ht.resplit(x, 1),
    "roll": lambda ht, x: ht.roll(x, 5),
    "roll0": lambda ht, x: ht.roll(x, 3, 0),
    "roll0_neg": lambda ht, x: ht.roll(x, -14, 0),
    "roll1": lambda ht, x: ht.roll(x, 2, 1),
    "roll_both": lambda ht, x: ht.roll(x, (4, -1), (0, 1)),
    "rot90": lambda ht, x: ht.rot90(x),
    "rot90_2": lambda ht, x: ht.rot90(x, 2),
    "rot90_3": lambda ht, x: ht.rot90(x, 3),
    "rot90_0": lambda ht, x: ht.rot90(x, 4),
    "row_stack": lambda ht, x: ht.row_stack([x, x[:2]]),
    "shape": lambda ht, x: ht.shape(x),
    "split": lambda ht, x: ht.split(x, [2, 7, 9], axis=0),
    "split_sections": lambda ht, x: ht.split(x, 2, axis=1),
    "split_cols": lambda ht, x: ht.split(x, [1, 4], axis=1),
    "squeeze": lambda ht, x: ht.squeeze(x[:, 2:3]),
    "squeeze_row": lambda ht, x: x[3:4].squeeze(0),
    "stack": lambda ht, x: ht.stack([x, x, x]),
    "stack1": lambda ht, x: ht.stack([x, x], axis=1),
    "stack_last": lambda ht, x: ht.stack([x, x], axis=-1),
    "swapaxes": lambda ht, x: ht.swapaxes(x, 0, 1),
    "tile": lambda ht, x: ht.tile(x, (1, 2)),
    "tile_split": lambda ht, x: ht.tile(x, (2, 1)),
    "tile_3": lambda ht, x: ht.tile(x, (2, 1, 2)),
    "vsplit": lambda ht, x: ht.vsplit(x, [3, 8]),
    "vstack": lambda ht, x: ht.vstack([x, x]),
}


@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("name", sorted(CASES_2D))
def test_manipulations_2d(name, split):
    _both(CASES_2D[name], X2, splits=[split])


CASES_3D = {
    "diagonal": lambda ht, x: ht.diagonal(x, 1, 0, 2),
    "dsplit": lambda ht, x: ht.dsplit(x, 2),
    "flip02": lambda ht, x: ht.flip(x, (0, 2)),
    "moveaxis": lambda ht, x: ht.moveaxis(x, (0, 1), (2, 0)),
    "reshape": lambda ht, x: ht.reshape(x, (35, 4)),
    "reshape_split_last": lambda ht, x: ht.reshape(x, (5, 7, 4)),
    "roll": lambda ht, x: ht.roll(x, 6),
    "roll2": lambda ht, x: ht.roll(x, -3, 2),
    "rot90": lambda ht, x: ht.rot90(x, 1, (1, 2)),
    "squeeze": lambda ht, x: ht.squeeze(ht.expand_dims(x, 1)),
    "stack": lambda ht, x: ht.stack([x, x], axis=2),
    "swapaxes": lambda ht, x: ht.swapaxes(x, 0, 2),
    "tile": lambda ht, x: ht.tile(x, 2),
    "concatenate2": lambda ht, x: ht.concatenate([x, x], axis=2),
    "flatten": lambda ht, x: x.flatten(),
}


@pytest.mark.parametrize("split", [None, 0, 1, 2])
@pytest.mark.parametrize("name", sorted(CASES_3D))
def test_manipulations_3d(name, split):
    _both(CASES_3D[name], X3, splits=[split])


CASES_1D = {
    "diag": lambda ht, v: ht.diag(v),
    "diag_k": lambda ht, v: ht.diag(v, -2),
    "flip": lambda ht, v: ht.flip(v),
    "roll": lambda ht, v: ht.roll(v, 4),
    "hstack": lambda ht, v: ht.hstack([v, v[:3]]),
    "vstack": lambda ht, v: ht.vstack([v, v]),
    "column_stack": lambda ht, v: ht.column_stack([v, v]),
    "repeat_arr": lambda ht, v: ht.repeat(v, np.arange(13) % 3),
    "pad": lambda ht, v: ht.pad(v, (2, 5)),
    "tile": lambda ht, v: ht.tile(v, 3),
    "reshape": lambda ht, v: ht.reshape(v, (13, 1)),
    "split_indices": lambda ht, v: ht.split(v, [4, 4, 10]),
    "hsplit": lambda ht, v: ht.hsplit(v, [6]),
    "expand_dims": lambda ht, v: ht.expand_dims(v, 0),
}


@pytest.mark.parametrize("split", [None, 0])
@pytest.mark.parametrize("name", sorted(CASES_1D))
def test_manipulations_1d(name, split):
    _both(CASES_1D[name], V1, splits=[split])


CONCAT_TABLE = [(None, None, 0), (None, None, 1), (0, 0, 0), (0, 0, 1), (1, 1, 0), (1, 1, 1),
                (0, None, 0), (None, 0, 0), (0, None, 1), (None, 1, 1), (1, None, 0)]


@pytest.mark.parametrize("sa,sb,axis", CONCAT_TABLE)
def test_concatenate_split_table(sa, sb, axis):
    a = _data((5, 6), seed=3)
    b = _data(tuple(7 if d == axis else s for d, s in enumerate((5, 6))), seed=4)
    _both(lambda ht, x, y: ht.concatenate([x, y], axis=axis), a, b, splits=[sa, sb])
    _both(lambda ht, x, y: ht.concatenate([x, y.astype(ht.int32)], axis=axis), a, b,
          splits=[sa, sb])


def test_concatenate_and_stack_errors():
    for ht in (htt, ht_tpu):
        a, b = ht.array(X2, split=0), ht.array(X2, split=1)
        with pytest.raises(RuntimeError):
            ht.concatenate([a, b])
        with pytest.raises(RuntimeError):
            ht.stack([a, b])
        with pytest.raises(ValueError):
            ht.concatenate([])
        with pytest.raises(ValueError):
            ht.split(a, 4)
        with pytest.raises(ValueError):
            ht.reshape(a, (5, 5))
        with pytest.raises(ValueError):
            ht.squeeze(a, 0)
        with pytest.raises(ValueError):
            ht.roll(a, (1, 2), 0)
        with pytest.raises(IndexError):
            ht.fliplr(ht.array(V1))


def test_exports_cover_the_reference():
    from heat_tpu.core import manipulations as ref_man

    assert sorted(tman.__all__) == sorted(ref_man.__all__)
    for name in ref_man.__all__ + ["nonzero", "where", "percentile", "median"]:
        assert callable(getattr(htt, name)), name
    for name in ("expand_dims", "flatten", "ravel", "reshape", "squeeze", "unique"):
        assert callable(getattr(htt.DNDarray, name)), name
