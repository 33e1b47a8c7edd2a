"""``sparse`` (the container, its products, transpose and constructors),
``core.tiling`` and ``core.ragged`` of heat_tpu_torch against heat_tpu.

One numpy input from a seeded ``np.random.default_rng`` goes through both
packages, heat_tpu_torch as a world of one rank on the CPU:

* layout, against heat_tpu on a one-device communicator (the same world
  size): the shard's ``indptr``, the first ``counts`` indices and values,
  ``counts`` and ``capacity`` bit for bit, for ``csr_from_dense`` (numpy
  and DNDarray inputs, split None/0/1, the three ``keep`` rules,
  ``include_diagonal``, empty rows, an all-zero matrix), ``csr_from_coo``
  (host and DNDarray triplets) and ``transpose`` (staged and not); the
  tiling index calculus and ``Ragged``'s metadata exactly;
* values, against heat_tpu on its 8-device mesh as well: ``to_dense`` and
  the exact-type products bit for bit; ``spmv``/``spmm`` for every
  ``x.split``, ``out_split``, ``reduce`` and ``pattern``, float32 sums
  within 1e-6 relative to the largest |value| (the port's CSR product adds
  in another order) and min/max, ``pattern`` and integer results bit for
  bit. An empty row of a replicated float min/max is ±finfo.max on several
  ranks and ±inf on one in both packages, so that row is held to the
  one-device reference.

The multi-rank cases (three gloo ranks) are in ``tests/test_torch_linalg.py``.
"""

import jax
import numpy as np
import pytest
import torch

import heat_tpu as ht_tpu
from heat_tpu.core.communication import MeshCommunication

import heat_tpu_torch as htt


@pytest.fixture(autouse=True)
def on_cpu():
    htt.use_device("cpu")
    yield
    htt.use_device(None)


def _one():
    return MeshCommunication(devices=jax.devices()[:1])


def _matrix(shape, density=0.3, seed=0, dtype=np.float32, empty_rows=(1,)):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(shape) * (rng.random(shape) < density)
    for r in empty_rows:
        if r < shape[0]:
            a[r] = 0.0
    if np.issubdtype(dtype, np.integer):
        a = np.round(a * 5)
    return a.astype(dtype)


def _hold_shard(got, ref):
    """The port's one-rank shard against the JAX package's one-device
    shard, bit for bit."""
    assert got.shape == tuple(ref.shape) and got.dtype.__name__ == ref.dtype.__name__
    assert got.counts.tolist() == ref.counts.tolist() and got.capacity == ref.capacity
    assert got.nnz == ref.nnz and got.displs.tolist() == ref.displs.tolist()
    np.testing.assert_array_equal(got.indptr.numpy(), np.asarray(ref.indptr))
    c = int(ref.counts[0])
    np.testing.assert_array_equal(got.indices.numpy()[:c], np.asarray(ref.indices)[:c])
    np.testing.assert_array_equal(got.values.numpy()[:c], np.asarray(ref.values)[:c])
    assert got.indptr.dtype == torch.int32 and got.indices.dtype == torch.int32


# ------------------------------------------------------------------ tiling


@pytest.mark.parametrize("shape,split", [((7, 5), 0), ((7, 5), 1), ((4, 6, 3), 2),
                                         ((5,), None)])
def test_split_tiles_match_reference(shape, split):
    data = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    got = htt.SplitTiles(htt.array(data, split=split))
    ref = ht_tpu.SplitTiles(ht_tpu.array(data, split=split, comm=_one()))
    for name in ("tile_dimensions", "tile_ends_g", "tile_locations", "lshape_map"):
        np.testing.assert_array_equal(getattr(got, name), np.asarray(getattr(ref, name)), name)
    assert got.get_tile_size(0) == ref.get_tile_size(0)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[-1].numpy(), np.asarray(ref[-1]))
    got[0] = 7.0
    assert (got.arr.numpy() == 7.0).all()


def test_split_tiles_errors():
    tiles = htt.SplitTiles(htt.array(np.zeros((4, 4), np.float32), split=0))
    with pytest.raises(IndexError):
        tiles[3]
    with pytest.raises(ValueError):
        tiles[::2]
    with pytest.raises(TypeError):
        tiles["a"]
    with pytest.raises(ValueError):
        tiles[0, 0, 0]
    with pytest.raises(TypeError):
        htt.SplitTiles(np.zeros(3))


@pytest.mark.parametrize("shape,split,tpp", [((12, 5), 0, 2), ((5, 12), 1, 3), ((9, 9), 0, 1),
                                             ((6, 8), 0, 4)])
def test_square_diag_tiles_match_reference(shape, split, tpp):
    data = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    got = htt.SquareDiagTiles(htt.array(data, split=split), tiles_per_proc=tpp)
    ref = ht_tpu.SquareDiagTiles(ht_tpu.array(data, split=split, comm=_one()), tiles_per_proc=tpp)
    for name in ("row_indices", "col_indices", "tile_rows", "tile_columns",
                 "tile_rows_per_process", "tile_columns_per_process", "last_diagonal_process"):
        assert getattr(got, name) == getattr(ref, name), name
    np.testing.assert_array_equal(got.tile_map, ref.tile_map)
    assert got.get_start_stop((1, -1)) == ref.get_start_stop((1, -1))
    np.testing.assert_array_equal(got[0, 1].numpy(), np.asarray(ref[0, 1]))
    got[0, 0] = -1.0
    r0, r1, c0, c1 = got.get_start_stop((0, 0))
    assert (got.arr.numpy()[r0:r1, c0:c1] == -1.0).all()
    for bad in (dict(arr=np.zeros((3, 3))), dict(arr=htt.array(np.zeros(3), split=0)),
                dict(arr=htt.array(np.zeros((3, 3))))):
        with pytest.raises((TypeError, ValueError)):
            htt.SquareDiagTiles(**bad)


# ------------------------------------------------------------------ ragged


@pytest.mark.parametrize("split", [None, 0])
def test_ragged_matches_reference(split):
    data = np.arange(21, dtype=np.float32).reshape(7, 3)
    got = htt.ragged(data, [7], split=split)
    ref = ht_tpu.ragged(data, [7], split=split, comm=_one())
    assert got.counts.tolist() == ref.counts.tolist() and got.displs.tolist() == \
        ref.displs.tolist() and got.axis == ref.axis
    np.testing.assert_array_equal(got.owner.numpy(), np.asarray(ref.owner.numpy()))
    assert got.owner.split == ref.owner.split
    np.testing.assert_array_equal(got.mask(0).numpy(), np.asarray(ref.mask(0).numpy()))
    np.testing.assert_array_equal(got.block(0).numpy(), np.asarray(ref.block(0).numpy()))
    moved = got.resplit(1)
    assert moved.array.split == 1 and moved.counts.tolist() == [7]
    np.testing.assert_array_equal(moved.array.numpy(), data)
    again = got.redistribute([7])
    assert again.array is got.array and "Ragged(counts=[7]" in repr(again)
    blocks = htt.ragged([data[:4]], split=0)
    assert blocks.counts.tolist() == [4] and blocks.array.shape == (4, 3)
    cast = htt.ragged(htt.array(data, split=0), [7], dtype=htt.float64)
    assert cast.array.dtype is htt.float64


def test_ragged_errors():
    x = htt.array(np.zeros((4, 2), np.float32), split=0)
    for args, err in (((np.zeros(3), [3]), TypeError), ((x, [1, 2]), ValueError),
                      ((x, [-4]), ValueError), ((x, [4], 2), ValueError), ((x, [3]), ValueError)):
        with pytest.raises(err):
            htt.Ragged(*args)
    r = htt.Ragged(x, [4])
    for bad in (-1, 1):
        with pytest.raises(ValueError):
            r.mask(bad)
        with pytest.raises(ValueError):
            r.block(bad)
    with pytest.raises(ValueError):
        htt.ragged([np.zeros(2), np.zeros(2)])


# ------------------------------------------------------------------ CsrRows


def test_csr_rows_match_reference():
    dense = _matrix((5, 6), seed=2)
    got, ref = htt.sparse.CsrRows.from_dense(dense), ht_tpu.sparse.CsrRows.from_dense(dense)
    for name in ("indptr", "indices", "values"):
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name))
    assert (got.shape, got.nnz, len(got), repr(got)) == (ref.shape, ref.nnz, len(ref), repr(ref))
    np.testing.assert_array_equal(got.to_dense(), dense)
    cat = htt.sparse.CsrRows.concat([got[0:2], got[2:5].padded(4, got[2:5].nnz + 3)])
    np.testing.assert_array_equal(cat.to_dense()[:5], dense)
    ref_cat = ht_tpu.sparse.CsrRows.concat([ref[0:2], ref[2:5].padded(4, ref[2:5].nnz + 3)])
    np.testing.assert_array_equal(cat.indptr, ref_cat.indptr)
    np.testing.assert_array_equal(htt.sparse.CsrRows.from_dense(dense[0]).to_dense(),
                                  dense[:1])
    for call in (lambda: htt.sparse.CsrRows([1, 1], [], [], 3),
                 lambda: htt.sparse.CsrRows([0, 2, 1], [0, 1], [1, 2], 3),
                 lambda: htt.sparse.CsrRows([0, 3], [0, 1], [1, 2], 3),
                 lambda: htt.sparse.CsrRows([0, 1], [5], [1], 3),
                 lambda: htt.sparse.CsrRows([0], [], [], 0),
                 lambda: got.padded(2, 100),
                 lambda: htt.sparse.CsrRows.concat([]),
                 lambda: htt.sparse.CsrRows.concat([got, htt.sparse.CsrRows([0], [], [], 2)])):
        with pytest.raises(ValueError):
            call()
    with pytest.raises(TypeError):
        got[::2]


# ---------------------------------------------------------------- construction

DENSE_CASES = {
    "7x5": ((7, 5), np.float32, 0.3),
    "13x13": ((13, 13), np.float32, 0.25),
    "1x4": ((1, 4), np.float32, 0.6),
    "3x9_f64": ((3, 9), np.float64, 0.4),
    "6x6_int32": ((6, 6), np.int32, 0.5),
    "5x7_int64": ((5, 7), np.int64, 0.5),
    "4x4_zero": ((4, 4), np.float32, 0.0),
}


@pytest.mark.parametrize("name", list(DENSE_CASES))
@pytest.mark.parametrize("source", ["numpy", None, 0, 1])
def test_csr_from_dense_shards_match_reference(name, source):
    shape, dtype, density = DENSE_CASES[name]
    dense = _matrix(shape, density, seed=3, dtype=dtype)
    if source == "numpy":
        got = htt.sparse.csr_from_dense(dense)
        ref = ht_tpu.sparse.csr_from_dense(dense, comm=_one())
    else:
        got = htt.sparse.csr_from_dense(htt.array(dense, split=source))
        ref = ht_tpu.sparse.csr_from_dense(ht_tpu.array(dense, split=source, comm=_one()))
    _hold_shard(got, ref)
    assert got.density == ref.density and got.split == 0 and got.ndim == 2
    np.testing.assert_array_equal(got.to_dense().numpy(), dense)
    assert got.to_dense().split == 0
    mesh = ht_tpu.sparse.csr_from_dense(dense)  # the 8-device mesh: the same values
    np.testing.assert_array_equal(got.to_dense().numpy(), np.asarray(mesh.to_dense().numpy()))
    assert got.coo()[0].tolist() == mesh.coo()[0].tolist()
    for a, b in zip(got.coo(), mesh.coo()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("keep,threshold", [("nonzero", 0.5), ("above", 0.2), ("below", -0.3),
                                            ("above", -10.0)])
@pytest.mark.parametrize("diag", [False, True])
def test_csr_from_dense_rules_and_diagonal(keep, threshold, diag):
    dense = _matrix((9, 9), 0.5, seed=4)
    kw = dict(threshold=threshold, keep=keep, include_diagonal=diag)
    got = htt.sparse.csr_from_dense(htt.array(dense, split=0), **kw)
    ref = ht_tpu.sparse.csr_from_dense(ht_tpu.array(dense, split=0, comm=_one()), **kw)
    _hold_shard(got, ref)
    np.testing.assert_array_equal(got.to_dense().numpy(), np.asarray(ref.to_dense().numpy()))


def test_csr_from_dense_errors():
    for ht in (htt, ht_tpu):
        with pytest.raises(ValueError, match="keep"):
            ht.sparse.csr_from_dense(np.eye(3), keep="odd")
        with pytest.raises(ValueError, match="2-D"):
            ht.sparse.csr_from_dense(np.ones(3))
        with pytest.raises(ValueError, match="square"):
            ht.sparse.csr_from_dense(np.ones((2, 3)), include_diagonal=True)
    with pytest.raises(ValueError, match="positive"):
        htt.sparse.SparseDNDarray.from_shard_arrays(
            torch.zeros(1, dtype=torch.int32), torch.zeros(1, dtype=torch.int32), torch.zeros(1),
            (0, 3), np.array([0]))
    ip = torch.zeros(4, dtype=torch.int32)
    for args in ((ip, torch.zeros(2, dtype=torch.int32), torch.zeros(2), (3, 3), [3]),
                 (ip[:2], torch.zeros(2, dtype=torch.int32), torch.zeros(2), (3, 3), [0]),
                 (ip, torch.zeros(2, dtype=torch.int32), torch.zeros(3), (3, 3), [0]),
                 (ip, torch.zeros(2, dtype=torch.int32), torch.zeros(2), (3, 3), [0, 0]),
                 (ip, torch.zeros(2, dtype=torch.int32), torch.zeros(2), (3, 3), [-1])):
        with pytest.raises(ValueError):
            htt.sparse.SparseDNDarray.from_shard_arrays(*args)


def _coo(seed=5, m=9, n=7, nnz=20):
    rng = np.random.default_rng(seed)
    flat = rng.choice(m * n, size=nnz, replace=False)
    rows, cols = flat // n, flat % n
    vals = rng.standard_normal(nnz).astype(np.float32)
    return rows, cols, vals


@pytest.mark.parametrize("split", ["host", None, 0])
def test_csr_from_coo_matches_reference(split):
    rows, cols, vals = _coo()
    if split == "host":
        got = htt.sparse.csr_from_coo(rows, cols, vals, (9, 7))
        ref = ht_tpu.sparse.csr_from_coo(rows, cols, vals, (9, 7), comm=_one())
    else:
        got = htt.sparse.csr_from_coo(htt.array(rows, split=split), htt.array(cols, split=split),
                                      htt.array(vals, split=split), (9, 7))
        ref = ht_tpu.sparse.csr_from_coo(*(ht_tpu.array(a, split=split, comm=_one())
                                           for a in (rows, cols, vals)), (9, 7))
    _hold_shard(got, ref)
    want = np.zeros((9, 7), np.float32)
    want[rows, cols] = vals
    np.testing.assert_array_equal(got.to_dense().numpy(), want)


def test_csr_from_coo_errors():
    rows, cols, vals = _coo()
    for ht in (htt, ht_tpu):
        dup_r, dup_c = np.append(rows, rows[0]), np.append(cols, cols[0])
        with pytest.raises(ValueError, match="duplicate"):
            ht.sparse.csr_from_coo(dup_r, dup_c, np.append(vals, 1.0), (9, 7))
        with pytest.raises(ValueError, match="duplicate"):
            ht.sparse.csr_from_coo(ht.array(dup_r, split=0), ht.array(dup_c, split=0),
                                   ht.array(np.append(vals, 1.0), split=0), (9, 7))
        with pytest.raises(ValueError, match="row indices"):
            ht.sparse.csr_from_coo(rows, cols, vals, (3, 7))
        with pytest.raises(ValueError, match="column indices"):
            ht.sparse.csr_from_coo(rows, cols, vals, (9, 2))
        with pytest.raises(TypeError):
            ht.sparse.csr_from_coo(ht.array(rows), cols, vals, (9, 7))
        with pytest.raises(ValueError, match="matching"):
            ht.sparse.csr_from_coo(ht.array(rows), ht.array(cols[:3]), ht.array(vals), (9, 7))
    with pytest.raises(ValueError, match="row indices"):
        htt.sparse.csr_from_coo(htt.array(rows), htt.array(cols), htt.array(vals), (3, 7))
    empty = htt.sparse.csr_from_coo(np.zeros(0, int), np.zeros(0, int), np.zeros(0), (3, 3))
    assert empty.nnz == 0 and empty.capacity == 1 and empty.counts.tolist() == [0]


# ---------------------------------------------------------------- products


def _pair(dense, x, xsplit, comm=None):
    """(port A, port x, JAX A, JAX x)."""
    A = htt.sparse.csr_from_dense(dense)
    kw = {} if comm is None else {"comm": comm}
    return (A, htt.array(x, split=xsplit), ht_tpu.sparse.csr_from_dense(dense, **kw),
            ht_tpu.array(x, split=xsplit, **kw))


def _hold_values(got, ref, exact):
    assert got.dtype.__name__ == ref.dtype.__name__ and got.split == ref.split
    assert got.shape == tuple(ref.shape)
    want = np.asarray(ref.numpy())
    if exact:
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        scale = max(1.0, float(np.abs(want[np.isfinite(want)]).max(initial=0.0)))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6 * scale)


@pytest.mark.parametrize("xsplit", [None, 0])
@pytest.mark.parametrize("out_split", [None, 0])
@pytest.mark.parametrize("reduce", ["sum", "min", "max"])
def test_spmv_matches_reference(reduce, out_split, xsplit):
    dense = _matrix((11, 8), 0.35, seed=6)
    x = np.random.default_rng(7).standard_normal(8).astype(np.float32)
    A, hx, R, rx = _pair(dense, x, xsplit)
    got = htt.sparse.spmv(A, hx, reduce=reduce, out_split=out_split)
    _, _, R1, rx1 = _pair(dense, x, xsplit, _one())
    one = ht_tpu.sparse.spmv(R1, rx1, reduce=reduce, out_split=out_split)
    _hold_values(got, one, exact=reduce != "sum")  # the one-device reference, bits of min/max
    mesh = ht_tpu.sparse.spmv(R, rx, reduce=reduce, out_split=out_split)
    live = dense.any(axis=1)  # empty rows: the replicated identity differs with the world size
    want = np.asarray(mesh.numpy())
    np.testing.assert_allclose(got.numpy()[live], want[live], rtol=0,
                               atol=0 if reduce != "sum" else 1e-6 * np.abs(want).max())
    assert got.split == mesh.split and got.dtype.__name__ == mesh.dtype.__name__


@pytest.mark.parametrize("xdtype", [np.int64, np.int32, np.float64, np.uint8])
@pytest.mark.parametrize("reduce", ["sum", "min", "max"])
def test_spmv_types_and_pattern(reduce, xdtype):
    dense = _matrix((10, 10), 0.3, seed=8, dtype=np.int32)
    x = (np.arange(10) * 3 % 7).astype(xdtype)
    for pattern in (False, True):
        A, hx, R, rx = _pair(dense, x, 0, _one())
        got = htt.sparse.spmv(A, hx, reduce=reduce, pattern=pattern, out_split=None)
        ref = ht_tpu.sparse.spmv(R, rx, reduce=reduce, pattern=pattern, out_split=None)
        _hold_values(got, ref, exact=True)
        _, _, Rm, rxm = _pair(dense, x, 0)  # the 8-device mesh: integer results bit for bit
        mesh = ht_tpu.sparse.spmv(Rm, rxm, reduce=reduce, pattern=pattern, out_split=0)
        np.testing.assert_array_equal(htt.sparse.spmv(A, hx, reduce=reduce, pattern=pattern)
                                      .numpy(), np.asarray(mesh.numpy()))


def test_spmv_pattern_int64_labels():
    """The components' relay: min over int64 labels of the neighbours."""
    dense = _matrix((12, 12), 0.2, seed=9)
    labels = np.arange(12, dtype=np.int64)[::-1].copy()
    A, hx, R, rx = _pair(dense, labels, None)
    for out_split in (None, 0):
        got = htt.sparse.spmv(A, hx, reduce="min", pattern=True, out_split=out_split)
        ref = ht_tpu.sparse.spmv(R, rx, reduce="min", pattern=True, out_split=out_split)
        _hold_values(got, ref, exact=True)
        want = np.array([labels[dense[i] != 0].min(initial=np.iinfo(np.int64).max)
                         for i in range(12)])
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("xsplit", [None, 0])
@pytest.mark.parametrize("out_split", [None, 0])
def test_spmm_matches_reference(out_split, xsplit):
    dense = _matrix((9, 6), 0.4, seed=10)
    X = np.random.default_rng(11).standard_normal((6, 4)).astype(np.float32)
    A, hX, R, rX = _pair(dense, X, xsplit)
    got = htt.sparse.spmm(A, hX, out_split=out_split)
    _hold_values(got, ht_tpu.sparse.spmm(R, rX, out_split=out_split), exact=False)
    np.testing.assert_allclose(got.numpy(), dense.astype(np.float64) @ X, rtol=0, atol=1e-5)
    np.testing.assert_allclose((A @ hX).numpy(), got.numpy())
    Xi = np.arange(24, dtype=np.int64).reshape(6, 4)
    Ai = htt.sparse.csr_from_dense(np.round(dense * 3).astype(np.int64))
    np.testing.assert_array_equal(htt.sparse.spmm(Ai, htt.array(Xi)).numpy(),
                                  np.round(dense * 3).astype(np.int64) @ Xi)


def test_matmul_matvec_and_solver_hook():
    dense = _matrix((8, 8), 0.4, seed=12)
    x = np.random.default_rng(13).standard_normal(8).astype(np.float32)
    A = htt.sparse.csr_from_dense(dense)
    want = dense.astype(np.float64) @ x
    np.testing.assert_allclose((A @ htt.array(x)).numpy(), want, atol=1e-6)
    np.testing.assert_allclose(A.matvec(htt.array(x), out_split=None).numpy(), want, atol=1e-6)
    mv = A._matvec_spec(htt.float64)
    np.testing.assert_allclose(mv(torch.from_numpy(x).double()).numpy(), want, atol=1e-12)
    assert A.__matmul__(np.ones(8)) is NotImplemented


def test_product_errors_match_reference():
    dense = _matrix((4, 3), 0.5, seed=14)
    for ht in (htt, ht_tpu):
        A = ht.sparse.csr_from_dense(dense)
        for call, err in ((lambda: ht.sparse.spmv(dense, ht.ones(3)), TypeError),
                          (lambda: ht.sparse.spmv(A, np.ones(3)), TypeError),
                          (lambda: ht.sparse.spmv(A, ht.ones((3, 2))), ValueError),
                          (lambda: ht.sparse.spmv(A, ht.ones(4)), ValueError),
                          (lambda: ht.sparse.spmm(A, ht.ones((3, 2), split=1)), NotImplementedError),
                          (lambda: ht.sparse.spmv(A, ht.ones(3), out_split=1), NotImplementedError),
                          (lambda: ht.sparse.spmv(A, ht.ones(3), reduce="prod"), ValueError),
                          (lambda: ht.sparse.spmv(A, ht.ones(3), precision="fp8"), ValueError),
                          (lambda: ht.sparse.to_dense(dense), TypeError),
                          (lambda: ht.sparse.transpose(dense), TypeError)):
            with pytest.raises(err):
                call()


def test_wire_and_audit_raise_naming_their_items(monkeypatch):
    A = htt.sparse.csr_from_dense(_matrix((4, 4), 0.5, seed=15))
    x = htt.ones(4)
    assert htt.sparse.spmv_wire(htt.float32) == ht_tpu.sparse.spmv_wire(np.float32) == "off"
    assert htt.sparse.spmv_wire(htt.int64, "bf16") == ht_tpu.sparse.spmv_wire(np.int64, "bf16")
    assert htt.sparse.spmv_wire(htt.float32, "BF16") == "bf16"
    # the bf16 wire runs now (item 12); a world of one moves nothing, so it
    # is the exact product (the world of four holds the wire,
    # tests/test_torch_collective_prec.py)
    exact = htt.sparse.spmv(A, x, out_split=None).larray
    assert torch.equal(htt.sparse.spmv(A, x, precision="bf16").larray,
                       htt.sparse.spmv(A, x).larray)
    monkeypatch.setenv("HEAT_TPU_SPARSE_SPMV_PREC", "bf16")
    assert torch.equal(htt.sparse.spmv(A, x, out_split=None).larray, exact)
    assert torch.equal(A._matvec_spec(htt.float32)(x.larray), exact)
    # exact relays never reach the compressed wire
    labels = htt.array(np.arange(4))
    assert htt.sparse.spmv(A, labels, reduce="min", pattern=True).dtype is htt.int64
    assert htt.sparse.spmv(A, x, reduce="max").shape == (4,)
    monkeypatch.delenv("HEAT_TPU_SPARSE_SPMV_PREC")
    # the audits run now (they raised until the telemetry port) and change
    # no result
    assert torch.equal(htt.sparse.spmv(A, x, audit=True).larray, htt.sparse.spmv(A, x).larray)
    assert torch.equal(htt.sparse.spmm(A, htt.ones((4, 2)), audit=True).larray,
                       htt.sparse.spmm(A, htt.ones((4, 2))).larray)
    assert torch.equal(htt.sparse.transpose(A, audit=True).values,
                       htt.sparse.transpose(A).values)
    assert set(htt.sparse.EVENT_COUNTER) == set(ht_tpu.sparse.EVENT_COUNTER)


# ---------------------------------------------------------------- transpose


@pytest.mark.parametrize("name", ["7x5", "13x13", "1x4", "5x7_int64", "4x4_zero"])
@pytest.mark.parametrize("slab", [None, 1, 3])
def test_transpose_matches_reference(name, slab):
    shape, dtype, density = DENSE_CASES[name]
    dense = _matrix(shape, density, seed=16, dtype=dtype)
    got = htt.sparse.transpose(htt.sparse.csr_from_dense(dense), slab=slab)
    ref = ht_tpu.sparse.transpose(ht_tpu.sparse.csr_from_dense(dense, comm=_one()), slab=slab)
    _hold_shard(got, ref)
    np.testing.assert_array_equal(got.to_dense().numpy(), dense.T)
    one_stage = htt.sparse.csr_from_dense(dense).T  # a staged transpose: the same bits
    assert got.counts.tolist() == one_stage.counts.tolist()
    for name in ("indptr", "indices", "values"):
        assert torch.equal(getattr(got, name), getattr(one_stage, name)), name
    back = got.transpose()
    assert back.shape == shape and back.counts.tolist() == [int((dense != 0).sum())]
    np.testing.assert_array_equal(back.to_dense().numpy(), dense)


# ---------------------------------------------------------------- value maps


def test_value_maps_and_metadata_match_reference():
    dense = _matrix((6, 5), 0.5, seed=17)
    dense_i = _matrix((6, 5), 0.5, seed=17, dtype=np.int32)
    got, ref = htt.sparse.csr_from_dense(dense), ht_tpu.sparse.csr_from_dense(dense, comm=_one())
    got_i = htt.sparse.csr_from_dense(dense_i)
    ref_i = ht_tpu.sparse.csr_from_dense(dense_i, comm=_one())
    for g, r in ((got * 2.5, ref * 2.5), (2 * got, 2 * ref), (got / 4, ref / 4), (-got, -ref),
                 (abs(got), abs(ref)), (got.astype(htt.float64), ref.astype(ht_tpu.float64)),
                 (got_i * 2.5, ref_i * 2.5), (got_i * 3, ref_i * 3), (got_i / 2, ref_i / 2),
                 (abs(-got_i), abs(-ref_i))):
        _hold_shard(g, r)
    assert got.__mul__("a") is NotImplemented and got.__truediv__(None) is NotImplemented
    assert (got.nnz, got.density, got.row_chunk, got.lrows, got.lnnz) == \
        (ref.nnz, ref.density, ref.row_chunk, 6, ref.nnz)
    np.testing.assert_array_equal(got.owner.numpy(), np.asarray(ref.owner.numpy()))
    assert repr(got) == repr(ref)
    assert got.device == htt.cpu and got.comm is htt.get_comm()


def test_host_shards_construct_the_reference_layout():
    """``_from_host_csr_shards`` (host (p, r + 1) and (p, cap) blocks, this
    rank's row taken) and ``from_shard_arrays`` give the JAX package's
    container from the same blocks."""
    dense = _matrix((6, 5), 0.5, seed=18)
    ref = ht_tpu.sparse.csr_from_dense(dense, comm=_one())
    blocks = [np.asarray(a).reshape(1, -1) for a in (ref.indptr, ref.indices, ref.values)]
    got = htt.sparse.SparseDNDarray._from_host_csr_shards(*blocks, ref.shape, ref.counts)
    _hold_shard(got, ref)
    _hold_shard(got, ht_tpu.sparse.SparseDNDarray._from_host_csr_shards(
        *blocks, ref.shape, ref.counts, comm=_one()))
    again = htt.sparse.SparseDNDarray.from_shard_arrays(got.indptr, got.indices, got.values,
                                                        got.shape, got.counts, dtype=htt.float32)
    _hold_shard(again, ref)
    np.testing.assert_array_equal(again.to_dense().numpy(), dense)
