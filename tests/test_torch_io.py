"""``heat_tpu_torch.core.io`` against heat_tpu's ``io`` on the same files.

Every file here is written by one package and read by both (and the
reverse), on the same seeded numpy data: npy, CSV through the native parser
and through numpy's, HDF5, NetCDF-3 (scipy), the ``chunks=(start, stop)``
row blocks of npy and HDF5, ``dataset_shape`` and ``load``/``save`` by
extension. Reads must be bit for bit equal to heat_tpu's in values, type,
shape and split (the files hold exact values: float32/float64 data, and
the CSV writer's ``%.17g`` round-trips a double). One spawned world of three
gloo ranks reads (each rank its own slab: 7 rows as 3, 3, 1) and writes
(slab by slab in rank order) split files; its files and arrays must equal a
world of one's, and a write that fails on one rank must raise on all.
"""

import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

import heat_tpu as ht_tpu

import heat_tpu_torch as htt
from heat_tpu_torch import native
from heat_tpu_torch.core import io

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def on_cpu():
    htt.use_device("cpu")
    yield
    htt.use_device(None)


def _data(shape=(37, 5), dtype=np.float32, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _same(got, want):
    """A port DNDarray equal to heat_tpu's: values, type, shape, split."""
    assert got.shape == tuple(want.shape)
    assert got.split == want.split
    assert got.dtype.__name__ == want.dtype.__name__
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32, np.int64])
@pytest.mark.parametrize("split", [None, 0, 1])
def test_npy_roundtrip_both_ways(tmp_path, dtype, split):
    a = _data(dtype=np.float64, seed=1) * 100
    a = a.astype(dtype)
    mine, theirs = str(tmp_path / "port.npy"), str(tmp_path / "jax.npy")
    io.save_npy(htt.array(a, split=split), mine)
    ht_tpu.save_npy(ht_tpu.array(a, split=split), theirs)
    np.testing.assert_array_equal(np.load(mine), np.load(theirs))
    for path in (mine, theirs):
        _same(htt.load_npy(path, split=split), ht_tpu.load_npy(path, split=split))
        _same(htt.load(path, split=split), ht_tpu.load(path, split=split))


@pytest.mark.parametrize("chunks", [(0, 37), (5, 19), (36, 37)])
@pytest.mark.parametrize("split", [None, 0, 1])
def test_npy_chunks_equal_jax(tmp_path, chunks, split):
    path = str(tmp_path / "x.npy")
    np.save(path, _data())
    _same(htt.load_npy(path, split=split, chunks=chunks),
          ht_tpu.load_npy(path, split=split, chunks=chunks))


@pytest.mark.parametrize("chunks,err", [((5, 5), ValueError), ((-1, 3), ValueError),
                                        ((30, 38), ValueError), ((1,), TypeError),
                                        ("ab", TypeError)])
def test_bad_chunks_raise_as_jax(tmp_path, chunks, err):
    path = str(tmp_path / "x.npy")
    np.save(path, _data())
    with pytest.raises(err):
        ht_tpu.load_npy(path, chunks=chunks)
    with pytest.raises(err):
        htt.load_npy(path, chunks=chunks)


def test_npy_unreadable_and_object_files(tmp_path):
    bad = tmp_path / "bad.npy"
    bad.write_bytes(b"not an array")
    with pytest.raises(ValueError, match="not a readable"):
        htt.load_npy(str(bad))
    obj = str(tmp_path / "obj.npy")
    np.save(obj, np.array([1, "a"], dtype=object), allow_pickle=True)
    with pytest.raises(ValueError):
        htt.load_npy(obj)


@pytest.mark.parametrize("parser", ["native", "numpy"])
@pytest.mark.parametrize("sep,header", [(",", None), (";", "a header\nof two lines")])
@pytest.mark.parametrize("split", [None, 0])
def test_csv_roundtrip_both_ways(tmp_path, monkeypatch, parser, sep, header, split):
    if parser == "numpy":  # no compiler: both sides take numpy's parser and writer
        monkeypatch.setattr(native, "parse_csv", lambda *a, **k: None)
        monkeypatch.setattr(native, "write_csv", lambda *a, **k: False)
        monkeypatch.setattr(ht_tpu.native, "parse_csv", lambda *a, **k: None)
        monkeypatch.setattr(ht_tpu.native, "write_csv", lambda *a, **k: False)
    else:
        assert native.native_available()
    a = _data(dtype=np.float32, seed=2)
    lines = 0 if header is None else len(header.splitlines())
    mine, theirs = str(tmp_path / "port.csv"), str(tmp_path / "jax.csv")
    before = native.native_calls()
    htt.save_csv(htt.array(a, split=split), mine, header_lines=header, sep=sep)
    ht_tpu.save_csv(ht_tpu.array(a, split=split), theirs, header_lines=header, sep=sep)
    assert Path(mine).read_text() == Path(theirs).read_text()
    got = htt.load_csv(mine, header_lines=lines, sep=sep, split=split)
    want = ht_tpu.load_csv(theirs, header_lines=lines, sep=sep, split=split)
    _same(got, want)
    np.testing.assert_array_equal(got.numpy(), a)
    used = {k: native.native_calls()[k] - before[k] for k in before}
    assert used == ({"parse": 1, "write": 1} if parser == "native" else {"parse": 0, "write": 0})


def test_csv_types_and_odd_shapes(tmp_path):
    one_col = tmp_path / "col.csv"
    one_col.write_text("1.5\n2.5\n-3\n")
    _same(htt.load_csv(str(one_col), dtype=htt.float64), ht_tpu.load_csv(str(one_col),
                                                                          dtype=ht_tpu.float64))
    one_row = tmp_path / "row.csv"
    one_row.write_text("# h\n1,2,3\n")
    _same(htt.load_csv(str(one_row), header_lines=1), ht_tpu.load_csv(str(one_row),
                                                                      header_lines=1))
    latin = tmp_path / "latin.csv"
    latin.write_text("4,5\n6,7\n", encoding="latin-1")
    _same(htt.load_csv(str(latin), encoding="latin-1"),
          ht_tpu.load_csv(str(latin), encoding="latin-1"))
    with pytest.raises(TypeError):
        htt.load_csv(3)


@pytest.mark.parametrize("split", [None, 0, 1])
def test_hdf5_roundtrip_chunks_and_shape(tmp_path, split):
    assert io.supports_hdf5() == ht_tpu.supports_hdf5() is True
    a = _data(seed=3)
    mine, theirs = str(tmp_path / "port.h5"), str(tmp_path / "jax.h5")
    htt.save_hdf5(htt.array(a, split=split), mine, "data")
    ht_tpu.save_hdf5(ht_tpu.array(a, split=split), theirs, "data")
    for path in (mine, theirs):
        _same(htt.load_hdf5(path, "data", split=split), ht_tpu.load_hdf5(path, "data",
                                                                         split=split))
        _same(htt.load_hdf5(path, "data", split=split, chunks=(3, 30)),
              ht_tpu.load_hdf5(path, "data", split=split, chunks=(3, 30)))
        assert htt.dataset_shape(path, "data") == ht_tpu.dataset_shape(path, "data") == (37, 5)
    htt.save(htt.array(a), str(tmp_path / "more.h5"), "first")
    htt.save_hdf5(htt.array(a * 2), str(tmp_path / "more.h5"), "second", mode="a")
    np.testing.assert_array_equal(htt.load(str(tmp_path / "more.h5"), "second").numpy(), a * 2)
    with pytest.raises(ValueError, match="dataset="):
        htt.dataset_shape(mine)


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32])
def test_netcdf3_roundtrip(tmp_path, dtype):
    assert io.supports_netcdf() == ht_tpu.supports_netcdf() is True
    a = (_data(seed=4) * 10).astype(dtype)
    mine, theirs = str(tmp_path / "port.nc"), str(tmp_path / "jax.nc")
    htt.save_netcdf(htt.array(a, split=0), mine, "v")
    ht_tpu.save_netcdf(ht_tpu.array(a, split=0), theirs, "v")
    for path in (mine, theirs):
        for split in (None, 0, 1):
            _same(htt.load_netcdf(path, "v", dtype=htt.float64, split=split),
                  ht_tpu.load_netcdf(path, "v", dtype=ht_tpu.float64, split=split))
        _same(htt.load(path, "v"), ht_tpu.load(path, "v"))


def test_dataset_shape_and_extension_dispatch(tmp_path):
    path = str(tmp_path / "x.npy")
    np.save(path, _data((4, 3, 2)))
    assert htt.dataset_shape(path) == ht_tpu.dataset_shape(path) == (4, 3, 2)
    with pytest.raises(ValueError, match="Unsupported"):
        htt.load(str(tmp_path / "x.txt"))
    with pytest.raises(ValueError, match="Unsupported"):
        htt.save(htt.array(_data()), str(tmp_path / "x.txt"))
    with pytest.raises(TypeError):
        htt.save(np.zeros(3), path)
    assert sorted(n for n in io.__all__) == sorted(
        n for n in ht_tpu.core.io.__all__ if n not in (
            "save_checkpoint", "load_checkpoint", "supports_checkpoint"))


def test_failed_write_keeps_the_previous_file(tmp_path):
    path = tmp_path / "x.npy"
    htt.save_npy(htt.array(np.arange(4.0)), str(path))
    with pytest.raises(Exception):
        htt.save_csv(htt.array(np.ones((2, 2))), str(tmp_path / "missing" / "x.csv"))
    np.testing.assert_array_equal(np.load(path), np.arange(4.0))
    assert sorted(os.listdir(tmp_path)) == ["x.npy"]


# -- three gloo ranks ------------------------------------------------------------

_WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch.distributed as dist
    rank, world, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    import heat_tpu_torch as ht
    ht.use_device("cpu")
    res = {}
    src = f"{out}/src"
    for split in (None, 0, 1):
        for name, x in (("npy", ht.load_npy(f"{src}/x.npy", split=split)),
                        ("npy_chunk", ht.load_npy(f"{src}/x.npy", split=split, chunks=(2, 9))),
                        ("csv", ht.load_csv(f"{src}/x.csv", split=split)),
                        ("h5", ht.load_hdf5(f"{src}/x.h5", "d", split=split)),
                        ("h5_chunk", ht.load_hdf5(f"{src}/x.h5", "d", split=split,
                                                  chunks=(1, 8))),
                        ("nc", ht.load_netcdf(f"{src}/x.nc", "v", split=split))):
            key = f"{name}_{split}"
            res[key + "_local"] = x.larray.numpy()
            res[key + "_global"] = x.numpy()
        y = ht.load_npy(f"{src}/x.npy", split=split)
        ht.save_npy(y, f"{out}/w{world}_{split}.npy")
        ht.save_hdf5(y, f"{out}/w{world}_{split}.h5", "d")
        ht.save_netcdf(y, f"{out}/w{world}_{split}.nc", "v")
        if split != 1:
            ht.save_csv(y, f"{out}/w{world}_{split}.csv", header_lines="h")
    try:  # a write that fails on one rank raises on every rank
        ht.save_npy(ht.load_npy(f"{src}/x.npy", split=0),
                    f"{out}/nowhere/x.npy" if rank == world - 1 else f"{out}/partial.npy")
        res["failed"] = np.array(0)
    except Exception:
        res["failed"] = np.array(1)
    np.savez(f"{out}/rank{rank}.npz", **res)
    dist.barrier()
    dist.destroy_process_group()
""")


def _spawn(tmp_path, world):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(r), str(world), str(port),
                               str(tmp_path)], cwd=REPO, env=dict(os.environ),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=300)[0])
        finally:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    return [np.load(tmp_path / f"rank{r}.npz") for r in range(world)]


def test_three_ranks_read_and_write_as_a_world_of_one(tmp_path):
    a = _data((11, 7), seed=6)  # 11 rows as 4, 4, 3; 7 columns as 3, 3, 1
    src = tmp_path / "src"
    src.mkdir()
    x = htt.array(a)
    htt.save_npy(x, str(src / "x.npy"))
    htt.save_csv(x, str(src / "x.csv"))
    htt.save_hdf5(x, str(src / "x.h5"), "d")
    htt.save_netcdf(x, str(src / "x.nc"), "v")
    ranks = _spawn(tmp_path, 3)
    blocks = {"npy": a, "npy_chunk": a[2:9], "csv": a, "h5": a, "h5_chunk": a[1:8], "nc": a}
    for r, res in enumerate(ranks):
        for name, want in blocks.items():
            for split in (None, 0, 1):
                key = f"{name}_{split}"
                np.testing.assert_array_equal(res[key + "_global"], want)
                sl = htt.core.communication.chunk(want.shape, split, r, 3)[2]
                np.testing.assert_array_equal(res[key + "_local"], want[sl])
        assert int(res["failed"]) == 1
    # the files the three ranks wrote equal a world of one's
    for split in (None, 0, 1):
        y = htt.load_npy(str(src / "x.npy"), split=split)
        htt.save_npy(y, str(tmp_path / f"w1_{split}.npy"))
        np.testing.assert_array_equal(np.load(tmp_path / f"w3_{split}.npy"),
                                      np.load(tmp_path / f"w1_{split}.npy"))
        for ext, reader in ((".h5", lambda p: ht_tpu.load_hdf5(p, "d")),
                            (".nc", lambda p: ht_tpu.load_netcdf(p, "v"))):
            np.testing.assert_array_equal(reader(str(tmp_path / f"w3_{split}{ext}")).numpy(), a)
        if split != 1:
            htt.save_csv(y, str(tmp_path / f"w1_{split}.csv"), header_lines="h")
            assert (tmp_path / f"w3_{split}.csv").read_text() == \
                (tmp_path / f"w1_{split}.csv").read_text()
