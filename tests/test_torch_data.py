"""``heat_tpu_torch.utils.data`` against ``heat_tpu.utils.data``.

One numpy input, made from a seed, goes through both packages. Exact
throughout:

* the shuffled order of a ``Dataset`` over three epochs, blocking and
  ``ishuffle``: the JAX package's ``jax.random.key(0)``, ``split`` and
  ``permutation`` reproduced by the port's threefry, bit for bit;
* the ``DataLoader``'s batch count, its tail rule and its batches, against
  the JAX package on a mesh of the port's world size, at batch sizes that
  are multiples of 8; on gloo worlds of 2 and 4 ranks (one spawned world
  each, at once: a module fixture) the concatenation over the ranks of
  each batch is the JAX package's global batch;
* ``PartialDataLoaderIter``'s batches over an HDF5 file the test writes;
* ``matrixgallery.parter``;
* the TFRecord tooling on records the test writes;
* ``MNISTDataset`` and ``vision_transforms`` on a stub ``torchvision`` the
  test puts into ``sys.modules``, over arrays the test writes.
"""

import os
import socket
import struct
import subprocess
import sys
import textwrap
import threading
import types as pytypes
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import heat_tpu as ht_tpu
from heat_tpu.core.communication import MeshCommunication

import heat_tpu_torch as htt
from heat_tpu_torch.utils.data import _utils as tutils
from heat_tpu_torch.utils.data import matrixgallery

REPO = Path(__file__).resolve().parent.parent
WORLDS = (2, 4)


@pytest.fixture(autouse=True)
def on_cpu():
    htt.use_device("cpu")
    yield
    htt.use_device(None)


def _mesh(p):
    return MeshCommunication(devices=jax.devices()[:p])


def _xy(n, seed=3):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, 3)).astype(np.float32), np.arange(n, dtype=np.int64) * 10


def _datasets(n, ishuffle=False, split=0, p=1):
    x, y = _xy(n)
    comm = _mesh(p)
    dj = ht_tpu.utils.data.Dataset(ht_tpu.array(x, split=split, comm=comm),
                                   targets=ht_tpu.array(y, split=split, comm=comm),
                                   ishuffle=ishuffle)
    dt = htt.utils.data.Dataset(htt.array(x, split=split), targets=htt.array(y, split=split),
                                ishuffle=ishuffle)
    return dj, dt


# ---------------------------------------------------------------- Dataset


def test_dataset_accessors():
    x, y = _xy(10)
    d = htt.utils.data.Dataset(htt.array(x, split=0), targets=htt.array(y, split=0))
    assert len(d) == 10
    xi, yi = d[3]
    assert np.array_equal(xi.numpy(), x[3]) and int(yi) == y[3]
    assert torch.equal(d.data, torch.from_numpy(x)) and d.comm is htt.get_comm()
    assert htt.utils.data.Dataset(htt.array(x))[2].shape == (3,)


def test_dataset_rejects_bad_types():
    with pytest.raises(TypeError):
        htt.utils.data.Dataset(np.zeros(3))
    with pytest.raises(ValueError):
        htt.utils.data.Dataset(htt.array(np.zeros((3, 2)), split=1))
    with pytest.raises(TypeError):
        htt.utils.data.Dataset(htt.array(np.zeros(3)), targets=np.zeros(3))
    with pytest.raises(TypeError):
        htt.utils.data.DataLoader([1, 2, 3])
    with pytest.raises(ValueError):
        htt.utils.data.DataLoader(htt.array(np.zeros(3)), batch_size=0)


@pytest.mark.parametrize("split", [0, None])
@pytest.mark.parametrize("n", [50, 97])
def test_shuffle_is_the_reference_over_three_epochs(n, split):
    dj, dt = _datasets(n, split=split)
    for _ in range(3):
        dj.Shuffle()
        dt.Shuffle()
        assert np.array_equal(np.asarray(dj.targets), dt.httargets.numpy())
        assert np.array_equal(np.asarray(dj.data), dt.htdata.numpy())


def test_ishuffle_applies_at_the_next_harvest():
    from heat_tpu.utils.data.datatools import _harvest_pending as jharvest
    from heat_tpu_torch.utils.data.datatools import _harvest_pending

    dj, dt = _datasets(40, ishuffle=True)
    before = dt.httargets.numpy().copy()
    dt.Ishuffle()
    dj.Ishuffle()
    assert np.array_equal(dt.httargets.numpy(), before)  # issued, not applied
    _harvest_pending(dt)
    jharvest(dj)
    assert np.array_equal(dt.httargets.numpy(), np.asarray(dj.targets))
    assert not np.array_equal(dt.httargets.numpy(), before)
    _harvest_pending(dt)  # nothing pending: no change
    assert np.array_equal(dt.httargets.numpy(), np.asarray(dj.targets))


def test_test_set_never_shuffles():
    x, y = _xy(20)
    d = htt.utils.data.Dataset(htt.array(x, split=0), targets=htt.array(y, split=0),
                               test_set=True)
    loader = htt.utils.data.DataLoader(d, batch_size=8)
    for _ in range(3):
        got = np.concatenate([b[1].numpy() for b in loader])
        assert np.array_equal(got, y)  # two batches of 8 and the tail of 4


# ---------------------------------------------------------------- DataLoader

LOADER_CASES = [(n, bs) for n in (48, 50, 61, 100, 137) for bs in (8, 16, 24, 40)]


@pytest.mark.parametrize("drop_last", [False, True])
@pytest.mark.parametrize("n,bs", LOADER_CASES)
def test_loader_count_and_tail_match_reference(n, bs, drop_last):
    dj, dt = _datasets(n)
    lj = ht_tpu.utils.data.DataLoader(dj, batch_size=bs, drop_last=drop_last)
    lt = htt.utils.data.DataLoader(dt, batch_size=bs, drop_last=drop_last)
    assert len(lt) == len(lj) and lt.batch_size == lj.batch_size
    bj, bt = list(lj), list(lt)
    assert len(bt) == len(lt)
    for (xj, yj), (xt, yt) in zip(bj, bt):
        assert np.array_equal(np.asarray(yj), yt.numpy())
        assert np.array_equal(np.asarray(xj), xt.numpy())
        assert xt.split == 0 and xt.shape == tuple(np.asarray(xj).shape)


@pytest.mark.parametrize("p", [2, 4, 8])
def test_loader_rule_of_a_larger_world_matches_reference(p):
    """The count and tail rule of a world of ``p`` ranks, checked on the
    JAX package's mesh of ``p`` devices (the port's world of ``p`` ranks
    runs in the gloo fixture below)."""
    for n, bs in LOADER_CASES:
        dj, _ = _datasets(n, p=p)
        lj = ht_tpu.utils.data.DataLoader(dj, batch_size=bs)
        full, rem = divmod(n, (bs // p) * p)
        assert len(lj) == full + (rem >= p)


@pytest.mark.parametrize("ishuffle", [False, True])
@pytest.mark.parametrize("n,bs", [(50, 16), (61, 8), (100, 24)])
def test_loader_epochs_match_reference(n, bs, ishuffle):
    dj, dt = _datasets(n, ishuffle=ishuffle)
    lj = ht_tpu.utils.data.DataLoader(dj, batch_size=bs, shuffle=True)
    lt = htt.utils.data.DataLoader(dt, batch_size=bs, shuffle=True)
    seen = []
    for epoch in range(3):
        got = [b[1].numpy() for b in lt]
        want = [np.asarray(b[1]) for b in lj]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert np.array_equal(g, w), epoch
        seen.append(np.concatenate(got))
    assert np.array_equal(seen[0], np.arange(len(seen[0])) * 10)  # the first epoch in order
    assert not np.array_equal(seen[1], seen[2])


def test_loader_collate_and_wrapping_a_dndarray():
    x, _ = _xy(32)
    loader = htt.utils.data.DataLoader(htt.array(x, split=0), batch_size=8, shuffle=False,
                                       collate_fn=lambda b: b.larray.sum())
    sums = [float(s) for s in loader]
    assert np.allclose(sums, x.reshape(4, 8, 3).sum(axis=(1, 2)))


def test_loader_feeds_a_data_parallel_step():
    """The batches are the form ``DataParallel.make_train_step``'s step
    takes; three blocking steps over one epoch change the weights."""
    torch.manual_seed(0)
    x, _ = _xy(48)
    y = (x @ np.array([1.0, -2.0, 0.5], np.float32))[:, None]
    model = torch.nn.Linear(3, 1)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    dp = htt.nn.DataParallel(model, optimizer=opt, blocking_parameter_updates=True)
    step = dp.make_train_step(lambda m, xb, yb: ((m(xb) - yb) ** 2).mean())
    w0 = model.weight.detach().clone()
    loader = htt.utils.data.DataLoader(htt.utils.data.Dataset(
        htt.array(x, split=0), targets=htt.array(y, split=0)), batch_size=16)
    losses = []
    for xb, yb in loader:
        _, _, loss = step(model, opt, *dp.shard_batch(xb, yb))
        losses.append(float(loss))
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert not torch.equal(model.weight, w0)


# --------------------------------------------------- gloo worlds of 2 and 4 ranks

_WORKER = textwrap.dedent("""
    import json
    import sys
    import numpy as np
    import torch.distributed as dist
    rank, world, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    import heat_tpu_torch as ht
    ht.use_device("cpu")
    res = {}
    for name, n, bs, split, ishuffle in (("a", 70, 16, 0, False), ("b", 61, 24, 0, True),
                                         ("c", 45, 8, None, False), ("d", 9, 8, 0, False)):
        rng = np.random.default_rng(3)
        x = rng.standard_normal((n, 3)).astype(np.float32)
        y = np.arange(n, dtype=np.int64) * 10
        d = ht.utils.data.Dataset(ht.array(x, split=split), targets=ht.array(y, split=split),
                                  ishuffle=ishuffle)
        loader = ht.utils.data.DataLoader(d, batch_size=bs)
        res[name + "_len"] = np.array(len(loader))
        for epoch in range(3):
            for i, (xb, yb) in enumerate(loader):
                assert xb.split == 0 and xb.lshape[0] == xb.shape[0] // world
                res[f"{name}_{epoch}_{i}_y"] = yb.larray.numpy()
                res[f"{name}_{epoch}_{i}_x"] = xb.larray.numpy()
                res[f"{name}_{epoch}_{i}_shape"] = np.array(xb.shape)
    np.savez(f"{out}/rank{rank}.npz", **res)
    dist.destroy_process_group()
""")
CASES_RANKS = {"a": (70, 16, 0, False), "b": (61, 24, 0, True), "c": (45, 8, None, False),
               "d": (9, 8, 0, False)}


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def gloo_worlds(tmp_path_factory):
    """Worlds of 2 and 4 gloo ranks, spawned at once; each rank's batches."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    outs, procs = {}, []
    for world in WORLDS:
        out = tmp_path_factory.mktemp(f"data_gloo{world}")
        port = _free_port()
        outs[world] = out
        procs += [subprocess.Popen([sys.executable, "-c", _WORKER, str(r), str(world), str(port),
                                    str(out)], cwd=REPO, env=env, stdout=subprocess.PIPE,
                                   stderr=subprocess.STDOUT, text=True)
                  for r in range(world)]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=300)[0])
        finally:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    return {w: [dict(np.load(outs[w] / f"rank{r}.npz")) for r in range(w)] for w in WORLDS}


@pytest.mark.parametrize("case", sorted(CASES_RANKS))
@pytest.mark.parametrize("world", WORLDS)
def test_gloo_batches_concatenate_to_the_reference_batches(gloo_worlds, world, case):
    n, bs, split, ishuffle = CASES_RANKS[case]
    ranks = gloo_worlds[world]
    x, y = _xy(n)
    comm = _mesh(world)
    dj = ht_tpu.utils.data.Dataset(ht_tpu.array(x, split=split, comm=comm),
                                   targets=ht_tpu.array(y, split=split, comm=comm),
                                   ishuffle=ishuffle)
    lj = ht_tpu.utils.data.DataLoader(dj, batch_size=bs)
    assert all(int(r[case + "_len"]) == len(lj) for r in ranks)
    for epoch in range(3):
        for i, (xj, yj) in enumerate(lj):
            got_y = np.concatenate([r[f"{case}_{epoch}_{i}_y"] for r in ranks])
            got_x = np.concatenate([r[f"{case}_{epoch}_{i}_x"] for r in ranks])
            assert np.array_equal(got_y, np.asarray(yj)), (epoch, i)
            assert np.array_equal(got_x, np.asarray(xj)), (epoch, i)
            assert tuple(ranks[0][f"{case}_{epoch}_{i}_shape"]) == np.asarray(xj).shape
        assert f"{case}_{epoch}_{len(lj)}_y" not in ranks[0]


# ------------------------------------------------------------- partial datasets


def _h5(tmp_path, n=300):
    h5py = pytest.importorskip("h5py")
    rng = np.random.default_rng(5)
    data = rng.standard_normal((n, 4)).astype(np.float32)
    labels = np.arange(n, dtype=np.int64)
    path = str(tmp_path / "data.h5")
    with h5py.File(path, "w") as f:
        f["data"] = data
        f["labels"] = labels
    return path, data, labels


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("bs,init,load", [(16, 100, 50), (32, 64, 64), (8, 300, 7)])
def test_partial_h5_batches_match_reference(tmp_path, bs, init, load, shuffle):
    path, data, labels = _h5(tmp_path)
    dj = ht_tpu.utils.data.PartialH5Dataset(path, comm=_mesh(1), dataset_names=["data", "labels"],
                                            initial_load=init, load_length=load)
    dt = htt.utils.data.PartialH5Dataset(path, dataset_names=["data", "labels"],
                                         initial_load=init, load_length=load)
    try:
        got = list(htt.utils.data.PartialDataLoaderIter(dt, bs, shuffle=shuffle, seed=4))
        want = list(ht_tpu.utils.data.PartialDataLoaderIter(dj, bs, shuffle=shuffle, seed=4))
        assert len(got) == len(want) and got
        for (gx, gy), (wx, wy) in zip(got, want):
            assert np.array_equal(gx.numpy(), np.asarray(wx))
            assert np.array_equal(gy.numpy(), np.asarray(wy))
            assert gx.split == 0 and gx.shape == (bs, 4)
        seen = np.concatenate([b[1].numpy() for b in got])
        assert len(np.unique(seen)) == len(seen) and (300 - len(seen)) < bs  # last tail dropped
        assert dt.stats["windows"] >= 1 and dt.stats["rows"] == 300
    finally:
        dt.close()
        dj.close()


def test_partial_dataset_over_arrays_and_memmaps(tmp_path):
    x = np.arange(200, dtype=np.float32).reshape(100, 2)
    np.save(tmp_path / "x.npy", x)
    mm = np.load(tmp_path / "x.npy", mmap_mode="r")
    for col in (x, mm):
        d = htt.utils.data.PartialDataset({"x": col}, initial_load=30, load_length=20)
        assert np.array_equal(np.concatenate([w["x"] for w in d.windows()]), x)
        assert len(d) == 100
        (b,) = list(htt.utils.data.PartialDataLoaderIter(d, 64, shuffle=False))
        assert np.array_equal(b[0].numpy(), x[:64])


def test_partial_early_exit_reaps_the_loader_thread():
    x = np.zeros((10_000, 2), np.float32)
    d = htt.utils.data.PartialDataset({"x": x}, initial_load=10, load_length=10)
    before = {t.name for t in threading.enumerate()}
    it = iter(htt.utils.data.PartialDataLoaderIter(d, 5, shuffle=False))
    next(it)
    it.close()
    assert "heat_tpu_torch.partial_dataset" not in {t.name for t in threading.enumerate()} - before


def test_partial_transform_error_reaches_the_consumer():
    def bad(win):
        raise RuntimeError("boom")

    d = htt.utils.data.PartialDataset({"x": np.zeros((20, 2))}, transform=bad)
    with pytest.raises(RuntimeError, match="boom"):
        list(d.windows())


def test_partial_validation():
    with pytest.raises(ValueError):
        htt.utils.data.PartialDataset({})
    with pytest.raises(ValueError):
        htt.utils.data.PartialDataset({"a": np.zeros(3), "b": np.zeros(4)})
    assert htt.utils.data.PartialH5DataLoaderIter is htt.utils.data.PartialDataLoaderIter


# ---------------------------------------------------------------- the gallery


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("n", [1, 7, 16])
def test_parter_matches_reference(n, split, dtype):
    got = matrixgallery.parter(n, split=split, dtype=getattr(htt, dtype))
    want = ht_tpu.utils.data.matrixgallery.parter(n, split=split,
                                                  dtype=getattr(ht_tpu, dtype))
    assert got.split == want.split and got.dtype.__name__ == want.dtype.__name__
    assert np.array_equal(got.numpy(), np.asarray(want.numpy()))


def test_parter_bad_split():
    with pytest.raises(ValueError):
        matrixgallery.parter(4, split=2)


def test_parter_singular_values_cluster_at_pi():
    s = np.linalg.svd(matrixgallery.parter(256, dtype=htt.float64).numpy(), compute_uv=False)
    assert np.abs(s[:200] - np.pi).max() < 1e-3


# ------------------------------------------------------------ offline tooling


def _varint(n):
    out = b""
    while True:
        b = n & 0x7F
        n >>= 7
        out += bytes([b | (0x80 if n else 0)])
        if not n:
            return out


def _ld(field, payload):
    return _varint((field << 3) | 2) + _varint(len(payload)) + payload


def _example(features):
    entries = b""
    for k, feat in features.items():
        entries += _ld(1, _ld(1, k.encode()) + _ld(2, feat))
    return _ld(1, entries)


def _frames(path, payloads):
    with open(path, "wb") as f:
        for p in payloads:
            f.write(struct.pack("<Q", len(p)) + b"\0" * 4 + p + b"\0" * 4)


def test_dali_index_matches_reference(tmp_path):
    from heat_tpu.utils.data._utils import dali_tfrecord2idx

    for d in ("train", "val"):
        (tmp_path / d).mkdir()
    _frames(tmp_path / "train" / "part-0", [b"x" * 10, b"y" * 25, b"z" * 3])
    _frames(tmp_path / "val" / "part-0", [b"v" * 7])
    tutils.dali_tfrecord2idx(str(tmp_path / "train"), str(tmp_path / "ti"),
                             str(tmp_path / "val"), str(tmp_path / "vi"))
    dali_tfrecord2idx(str(tmp_path / "train"), str(tmp_path / "tj"), str(tmp_path / "val"),
                      str(tmp_path / "vj"))
    for a, b in (("ti", "tj"), ("vi", "vj")):
        assert (tmp_path / a / "part-0.idx").read_text() == (tmp_path / b / "part-0.idx").read_text()
    assert (tmp_path / "ti" / "part-0.idx").read_text().splitlines()[1] == "26 41"


def test_truncated_tfrecord_raises(tmp_path):
    path = tmp_path / "bad"
    path.write_bytes(struct.pack("<Q", 100) + b"\0" * 10)
    with pytest.raises(ValueError, match="truncated"):
        list(tutils._iter_tfrecord(str(path)))


def test_parse_example_matches_reference():
    from heat_tpu.utils.data._utils import _parse_example

    ints = _ld(3, _ld(1, b"".join(_varint(v) for v in (7, 300))))
    floats = _ld(2, _ld(1, struct.pack("<2f", 0.5, -1.25)))
    payload = _example({"a": _ld(1, _ld(1, b"img")), "b": ints, "c": floats})
    assert tutils._parse_example(payload) == _parse_example(payload)
    assert tutils._parse_example(payload)["b"] == [7, 300]


def test_merge_imagenet_tfrecord(tmp_path):
    h5py = pytest.importorskip("h5py")
    pytest.importorskip("PIL")
    import io

    from PIL import Image

    rng = np.random.default_rng(1)
    img = rng.integers(0, 255, (5, 4, 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")

    def ints(*v):
        return _ld(3, b"".join(_varint(1 << 3) + _varint(x) for x in v))

    payload = _example({"image/encoded": _ld(1, _ld(1, buf.getvalue())),
                        "image/class/label": ints(3)})
    _frames(tmp_path / "train-0", [payload, payload])
    tutils.merge_files_imagenet_tfrecord(str(tmp_path), str(tmp_path))
    with h5py.File(tmp_path / "imagenet_merged.h5") as f:
        assert f["images"].shape == (2,) and f["metadata"].shape == (2, 9)
        assert list(f["metadata"][0, :4]) == [5.0, 4.0, 3.0, 2.0]
        assert f["metadata"][0, 8] == -2  # the full-image box of a record without one
    assert not (tmp_path / "imagenet_merged_validation.h5").exists()


# ------------------------------------------------- torchvision-gated, on a stub


@pytest.fixture
def stub_torchvision(monkeypatch):
    rng = np.random.default_rng(9)
    images = rng.integers(0, 255, (12, 4, 4)).astype(np.uint8)
    labels = rng.integers(0, 10, 12)

    class MNIST:
        def __init__(self, root, train=True, transform=None, target_transform=None,
                     download=True):
            assert not download, "no test downloads"
            n = 10 if train else 2
            self.data = torch.from_numpy(images[:n] if train else images[10:])
            self.targets = torch.from_numpy(labels[:n] if train else labels[10:])
            self.transform, self.target_transform = transform, target_transform

        def __len__(self):
            return self.data.shape[0]

        def __getitem__(self, i):
            x, y = self.data[i].numpy(), int(self.targets[i])
            return (self.transform(x) if self.transform else x,
                    self.target_transform(y) if self.target_transform else y)

    tv = pytypes.ModuleType("torchvision")
    tv.datasets = pytypes.ModuleType("torchvision.datasets")
    tv.datasets.MNIST = MNIST
    tv.transforms = pytypes.ModuleType("torchvision.transforms")
    tv.transforms.Compose = lambda fs: ("compose", tuple(fs))
    monkeypatch.setitem(sys.modules, "torchvision", tv)
    monkeypatch.setitem(sys.modules, "torchvision.datasets", tv.datasets)
    monkeypatch.setitem(sys.modules, "torchvision.transforms", tv.transforms)
    return images, labels


@pytest.mark.parametrize("split", [0, None])
def test_mnist_on_a_stub_matches_reference(stub_torchvision, split):
    images, labels = stub_torchvision
    got = htt.utils.data.MNISTDataset("/nonexistent", download=False, split=split)
    want = ht_tpu.utils.data.MNISTDataset("/nonexistent", download=False, split=split,
                                          comm=_mesh(1))
    assert np.array_equal(got.htdata.numpy(), np.asarray(want.data))
    assert np.array_equal(got.httargets.numpy(), np.asarray(want.targets))
    assert got.htdata.split == split and not got.test_set
    test = htt.utils.data.MNISTDataset("/x", train=False, download=False)
    assert test.test_set and len(test) == 2
    tr = htt.utils.data.MNISTDataset("/x", download=False,
                                     transform=lambda a: a.astype(np.float32) * 2,
                                     target_transform=lambda t: t + 1)
    assert np.array_equal(tr.htdata.numpy(), images[:10].astype(np.float32) * 2)
    assert np.array_equal(tr.httargets.numpy(), labels[:10] + 1)


def test_vision_transforms_on_a_stub(stub_torchvision):
    from heat_tpu_torch.utils import vision_transforms

    assert vision_transforms.Compose([1]) == ("compose", (1,))
    with pytest.raises(AttributeError):
        vision_transforms.NotATransform


def test_gated_names_raise_the_reference_import_error(monkeypatch):
    from heat_tpu_torch.utils import vision_transforms

    monkeypatch.setitem(sys.modules, "torchvision", None)
    with pytest.raises(ImportError, match="torchvision"):
        vision_transforms.Compose
    with pytest.raises(ImportError, match="torchvision"):
        htt.utils.data.MNISTDataset("/x", download=False)
    with pytest.raises(AttributeError):
        htt.utils.data.NotAName
