"""The indexing and manipulation paths that cross ranks, on three gloo
ranks, against a world of one and heat_tpu.

One spawned world of three gloo ranks (a module fixture) runs every call
of ``_MANIP_CALLS`` on arrays of 7 rows (chunks of 3, 3, 1) and of 2 rows
(1, 1, 0: an empty chunk): ``sort`` both ways (ties, a NaN, bool, int),
``topk``, ``unique`` flat and by rows with the inverse, ``percentile``
along the split axis, ``getitem`` with steps, negative steps, an int,
integer arrays and masks on the split axis, ``setitem`` with a value split
along another axis and with a ragged value, ``concatenate`` along the
split axis, ``reshape`` with ``new_split``, ``flip``/``roll`` along the
split axis, ``nonzero``, ``diagonal``, ``squeeze`` of the split axis, and
the halos. Each rank's global result must equal the world of one's (the
same calls in this process) exactly, its chunk must be the ceil-rule
chunk of it for three ranks, and the world of one's must equal the JAX
package's on its 8-device mesh in values, type and split (the NaN sort is
held to numpy instead: ROADMAP §3).
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
from heat_tpu_torch.core import communication as tcomm

REPO = Path(__file__).resolve().parent.parent
WORLD = 3


@pytest.fixture(autouse=True)
def on_cpu():
    htt.use_device("cpu")
    yield
    htt.use_device(None)


_CALLS = textwrap.dedent("""
    def _MANIP_CALLS(ht):
        rng = np.random.default_rng(7)
        x7 = np.round(rng.standard_normal((7, 4)) * 2).astype(np.float32)  # ties
        x2 = rng.standard_normal((2, 3)).astype(np.float32)
        i7 = rng.integers(0, 4, 7).astype(np.int64)
        nan7 = np.array([3, np.nan, 1, 2, 5, 4, 0], dtype=np.float32)
        r7 = np.array([[1, 2], [0, 1], [1, 2], [3, 3], [0, 1], [1, 2], [9, 0]], np.int32)
        a = lambda v, s=0: ht.array(v, split=s)
        idx = np.array([6, 0, -1, 3, 3])

        def setitem(v, s, key, value):
            y = a(v, s)
            y[key] = value
            return y

        return [
            ("sort_0", lambda: ht.sort(a(x7), axis=0)),
            ("sort_desc_0", lambda: ht.sort(a(x7), axis=0, descending=True)),
            ("sort_1", lambda: ht.sort(a(x7.T.copy(), 1), axis=1)),
            ("sort_int", lambda: ht.sort(a(i7), descending=True)),
            ("sort_bool", lambda: ht.sort(a(i7 > 1))),
            ("sort_2rows", lambda: ht.sort(a(x2), axis=0)),
            ("sort_nan", lambda: ht.sort(a(nan7))),
            ("sort_nan_desc", lambda: ht.sort(a(nan7), descending=True)),
            ("topk_0", lambda: ht.topk(a(x7), 3, dim=0)),
            ("topk_small", lambda: ht.topk(a(x7), 2, dim=0, largest=False)),
            ("topk_2rows", lambda: ht.topk(a(x2), 2, dim=0)),
            ("unique", lambda: ht.unique(a(i7), return_inverse=True)),
            ("unique_2d", lambda: ht.unique(a(x7), return_inverse=True)),
            ("unique_rows", lambda: ht.unique(a(r7), return_inverse=True, axis=0)),
            ("unique_cols", lambda: ht.unique(a(r7.T.copy(), 1), axis=1)),
            ("percentile", lambda: ht.percentile(a(x7), [0, 30, 50, 99], axis=0)),
            ("median_2rows", lambda: ht.median(a(x2), axis=0)),
            ("get_step", lambda: a(x7)[::3]),
            ("get_negstep", lambda: a(x7)[::-2]),
            ("get_slice", lambda: a(x7)[1:6, 1:]),
            ("get_int", lambda: a(x7)[4]),
            ("get_iarr", lambda: a(x7)[idx]),
            ("get_iarr_1", lambda: a(x7, 1)[:, np.array([3, 0])]),
            ("get_pair", lambda: a(x7)[np.array([6, 1]), np.array([0, 3])]),
            ("get_mask", lambda: a(x7)[a(x7 > 0)]),
            ("get_mask_1", lambda: a(x7, 1)[x7 > 0]),
            ("get_rows", lambda: a(x7)[a(i7 > 1)]),
            ("get_2rows", lambda: a(x2)[::-1]),
            ("set_split_value", lambda: setitem(x7, 0, slice(1, 6),
                                                a(np.arange(20, dtype=np.float32).reshape(5, 4), 1))),
            ("set_negstep", lambda: setitem(x7, 0, slice(None, None, -2),
                                            a(np.arange(16, dtype=np.float32).reshape(4, 4), 0))),
            ("set_ragged", lambda: setitem(x7, 1, x7 > 0,
                                           a(np.arange((x7 > 0).sum(), dtype=np.float32), 0))),
            ("set_iarr", lambda: setitem(x7, 0, idx[:3], -5.0)),
            ("set_bool_tuple", lambda: setitem(x7, 0, (i7 > 1, 2), 8.0)),
            ("concat_0", lambda: ht.concatenate([a(x7), a(x7[:2]), a(x7[:3], None)], axis=0)),
            ("reshape_ns1", lambda: ht.reshape(a(x7), (4, 7), new_split=1)),
            ("reshape_ns0", lambda: ht.reshape(a(x7, 1), (14, 2), new_split=0)),
            ("flatten", lambda: ht.flatten(a(x7, 1))),
            ("flip_0", lambda: ht.flip(a(x7), 0)),
            ("flip_2rows", lambda: ht.flip(a(x2), 0)),
            ("roll_0", lambda: ht.roll(a(x7), 5, 0)),
            ("roll_neg", lambda: ht.roll(a(x7), -3, 0)),
            ("roll_flat", lambda: ht.roll(a(x7), 9)),
            ("nonzero", lambda: ht.nonzero(a(i7 > 1))),
            ("nonzero_1", lambda: ht.nonzero(a(x7 > 0, 1))),
            ("diagonal", lambda: ht.diagonal(a(x7))),
            ("squeeze", lambda: ht.squeeze(a(x7[2:3]), 0)),
            ("split_pieces", lambda: ht.split(a(x7), [2, 5])),
        ]
""")

_WORKER = _CALLS + textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    rank, world, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    import heat_tpu_torch as ht
    ht.use_device("cpu")
    res = {}

    def keep(name, x):
        if isinstance(x, (tuple, list)):
            for j, part in enumerate(x):
                keep(f"{name}.{j}", part)
            return
        res[name] = x.numpy()
        res[name + "_meta"] = np.array([x.dtype.__name__, str(x.split), str(tuple(x.lshape))])
        res[name + "_local"] = x.larray.numpy()

    for name, call in _MANIP_CALLS(ht):
        keep(name, call())
    # halos: the neighbours' edge rows, zeros at the global edges
    y = ht.array(np.arange(28, dtype=np.float32).reshape(7, 4), split=0)
    y.get_halo(1)
    res["halo_prev"], res["halo_next"] = y.halo_prev.numpy(), y.halo_next.numpy()
    res["with_halos"] = y.array_with_halos(1).numpy()
    res["padded"] = np.array(y.padded_shape + (y.pad_count,))
    try:
        ht.array(np.zeros((2, 3)), split=0).get_halo(1)
        res["halo_empty_raises"] = np.array(False)
    except ValueError:
        res["halo_empty_raises"] = np.array(True)
    np.savez(f"{out}/rank{rank}.npz", **res)
    dist.destroy_process_group()
""")
exec(_CALLS)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def gloo_ranks(tmp_path_factory):
    """One spawned world of three gloo ranks; each rank's saved results."""
    out = tmp_path_factory.mktemp("manip_gloo")
    port = _free_port()
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(r), str(WORLD), str(port),
                               str(out)], cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=180)[0])
        finally:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)]


def _flat(name, x):
    if isinstance(x, (tuple, list)):
        out = []
        for j, part in enumerate(x):
            out += _flat(f"{name}.{j}", part)
        return out
    return [(name, x)]


def _world_of_one():
    return dict(item for name, call in _MANIP_CALLS(htt) for item in _flat(name, call()))


@pytest.fixture(scope="module")
def world_of_one():
    htt.use_device("cpu")
    return _world_of_one()


@pytest.mark.parametrize("name", sorted({n for n, _ in _MANIP_CALLS(htt)}))
def test_gloo_ranks_equal_a_world_of_one(gloo_ranks, world_of_one, name):
    """Each rank's global result is the world of one's, bit for bit, and its
    chunk the ceil-rule chunk of it for three ranks."""
    parts = {k: v for k, v in world_of_one.items() if k == name or k.startswith(name + ".")}
    assert parts
    for key, want in parts.items():
        values = want.numpy()
        for rank, r in enumerate(gloo_ranks):
            dtype, split, lshape = r[key + "_meta"]
            assert (dtype, split) == (want.dtype.__name__, str(want.split)), (key, rank)
            np.testing.assert_array_equal(r[key], values, err_msg=f"{key} on rank {rank}")
            if want.split is not None:
                sl = tcomm.chunk(want.shape, want.split, rank, WORLD)[2]
                assert lshape == str(tuple(int(v) for v in values[sl].shape)), (key, rank)
                np.testing.assert_array_equal(r[key + "_local"], values[sl])


@pytest.mark.parametrize("name", sorted({n for n, _ in _MANIP_CALLS(htt)} - {"sort_nan",
                                                                           "sort_nan_desc"}))
def test_world_of_one_equals_heat_tpu(world_of_one, name):
    """The same calls in the JAX package on its 8-device mesh: values,
    type and split."""
    ref = dict(item for n, call in _MANIP_CALLS(ht_tpu) if n == name
               for item in _flat(n, call()))
    got = {k: v for k, v in world_of_one.items() if k == name or k.startswith(name + ".")}
    assert sorted(got) == sorted(ref)
    for key, want in ref.items():
        g = got[key]
        assert (g.dtype.__name__, g.split, g.shape) == (want.dtype.__name__, want.split,
                                                        tuple(want.shape)), key
        np.testing.assert_array_equal(g.numpy(), np.asarray(want.numpy()), err_msg=key)


def test_gloo_nan_sort_is_numpys(gloo_ranks):
    x = np.array([3, np.nan, 1, 2, 5, 4, 0], dtype=np.float32)
    order = np.array([6, 2, 3, 0, 5, 4, 1])
    for r in gloo_ranks:
        np.testing.assert_array_equal(r["sort_nan.1"], order)
        np.testing.assert_array_equal(r["sort_nan.0"], x[order])
        np.testing.assert_array_equal(r["sort_nan_desc.1"], [1, 4, 5, 0, 3, 2, 6])


def test_gloo_halos(gloo_ranks):
    """Rank r's halos are rank r-1's last row and rank r+1's first (zeros at
    the global edges); an empty chunk makes every halo raise; the padded
    shape is the JAX package's number for three ranks."""
    y = np.arange(28, dtype=np.float32).reshape(7, 4)
    chunks = [y[0:3], y[3:6], y[6:7]]
    zero = np.zeros((1, 4), np.float32)
    for rank, r in enumerate(gloo_ranks):
        prev = chunks[rank - 1][-1:] if rank else zero
        nxt = chunks[rank + 1][:1] if rank < 2 else zero
        np.testing.assert_array_equal(r["halo_prev"], prev)
        np.testing.assert_array_equal(r["halo_next"], nxt)
        np.testing.assert_array_equal(r["with_halos"], np.concatenate([prev, chunks[rank], nxt]))
        assert r["padded"].tolist() == [9, 4, 2]
        assert bool(r["halo_empty_raises"])
