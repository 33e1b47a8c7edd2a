"""The first slice of heat_tpu_torch as a whole.

- the main path (array split=0 → x*2+1 → mean/var/std → cdist → KMeans)
  against heat_tpu on one numpy input, with the tolerances of the module
  tests (mean 1e-5, var/std 1e-4 relative, cdist 1e-5 relative off the
  diagonal, identical labels and n_iter on separable blobs);
- isolation: importing the package loads neither jax nor heat_tpu, and its
  source imports neither;
- the device rule: without a card and without a request for the CPU, an
  entry point raises;
- three gloo ranks (an uneven tail: 6, 6, 5 rows) give the world-of-one
  results for the sharded moments merge and the per-iteration Lloyd
  allreduce.
"""

import os
import re
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import heat_tpu as ht_tpu

import heat_tpu_torch as htt

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "heat_tpu_torch"


@pytest.fixture
def on_cpu():
    htt.use_device("cpu")
    yield
    htt.use_device(None)


def _blobs(n, d, k, seed):
    rng = np.random.default_rng(seed)
    protos = (rng.standard_normal((k, d)) * 10).astype(np.float32)
    x = (protos[rng.integers(0, k, n)] + rng.standard_normal((n, d))).astype(np.float32)
    c0 = (protos + 0.5 * rng.standard_normal((k, d))).astype(np.float32)
    return x, c0


def test_main_path_matches_heat_tpu(on_cpu):
    rng = np.random.default_rng(0)
    xm = rng.standard_normal((203, 16)).astype(np.float32)
    xk, c0 = _blobs(301, 8, 6, seed=1)

    got_y = htt.array(xm, split=0) * 2 + 1
    ref_y = ht_tpu.array(xm, split=0) * 2 + 1
    for name, rtol in (("mean", 1e-5), ("var", 1e-4), ("std", 1e-4)):
        got = getattr(htt, name)(got_y, axis=0)
        ref = getattr(ht_tpu, name)(ref_y, axis=0)
        assert (got.shape, got.split) == (ref.shape, ref.split)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=rtol, atol=1e-6)

    xc = rng.random((70, 12)).astype(np.float32)
    yc = rng.random((45, 12)).astype(np.float32)
    got = htt.spatial.cdist(htt.array(xc, split=0), htt.array(yc, split=0), quadratic_expansion=True)
    ref = ht_tpu.spatial.cdist(ht_tpu.array(xc, split=0), ht_tpu.array(yc, split=0),
                               quadratic_expansion=True)
    assert (got.shape, got.split) == (ref.shape, ref.split)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5, atol=1e-6)

    got = htt.cluster.KMeans(n_clusters=6, init=htt.array(c0), max_iter=50, tol=0.0).fit(
        htt.array(xk, split=0))
    ref = ht_tpu.cluster.KMeans(n_clusters=6, init=ht_tpu.array(c0), max_iter=50, tol=0.0).fit(
        ht_tpu.array(xk, split=0))
    assert got.n_iter_ == ref.n_iter_
    np.testing.assert_array_equal(got.labels_.numpy(), ref.labels_.numpy())
    np.testing.assert_allclose(got.cluster_centers_.numpy(), ref.cluster_centers_.numpy(),
                               rtol=0, atol=1e-5)


def test_cpu_main_path_launches_no_kernel(on_cpu):
    htt.reset_launch_counts()
    x = htt.array(np.ones((10, 4), np.float32), split=0)
    htt.mean(x, axis=0), htt.spatial.cdist(x, quadratic_expansion=True)
    htt.cluster.KMeans(n_clusters=2, init=htt.array(np.eye(2, 4, dtype=np.float32))).fit(x)
    lm = htt.nn.TransformerLM(16, 8, 2, 1, max_len=8, attn_impl="flash", remat=True)
    lm(torch.zeros((1, 8), dtype=torch.long)).float().sum().backward()
    htt.linalg.matmul_int8(torch.ones((3, 4)), torch.ones((4, 2)))
    assert htt.launch_counts() == {"moments": 0, "cdist": 0, "lloyd": 0, "flash_fwd": 0,
                                   "int8_gemm": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
                                   "flash_bwd_fused": 0}


def test_import_loads_neither_jax_nor_heat_tpu():
    code = textwrap.dedent("""
        import sys
        import heat_tpu_torch
        bad = [m for m in sys.modules
               if m == "jax" or m.startswith("jax.") or m == "heat_tpu" or m.startswith("heat_tpu.")]
        assert "heat_tpu_torch" in sys.modules
        print(bad)
        sys.exit(1 if bad else 0)
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_source_imports_neither_jax_nor_heat_tpu():
    pattern = re.compile(r"^\s*(import|from)\s+(jax\b|heat_tpu\b(?!_torch))", re.M)
    offenders = [str(p) for p in PKG.rglob("*.py") if pattern.search(p.read_text())]
    assert offenders == []
    assert pattern.search("import jax.numpy as jnp") and pattern.search("from heat_tpu.core import x")
    assert not pattern.search("from heat_tpu_torch import core")


def test_entry_point_without_card_or_cpu_request_raises():
    htt.use_device(None)
    if torch.cuda.is_available():
        assert htt.array([1.0]).larray.is_cuda
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        htt.array([1.0, 2.0])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        htt.zeros((3,))
    assert htt.array([1.0], device="cpu").larray.device.type == "cpu"


def test_cuda_wrapper_refuses_wrong_input_before_launch():
    from heat_tpu_torch.core.cuda_moments import column_moments

    with pytest.raises(ValueError):
        column_moments(torch.ones(3))


_WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch.distributed as dist
    rank, world, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    import heat_tpu_torch as ht
    ht.use_device("cpu")
    rng = np.random.default_rng(0)
    xm = (rng.standard_normal((17, 5)) * 3 + 2).astype(np.float32)
    protos = (rng.standard_normal((4, 3)) * 10).astype(np.float32)
    xk = (protos[rng.integers(0, 4, 40)] + rng.standard_normal((40, 3))).astype(np.float32)
    c0 = (protos + 0.5).astype(np.float32)
    x = ht.array(xm, split=0)
    res = {"lshape": np.array(x.lshape), "mean": ht.mean(x, axis=0).numpy(),
           "var": ht.var(x, axis=0).numpy()}
    for name, init in (("dn", ht.array(c0)), ("random", "random")):
        km = ht.cluster.KMeans(n_clusters=4, init=init, max_iter=20, tol=0.0, random_state=2)
        km.fit(ht.array(xk, split=0))
        res[name + "_centers"] = km.cluster_centers_.numpy()
        res[name + "_labels"] = km.labels_.numpy()
        res[name + "_n_iter"] = np.array(km.n_iter_)
        res[name + "_inertia"] = np.array(km.inertia_)
    np.savez(f"{out}/rank{rank}.npz", **res)
    dist.destroy_process_group()
""")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_three_gloo_ranks_match_world_of_one(tmp_path, on_cpu):
    world = 3
    port = _free_port()
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen([sys.executable, "-c", _WORKER, str(r), str(world), str(port), str(tmp_path)],
                         cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)
    ]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=120)[0])
        finally:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)

    # the world of one, in this process
    rng = np.random.default_rng(0)
    xm = (rng.standard_normal((17, 5)) * 3 + 2).astype(np.float32)
    protos = (rng.standard_normal((4, 3)) * 10).astype(np.float32)
    xk = (protos[rng.integers(0, 4, 40)] + rng.standard_normal((40, 3))).astype(np.float32)
    c0 = (protos + 0.5).astype(np.float32)
    x = htt.array(xm, split=0)
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(world)]
    assert [tuple(r["lshape"]) for r in ranks] == [(6, 5), (6, 5), (5, 5)]
    for r in ranks:
        np.testing.assert_allclose(r["mean"], htt.mean(x, axis=0).numpy(), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(r["var"], htt.var(x, axis=0).numpy(), rtol=1e-5)
    for name, init in (("dn", htt.array(c0)), ("random", "random")):
        km = htt.cluster.KMeans(n_clusters=4, init=init, max_iter=20, tol=0.0, random_state=2)
        km.fit(htt.array(xk, split=0))
        for r in ranks:
            assert int(r[name + "_n_iter"]) == km.n_iter_
            np.testing.assert_array_equal(r[name + "_labels"], km.labels_.numpy())
            np.testing.assert_allclose(r[name + "_centers"], km.cluster_centers_.numpy(),
                                       rtol=0, atol=1e-5)
            np.testing.assert_allclose(float(r[name + "_inertia"]), km.inertia_, rtol=1e-5)
