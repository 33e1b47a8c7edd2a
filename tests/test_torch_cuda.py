"""heat_tpu_torch's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA card and skips without one. The file imports
neither jax nor heat_tpu, so that it runs on a machine that has only
PyTorch; there, run it without the suite's jax conftest:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerances, as in chip_smoke.py: moments mean within 1e-5 of the column's
spread, M2 1e-4 relative; cdist squared distances within 2e-5 of
|x|^2 + |y|^2 (the error scale of an f32 GEMM-form expansion), rbf the
same times gamma; Lloyd counts exact on separated blobs, sums within 1e-4
of the sum of |x|, and two runs bit-identical. Flash attention: in f32, O
within 2e-5 max|v| (both sum exact-f32 products in other orders); in bf16,
O within 2^-7 max|v| (each output is rounded to bf16, one ulp of
|O| <= max|v| is 2^-8 max|v|, and a probability near a bf16 rounding
boundary may round the other way); the LSE within 1e-5 (1 + |lse|) in both
(its products are exact in f32). The int8 GEMM is bit-identical.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import heat_tpu_torch as htt
from heat_tpu_torch.cluster import cuda_lloyd
from heat_tpu_torch.core import communication, cuda_moments
from heat_tpu_torch.core.linalg import cuda_quant, quantize_int8
from heat_tpu_torch.parallel import cuda_attention
from heat_tpu_torch.spatial import cuda_cdist

ARRAY_PATH_KERNELS = ("moments", "cdist", "lloyd")

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("m,d,lim", [(1_000_003, 100, 1_000_003), (5000, 64, 4990),
                                     (100, 4096, 100), (7, 1, 7)])
def test_moments_kernel_matches_plain(dev, m, d, lim):
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((m, d), generator=g, device=dev) * 3 + 1.5
    mu_k, m2_k = cuda_moments.column_moments(x, lim)
    mu_p, m2_p = cuda_moments.column_moments_plain(x, lim)
    spread = mu_p.abs() + torch.sqrt(m2_p / lim)
    assert bool(((mu_k - mu_p).abs() <= 1e-5 * spread).all())
    assert bool(((m2_k - m2_p).abs() <= 1e-4 * m2_p.abs()).all())
    mu_k2, m2_k2 = cuda_moments.column_moments(x, lim)
    assert torch.equal(mu_k, mu_k2) and torch.equal(m2_k, m2_k2)


@pytest.mark.parametrize("m,n,k", [(1000, 999, 127), (129, 4097, 512), (1, 1, 1)])
@pytest.mark.parametrize("epilogue", ["dist", "rbf"])
def test_cdist_kernel_matches_plain(dev, m, n, k, epilogue):
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.rand((m, k), generator=g, device=dev)
    y = torch.rand((n, k), generator=g, device=dev)
    gamma = 0.5 / k
    out_k = cuda_cdist.euclid(x, y, gamma, epilogue)
    out_p = cuda_cdist.euclid_plain(x, y, gamma, epilogue)
    scale = (x * x).sum(1)[:, None] + (y * y).sum(1)[None, :]
    lhs = (out_k - out_p).abs() if epilogue == "rbf" else (out_k ** 2 - out_p ** 2).abs()
    limit = (gamma if epilogue == "rbf" else 1.0) * (2e-5 * scale + 1e-6)
    assert bool((lhs <= limit).all())


@pytest.mark.parametrize("n,d,k", [(100_003, 33, 1000), (20_011, 512, 1024), (65, 1, 1)])
def test_lloyd_kernel_matches_plain(dev, n, d, k):
    g = torch.Generator(device=dev).manual_seed(0)
    protos = torch.randn((k, d), generator=g, device=dev) * 8
    lab = torch.randint(0, k, (n,), generator=g, device=dev)
    x = protos[lab] + torch.randn((n, d), generator=g, device=dev)
    s_k, n_k = cuda_lloyd.lloyd_update(x, protos)
    s_p, n_p = cuda_lloyd.lloyd_update_plain(x, protos)
    assert torch.equal(n_k, n_p)
    abs_sums = torch.zeros_like(protos).index_add_(0, torch.argmin(torch.cdist(x, protos), 1), x.abs())
    assert bool(((s_k - s_p).abs() <= 1e-4 * abs_sums + 1e-5).all())
    s_k2, n_k2 = cuda_lloyd.lloyd_update(x, protos)
    assert torch.equal(s_k, s_k2) and torch.equal(n_k, n_k2)


def test_cdist_kernel_past_65535_row_tiles(dev):
    """More 128-row tiles of x than a grid's y dimension takes."""
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.rand((65535 * 128 + 5, 3), generator=g, device=dev)
    y = torch.rand((2, 3), generator=g, device=dev)
    out_k = cuda_cdist.euclid(x, y)
    out_p = cuda_cdist.euclid_plain(x, y)
    scale = (x * x).sum(1)[:, None] + (y * y).sum(1)[None, :]
    assert bool(((out_k ** 2 - out_p ** 2).abs() <= 2e-5 * scale + 1e-6).all())


def test_lloyd_kernel_past_2_31_rows(dev):
    """Row and tile indices past int32: the 256 rows at and past 2^31 go to
    the second center, all others to the first."""
    n = 2 ** 31 + 256
    x = torch.ones((n, 1), device=dev)
    x[2 ** 31:] = 10.0
    c = torch.tensor([[0.9], [9.0]], device=dev)
    s_k, n_k = cuda_lloyd.lloyd_update(x, c)
    assert n_k.tolist() == [float(2 ** 31), 256.0]
    assert s_k[1, 0].item() == 2560.0
    # the blocks' partial sums are exact; adding some 500 of them in f32
    # rounds each add by at most half a step of 256 near 2^31
    assert abs(s_k[0, 0].item() - 2 ** 31) <= 1e-4 * 2 ** 31


def test_main_path_on_card_launches_every_kernel(dev):
    g = torch.Generator(device=dev).manual_seed(1)
    htt.use_device(None)
    htt.reset_launch_counts()
    x = htt.array(torch.randn((5000, 16), generator=g, device=dev), split=0)
    assert x.larray.is_cuda
    y = x * 2 + 1
    mu = htt.mean(y, axis=0)
    torch.testing.assert_close(mu.larray, y.larray.mean(0), rtol=1e-5, atol=1e-5)
    d = htt.spatial.cdist(y, quadratic_expansion=True)
    assert d.shape == (5000, 5000) and bool(torch.isfinite(d.larray).all())
    km = htt.cluster.KMeans(n_clusters=4, init="random", random_state=0, max_iter=10).fit(x)
    assert km.labels_.larray.is_cuda
    counts = htt.launch_counts()
    assert all(counts[name] > 0 for name in ARRAY_PATH_KERNELS), counts


def _flash_close(dev, b, t_q, t_k, h, d, dtype, causal, kv_valid):
    g = torch.Generator(device=dev).manual_seed(t_q + d)
    q = torch.randn((b, t_q, h, d), generator=g, device=dev).to(dtype)
    k = torch.randn((b, t_k, h, d), generator=g, device=dev).to(dtype)
    v = torch.randn((b, t_k, h, d), generator=g, device=dev).to(dtype)
    scale = 1.0 / d ** 0.5
    o_k, lse_k = cuda_attention._flash_forward(q, k, v, scale, causal, kv_valid, return_lse=True)
    o_k2 = cuda_attention._flash_forward(q, k, v, scale, causal, kv_valid)
    o_p, lse_p = cuda_attention.flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                                      kv_valid=kv_valid, return_lse=True)
    assert o_k.shape == o_p.shape and o_k.dtype == dtype and lse_k.shape == (b, h, t_q)
    tol = (2e-5 if dtype == torch.float32 else 2.0 ** -7) * v.float().abs().max()
    assert bool(((o_k.float() - o_p.float()).abs() <= tol).all())
    assert bool(((lse_k - lse_p).abs() <= 1e-5 * (1 + lse_p.abs())).all())
    assert torch.equal(o_k, o_k2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [24, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_kernel_matches_plain_ragged(dev, dtype, d, causal):
    _flash_close(dev, 2, 1000, 1337, 3, d, dtype, causal, 900)


@pytest.mark.parametrize("b,t,h,d", [(2, 256, 4, 64), (1, 1, 1, 8), (1, 65, 2, 100)])
def test_flash_kernel_matches_plain_causal_bf16(dev, b, t, h, d):
    _flash_close(dev, b, t, t, h, d, torch.bfloat16, True, t)


def test_flash_kernel_fully_masked_rows(dev):
    q = torch.randn((1, 8, 2, 64), device=dev, dtype=torch.bfloat16)
    o, lse = cuda_attention._flash_forward(q, q, q, 0.125, False, 0, return_lse=True)
    assert bool((o == 0).all()) and bool((lse == 1e30).all())


def test_flash_kernel_rejects_wide_heads(dev):
    q = torch.randn((1, 8, 1, 129), device=dev)
    with pytest.raises(ValueError, match="128"):
        cuda_attention.flash_attention(q, q, q)


def test_flash_backward_raises(dev):
    q = torch.randn((1, 64, 2, 32), device=dev, requires_grad=True)
    out = cuda_attention.flash_attention(q, q.detach(), q.detach(), causal=True)
    with pytest.raises(NotImplementedError, match="K7a"):
        out.sum().backward()


@pytest.mark.parametrize("m,n,k", [(1000, 1000, 999), (1, 1, 1), (129, 4097, 512), (300, 77, 33)])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_int8_kernel_bit_identical_to_plain(dev, m, n, k, out_dtype):
    g = torch.Generator(device=dev).manual_seed(m + n + k)
    qa, sa = quantize_int8(torch.randn((m, k), generator=g, device=dev), axis=1)
    qb, sb = quantize_int8(torch.randn((k, n), generator=g, device=dev), axis=0)
    got = cuda_quant.int8_gemm(qa, sa, qb, sb, out_dtype)
    want = cuda_quant.int8_gemm_plain(qa, sa, qb, sb, out_dtype)
    assert got.dtype == out_dtype and torch.equal(got, want)


def test_int8_kernel_extreme_values_bit_identical(dev):
    """All operands at +-127 and -127: the largest sums the accumulator holds."""
    qa = torch.full((256, 4096), -127, dtype=torch.int8, device=dev)
    qb = torch.full((4096, 128), 127, dtype=torch.int8, device=dev)
    qb[:, ::2] = -127
    sa = torch.rand((256, 1), device=dev)
    sb = torch.rand((1, 128), device=dev)
    assert torch.equal(cuda_quant.int8_gemm(qa, sa, qb, sb), cuda_quant.int8_gemm_plain(qa, sa, qb, sb))


def test_lm_forward_launches_flash_once_per_layer(dev):
    kw = dict(vocab_size=100, d_model=64, num_heads=4, num_layers=3, max_len=128,
              dtype=torch.bfloat16, device=dev)
    flash = htt.nn.TransformerLM(**kw, attn_impl="flash", generator=torch.Generator(dev).manual_seed(0))
    local = htt.nn.TransformerLM(**kw, attn_impl="local", generator=torch.Generator(dev).manual_seed(0))
    tokens = torch.randint(0, 100, (2, 128), device=dev)
    htt.reset_launch_counts()
    with torch.inference_mode():
        got = flash(tokens)
        assert htt.launch_counts()["flash_fwd"] == 3
        want = local(tokens)
    assert got.shape == (2, 128, 100) and got.dtype == torch.bfloat16
    err = ((got.float() - want.float()).norm() / want.float().norm()).item()
    assert err <= 2e-2, err


_DATA = """
import numpy as np
import torch

def make_data():
    g = torch.Generator().manual_seed(0)
    xm = torch.randn((1_000_003, 64), generator=g) * 3 + 1.5
    xc = torch.rand((4099, 64), generator=g)
    yc = torch.rand((3001, 64), generator=g)
    protos = torch.randn((16, 32), generator=g) * 10
    xk = protos[torch.randint(0, 16, (400_003,), generator=g)] + torch.randn((400_003, 32), generator=g)
    c0 = protos + 0.5
    return xm, xc, yc, xk, c0

def run(ht, device):
    xm, xc, yc, xk, c0 = (t.to(device) for t in make_data())
    ht.reset_launch_counts()
    x = ht.array(xm, split=0)
    res = {"lshape": np.array(x.lshape), "mean": ht.mean(x, axis=0).numpy(),
           "var": ht.var(x, axis=0).numpy(),
           "cdist": ht.spatial.cdist(ht.array(xc, split=0), ht.array(yc, split=0),
                                     quadratic_expansion=True).numpy()}
    # 'random' with no iteration: its centers are the drawn rows, gathered
    # across ranks by one allreduce
    for name, init, iters in (("dn", ht.array(c0), 20), ("random", "random", 0)):
        km = ht.cluster.KMeans(n_clusters=16, init=init, max_iter=iters, tol=0.0, random_state=5)
        km.fit(ht.array(xk, split=0))
        res[name + "_centers"] = km.cluster_centers_.numpy()
        res[name + "_labels"] = km.labels_.numpy()
        res[name + "_n_iter"] = np.array(km.n_iter_)
    res["launches"] = np.array([ht.launch_counts()[n] for n in ("moments", "cdist", "lloyd")])
    return res
"""

_WORKER = """
import sys
import numpy as np
import torch
import torch.distributed as dist
rank, world, port, out, backend = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5]
if backend == "nccl":
    torch.cuda.set_device(rank)
dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=world)
import heat_tpu_torch as ht
ht.use_device("gpu" if backend == "nccl" else "cpu")
""" + _DATA + """
res = run(ht, torch.device("cuda", rank) if backend == "nccl" else torch.device("cpu"))
np.savez(f"{out}/rank{rank}.npz", **res)
dist.barrier()
dist.destroy_process_group()
"""


def _spmd_ranks(tmp_path, world, backend):
    """Run ``_WORKER`` on ``world`` ranks; returns each rank's saved results."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    repo = Path(__file__).resolve().parent.parent
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(r), str(world), str(port),
                               str(tmp_path), backend], cwd=repo, env=dict(os.environ),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=600)[0])
        finally:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    return [np.load(tmp_path / f"rank{r}.npz") for r in range(world)]


def test_nccl_ranks_match_world_of_one(dev, tmp_path):
    """Every card of the machine is one rank over NCCL; the sharded moments
    merge, the replicated y of cdist and the per-iteration Lloyd allreduce
    must give the world-of-one results of this process."""
    world = torch.cuda.device_count()
    if world < 2:
        pytest.skip("needs two or more CUDA cards")
    ranks = _spmd_ranks(tmp_path, world, "nccl")
    ns = {}
    exec(_DATA, ns)
    htt.use_device(None)
    want = ns["run"](htt, dev)
    for r in ranks:
        assert (r["launches"] > 0).all()
        spread = np.abs(want["mean"]) + np.sqrt(want["var"])
        assert (np.abs(r["mean"] - want["mean"]) <= 1e-5 * spread).all()
        np.testing.assert_allclose(r["var"], want["var"], rtol=1e-4)
        np.testing.assert_allclose(r["cdist"], want["cdist"], rtol=1e-6, atol=1e-6)
        assert int(r["dn_n_iter"]) == int(want["dn_n_iter"])
        np.testing.assert_array_equal(r["dn_labels"], want["dn_labels"])
        np.testing.assert_allclose(r["dn_centers"], want["dn_centers"], rtol=0, atol=1e-4)
        np.testing.assert_array_equal(r["random_centers"], want["random_centers"])
    counts, _ = communication.counts_displs(1_000_003, world)
    assert [int(r["lshape"][0]) for r in ranks] == list(counts)
