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
(its products are exact in f32). The flash backward, against each
gradient's largest magnitude: in f32 within 2e-5; in bf16 relative RMS
within 2e-3 and the largest error within 2^-6 (p and dS round to bf16 on
both sides, a value near a rounding boundary may go the other way);
fully masked rows give exactly 0. The int8 GEMM is bit-identical.
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


def _bwd_inputs(dev, b, t_q, t_k, h, d, dtype, causal, kv_valid):
    g = torch.Generator(device=dev).manual_seed(t_q + t_k + d)
    q, k, v, do = (torch.randn(s, generator=g, device=dev).to(dtype)
                   for s in ((b, t_q, h, d), (b, t_k, h, d), (b, t_k, h, d), (b, t_q, h, d)))
    scale = 1.0 / d ** 0.5
    o, lse = cuda_attention._flash_forward(q, k, v, scale, causal, kv_valid, return_lse=True)
    return q, k, v, o, lse, do, scale, causal, kv_valid


def _grads_close(got, want, dtype):
    for x, w in zip(got, want):
        assert x.shape == w.shape and x.dtype == w.dtype
        x, w = x.float(), w.float()
        peak = w.abs().max().item()
        if peak == 0.0:
            assert bool((x == 0).all())
        elif dtype == torch.float32:
            assert (x - w).abs().max().item() <= 2e-5 * peak
        else:
            assert ((x - w).norm() / w.norm()).item() <= 2e-3
            assert (x - w).abs().max().item() <= 2.0 ** -6 * peak


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [24, 64, 128])
@pytest.mark.parametrize("causal,kv_valid", [(False, 250), (True, 250), (True, 437), (False, 0)])
def test_flash_backward_kernels_match_plain(dev, dtype, d, causal, kv_valid):
    """K7a + K7b (two-pass) and K8 (fused) against the plain backward, on
    ragged T_q != T_k, ragged D and fully masked rows (kv_valid = 0)."""
    args = _bwd_inputs(dev, 2, 300, 437, 3, d, dtype, causal, kv_valid)
    q, k, v, o, lse, do, scale, causal, kv_valid = args
    want = cuda_attention.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                                    scale=scale, kv_valid=kv_valid)
    _grads_close(cuda_attention._flash_bwd(*args), want, dtype)
    _grads_close(cuda_attention._flash_bwd_fused(*args), want, dtype)


@pytest.mark.parametrize("d", [64, 128])
def test_flash_backward_repeats_bitwise(dev, d):
    """K7a and K7b sum in a fixed order: two runs agree bit for bit. K8's dK
    and dV do too; its dQ is a sum of f32 atomics and is not compared so."""
    args = _bwd_inputs(dev, 2, 512, 512, 4, d, torch.bfloat16, True, 512)
    for x, y in zip(cuda_attention._flash_bwd(*args), cuda_attention._flash_bwd(*args)):
        assert torch.equal(x, y)
    a, b = cuda_attention._flash_bwd_fused(*args), cuda_attention._flash_bwd_fused(*args)
    assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])


@pytest.mark.parametrize("impl", ["two_pass", "fused"])
def test_flash_backward_through_strided_views(dev, impl):
    """q, k and v as views of one (B, T, 3, H, D) tensor and a cotangent
    that is a transposed view: autograd hands the kernels strided tensors."""
    g = torch.Generator(device=dev).manual_seed(5)
    qkv = torch.randn((2, 200, 3, 4, 64), generator=g, device=dev).to(torch.bfloat16)
    cot = torch.randn((2, 4, 200, 64), generator=g, device=dev).to(torch.bfloat16).transpose(1, 2)
    leaf = qkv.detach().requires_grad_()
    q, k, v = leaf.unbind(2)
    cuda_attention.flash_attention(q, k, v, causal=True, bwd_impl=impl).backward(cot)
    q, k, v = qkv.unbind(2)
    o, lse = cuda_attention._flash_forward(q, k, v, 0.125, True, 200, return_lse=True)
    want = cuda_attention.flash_attention_bwd_plain(q, k, v, o, lse, cot, causal=True,
                                                    scale=0.125)
    _grads_close(leaf.grad.unbind(2), want, torch.bfloat16)


def test_flash_backward_rejects_mixed_dtypes(dev):
    args = list(_bwd_inputs(dev, 1, 64, 64, 1, 32, torch.bfloat16, True, 64))
    args[5] = args[5].float()
    with pytest.raises(ValueError, match="float32 or all bfloat16"):
        cuda_attention._flash_bwd(*args)


@pytest.mark.parametrize("impl", ["two_pass", "fused"])
def test_lm_training_step_launch_counts(dev, impl):
    """One remat training step of a small LM: K6 runs twice a layer (forward
    and recompute), and each layer's backward runs K7a and K7b, or K8."""
    layers = 3
    lm = htt.nn.TransformerLM(100, 64, 4, layers, max_len=128, attn_impl="flash", remat=True,
                              dtype=torch.bfloat16, flash_bwd_impl=impl, device=dev,
                              generator=torch.Generator(dev).manual_seed(0))
    opt = torch.optim.AdamW(lm.parameters(), lr=1e-3, weight_decay=1e-4)
    tokens = torch.randint(0, 100, (2, 128), device=dev,
                           generator=torch.Generator(dev).manual_seed(1))
    htt.reset_launch_counts()
    logits = lm(tokens)
    loss = torch.nn.functional.cross_entropy(logits[:, :-1].float().reshape(-1, 100),
                                             tokens[:, 1:].reshape(-1))
    loss.backward()
    opt.step()
    counts = htt.launch_counts()
    two_pass = impl == "two_pass"
    assert counts["flash_fwd"] == 2 * layers
    assert counts["flash_bwd_dq"] == counts["flash_bwd_dkv"] == (layers if two_pass else 0)
    assert counts["flash_bwd_fused"] == (0 if two_pass else layers)
    assert bool(torch.isfinite(loss)) and all(bool(torch.isfinite(p.grad).all())
                                              for p in lm.parameters())



# ------------------------------------------ the Hopper (wgmma) flash kernels

def _views(transposed, *tensors):
    """The same values behind (B, H, T, D) memory when ``transposed``."""
    if not transposed:
        return tensors
    return tuple(x.transpose(1, 2).contiguous().transpose(1, 2) for x in tensors)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kv_valid", [0, 250, 437])
@pytest.mark.parametrize("transposed", [False, True])
def test_hopper_flash_forward_matches_plain_and_old_kernel(dev, d, causal, kv_valid, transposed):
    """The wgmma forward on ragged T_q != T_k against the plain version (O
    within 2^-7 max|v|, the LSE within 1e-5 (1 + |lse|)) and against the
    mma.sync kernel it replaces (both round p to bf16, so they differ by a
    rounding of O, within the same tolerance), with every tile choice."""
    g = torch.Generator(device=dev).manual_seed(d + kv_valid)
    q, k, v = (torch.randn(s, generator=g, device=dev).to(torch.bfloat16)
               for s in ((2, 300, 3, d), (2, 437, 3, d), (2, 437, 3, d)))
    q, k, v = _views(transposed, q, k, v)
    assert cuda_attention._attention_variant(q.dtype, d, cuda_attention._strides(q, k, v),
                                             True) == "bf16_wgmma"
    scale = d ** -0.5
    o_p, lse_p = cuda_attention.flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                                      kv_valid=kv_valid, return_lse=True)
    o_old = cuda_attention._flash_forward(q, k, v, scale, causal, kv_valid, _old_kernel=True)
    tol = 2.0 ** -7 * v.float().abs().max()
    for tiles in (None, (64, 64), (64, 128), (128, 64), (128, 128)):
        o, lse = cuda_attention._flash_forward(q, k, v, scale, causal, kv_valid, return_lse=True,
                                               _tiles=tiles)
        assert o.shape == q.shape and o.is_contiguous()
        assert bool(((o.float() - o_p.float()).abs() <= tol).all()), tiles
        assert bool(((lse - lse_p).abs() <= 1e-5 * (1 + lse_p.abs())).all()), tiles
        assert bool(((o.float() - o_old.float()).abs() <= tol).all()), tiles
        if kv_valid == 0:
            assert bool((o == 0).all()) and bool((lse == 1e30).all())


@pytest.mark.parametrize("b,t,h,d", [(8, 1024, 16, 64), (1, 4096, 2, 128), (3, 40, 2, 128),
                                     (1, 1, 1, 64)])
def test_hopper_flash_forward_at_the_paths_shapes(dev, b, t, h, d):
    _flash_close(dev, b, t, t, h, d, torch.bfloat16, True, t)
    _flash_close(dev, b, t, t, h, d, torch.bfloat16, False, t)


def test_flash_forward_nonpositive_scale_takes_the_old_kernel(dev):
    """The wgmma forward folds a positive scale into its exponent; scale <= 0
    goes to the mma.sync kernel and still matches the plain version."""
    g = torch.Generator(device=dev).manual_seed(3)
    q, k, v = (torch.randn((2, 200, 2, 64), generator=g, device=dev).to(torch.bfloat16)
               for _ in range(3))
    for scale in (-0.125, 0.0):
        o = cuda_attention._flash_forward(q, k, v, scale, True, 200)
        o_p = cuda_attention.flash_attention_plain(q, k, v, causal=True, scale=scale, kv_valid=200)
        assert bool(((o.float() - o_p.float()).abs() <= 2.0 ** -7 * v.float().abs().max()).all())


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kv_valid", [0, 250, 437])
@pytest.mark.parametrize("transposed", [False, True])
def test_hopper_fused_backward_matches_plain_and_old_kernel(dev, d, causal, kv_valid, transposed):
    """The wgmma K8 (bulk reduce-add of dQ) on ragged T_q != T_k against the
    plain backward and against the mma.sync K8, each within the bf16
    tolerance; dK and dV bit-equal across two runs."""
    args = _bwd_inputs(dev, 2, 300, 437, 3, d, torch.bfloat16, causal, kv_valid)
    q, k, v, o, lse, do = _views(transposed, *args[:4]) + (args[4],) + _views(transposed, args[5])
    args = (q, k, v, o, lse, do) + args[6:]
    want = cuda_attention.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                                    scale=args[6], kv_valid=kv_valid)
    htt.reset_launch_counts()
    new = cuda_attention._flash_bwd_fused(*args)
    again = cuda_attention._flash_bwd_fused(*args)
    old = cuda_attention._flash_bwd_fused(*args, _old_kernel=True)
    assert htt.launch_counts()["flash_bwd_fused"] == 3
    assert new[0].is_contiguous()  # dQ is read back from the workspace in one pass
    _grads_close(new, want, torch.bfloat16)
    _grads_close(old, want, torch.bfloat16)
    assert torch.equal(new[1], again[1]) and torch.equal(new[2], again[2])
    _grads_close(again[:1], want[:1], torch.bfloat16)


@pytest.mark.parametrize("b,t,h,d", [(8, 1024, 16, 64), (1, 4096, 2, 128)])
def test_hopper_fused_backward_at_the_paths_shapes(dev, b, t, h, d):
    args = _bwd_inputs(dev, b, t, t, h, d, torch.bfloat16, True, t)
    q, k, v, o, lse, do, scale, causal, kv_valid = args
    want = cuda_attention.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                                    scale=scale, kv_valid=kv_valid)
    _grads_close(cuda_attention._flash_bwd_fused(*args), want, torch.bfloat16)


_DQ_TILES = {64: [(64, 64), (64, 128), (128, 64), (128, 128)], 128: [(128, 64)]}


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kv_valid", [1337, 900, 0])
@pytest.mark.parametrize("transposed", [False, True])
def test_hopper_two_pass_backward_matches_plain_and_old_kernel(dev, monkeypatch, d, causal,
                                                               kv_valid, transposed):
    """The wgmma K7a and K7b on ragged T_q != T_k (1000 x 1337) against the
    plain backward and against the mma.sync K7a and K7b (each within the
    bf16 tolerance), with every tile and ring choice the C entries take;
    dQ, dK and dV bit-equal across two runs."""
    args = _bwd_inputs(dev, 2, 1000, 1337, 3, d, torch.bfloat16, causal, kv_valid)
    q, k, v, o, lse, do = _views(transposed, *args[:4]) + (args[4],) + _views(transposed, args[5])
    args = (q, k, v, o, lse, do) + args[6:]
    assert cuda_attention._bwd_variant(q, k, v, do) == "bf16_wgmma"
    want = cuda_attention.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                                    scale=args[6], kv_valid=kv_valid)
    old = cuda_attention._flash_bwd(*args, _old_kernel=True)
    _grads_close(old, want, torch.bfloat16)
    for tiles in _DQ_TILES[d]:
        for stages in (2, 4):
            monkeypatch.setattr(cuda_attention, "_bwd_dq_tiles", lambda t_q, d_, _t=tiles: _t)
            monkeypatch.setattr(cuda_attention, "_bwd_dkv_stages", lambda d_, _s=stages: _s)
            htt.reset_launch_counts()
            new = cuda_attention._flash_bwd(*args)
            again = cuda_attention._flash_bwd(*args)
            counts = htt.launch_counts()
            assert counts["flash_bwd_dq"] == counts["flash_bwd_dkv"] == 2
            _grads_close(new, want, torch.bfloat16)
            _grads_close(new, old, torch.bfloat16)
            assert all(torch.equal(x, y) for x, y in zip(new, again)), (tiles, stages)


@pytest.mark.parametrize("b,t,h,d", [(8, 1024, 16, 64), (1, 4096, 2, 128), (3, 40, 2, 128),
                                     (1, 1, 1, 64)])
@pytest.mark.parametrize("causal", [False, True])
def test_hopper_two_pass_backward_at_the_paths_shapes(dev, b, t, h, d, causal):
    args = _bwd_inputs(dev, b, t, t, h, d, torch.bfloat16, causal, t)
    q, k, v, o, lse, do, scale, causal, kv_valid = args
    want = cuda_attention.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                                    scale=scale, kv_valid=kv_valid)
    got = cuda_attention._flash_bwd(*args)
    assert [x.shape for x in got] == [q.shape, k.shape, v.shape]
    _grads_close(got, want, torch.bfloat16)


def test_hopper_k7a_writes_d_and_takes_an_unaligned_o(dev):
    """The D that the wgmma K7a writes for K7b equals the plain prologue's
    rowsum(dO O) up to the order of its f32 sum; an O whose rows do not
    start on 16 bytes is copied first and gives the same gradients."""
    args = _bwd_inputs(dev, 2, 300, 437, 3, 64, torch.bfloat16, True, 437)
    q, k, v, o, lse, do, scale, causal, kv_valid = args
    dd = torch.full((2, 3, 300), float("nan"), device=dev)
    dq = torch.empty_like(q)
    cuda_attention._launch_dq_wgmma(q, k, v, do, o, lse, dd, dq, scale, causal, kv_valid,
                                    cuda_attention._bwd_dq_tiles(300, 64))
    want = cuda_attention._row_terms(o, do)
    size = (do.float() * o.float()).abs().sum(-1).transpose(1, 2)
    assert bool(((dd - want).abs() <= 1e-6 * size + 1e-30).all())
    flat = torch.empty(o.numel() + 8, dtype=o.dtype, device=dev)[1:-7]
    o_off = flat.view(o.shape).copy_(o)
    assert o_off.data_ptr() % 16 != 0
    got = cuda_attention._flash_bwd(q, k, v, o_off, lse, do, scale, causal, kv_valid)
    for x, y in zip(got, cuda_attention._flash_bwd(*args)):
        assert torch.equal(x, y)


def test_hopper_kernels_encode_tensor_maps_on_a_fresh_thread(dev):
    """A thread that has launched nothing has no current CUDA context,
    which the tensor-map encoder needs (autograd's device threads run the
    backward so): the Hopper forward and two-pass backward still run there,
    on inputs whose maps were never encoded, and match the main thread's."""
    import threading

    args = _bwd_inputs(dev, 1, 192, 160, 2, 64, torch.bfloat16, True, 160)
    out = {}

    def work():
        try:
            out["grads"] = cuda_attention._flash_bwd(*args)
            torch.cuda.synchronize()
        except Exception as e:  # re-raised on the test's thread
            out["error"] = e

    worker = threading.Thread(target=work)
    worker.start()
    worker.join()
    if "error" in out:
        raise out["error"]
    for x, y in zip(out["grads"], cuda_attention._flash_bwd(*args)):
        assert torch.equal(x, y)


def test_auto_backward_takes_the_fused_kernel_where_the_rule_says(dev):
    """bwd_impl="auto" resolves by the port's rule and launches that kernel."""
    g = torch.Generator(device=dev).manual_seed(9)
    for t, d in ((128, 64), (512, 64), (128, 32), (512, 32)):
        leaves = [torch.randn((1, t, 2, d), generator=g, device=dev).to(torch.bfloat16)
                  .requires_grad_() for _ in range(3)]
        want = cuda_attention._resolve_bwd_impl("auto", t, cuda_attention._bwd_variant(
            *leaves, leaves[0]))
        assert want == ("fused" if d == 32 and t <= 256 else "two_pass")
        htt.reset_launch_counts()
        cuda_attention.flash_attention(*leaves, causal=True, bwd_impl="auto").sum().backward()
        counts = htt.launch_counts()
        assert (counts["flash_bwd_fused"] == 1) == (want == "fused"), (t, d, counts)
        assert (counts["flash_bwd_dq"] == 1) == (want == "two_pass"), (t, d, counts)


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
