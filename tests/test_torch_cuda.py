"""heat_tpu_torch's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA card and skips without one. The file imports
neither jax nor heat_tpu, so that it runs on a machine that has only
PyTorch; there, run it without the suite's jax conftest:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerances, as in chip_smoke.py: moments mean within 1e-5 of the column's
spread, M2 1e-4 relative; cdist squared distances within 2e-5 of
|x|^2 + |y|^2 (the error scale of an f32 GEMM-form expansion), rbf the
same times gamma, each kernel against the plain version of its
HEAT_TPU_CDIST_PREC tier (one TF32 pass also against exact f32 at 2e-3 of
|x|^2 + |y|^2), two runs bit-identical, the streamed exact kernel bit-identical to
cdist_kernel; Lloyd counts exact on separated blobs, sums within 1e-4
of the sum of |x|, and two runs bit-identical (both kernels). Flash attention: in f32, O
within 2e-5 max|v| (both sum exact-f32 products in other orders); in bf16,
O within 2^-7 max|v| (each output is rounded to bf16, one ulp of
|O| <= max|v| is 2^-8 max|v|, and a probability near a bf16 rounding
boundary may round the other way); the LSE within 1e-5 (1 + |lse|) in both
(its products are exact in f32). The flash backward, against each
gradient's largest magnitude: in f32 within 2e-5; in bf16 relative RMS
within 2e-3 and the largest error within 2^-6 (p and dS round to bf16 on
both sides, a value near a rounding boundary may go the other way);
fully masked rows give exactly 0. The int8 GEMM is bit-identical, both
kernels. The sparse products on the card against the CPU port: structure,
integer, ``pattern`` and min/max results bit for bit, float sums (cuSPARSE)
within 1e-5 of the largest |value|.
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


def _cdist_worst(out_k, out_p, x, y, gamma, epilogue, rel=2e-5):
    """The largest error over its tolerance: on d2, rel (|x|^2 + |y|^2) + 1e-6;
    for rbf the same times gamma."""
    scale = (x * x).sum(1)[:, None] + (y * y).sum(1)[None, :]
    lhs = (out_k - out_p).abs() if epilogue == "rbf" else (out_k ** 2 - out_p ** 2).abs()
    limit = (gamma if epilogue == "rbf" else 1.0) * (rel * scale + 1e-6)
    return (lhs / limit).max().item()


@pytest.mark.parametrize("m,n,k", [(1000, 999, 127), (129, 4097, 512), (1, 1, 1), (1000, 999, 124),
                                   (4, 4, 4), (16000, 15999, 128)])
@pytest.mark.parametrize("epilogue", ["dist", "rbf"])
def test_cdist_kernel_matches_plain(dev, m, n, k, epilogue):
    """The kernel the gate picks (3xTF32 for k % 4 == 0, else the streamed
    f32 FMAs) against the plain version of the default strategy; two runs
    bit-identical."""
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.rand((m, k), generator=g, device=dev)
    y = torch.rand((n, k), generator=g, device=dev)
    gamma = 0.5 / k
    out_k = cuda_cdist.euclid(x, y, gamma, epilogue)
    assert cuda_cdist.last_variant() == ("3xtf32_wgmma" if k % 4 == 0 else "f32_fma_stream")
    out_p = cuda_cdist.euclid_plain(x, y, gamma, epilogue, "bf16x3")
    assert _cdist_worst(out_k, out_p, x, y, gamma, epilogue) <= 1.0
    assert torch.equal(out_k, cuda_cdist.euclid(x, y, gamma, epilogue))


@pytest.mark.parametrize("value,variant,plain", [
    (None, "3xtf32_wgmma", "bf16x3"), ("bf16x3", "3xtf32_wgmma", "bf16x3"),
    ("high", "3xtf32_wgmma", "HIGH"), ("default", "tf32_wgmma", "DEFAULT"),
    ("highest", "f32_fma_stream", "HIGHEST"), ("fastest", "3xtf32_wgmma", "bf16x3")])
def test_cdist_strategy_selects_the_kernel(dev, monkeypatch, value, variant, plain):
    """HEAT_TPU_CDIST_PREC, read at call time: each value's kernel against
    the plain version of its tier; one TF32 pass also against exact f32 at
    2e-3 (|x|^2 + |y|^2) (TF32 truncation, <= 2^-10 relative an operand);
    an unknown value warns and keeps bf16x3."""
    if value is None:
        monkeypatch.delenv("HEAT_TPU_CDIST_PREC", raising=False)
    else:
        monkeypatch.setenv("HEAT_TPU_CDIST_PREC", value)
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.rand((3000, 128), generator=g, device=dev)
    y = torch.rand((2000, 128), generator=g, device=dev)
    if value == "fastest":
        with pytest.warns(UserWarning, match="keeping the bf16x3 default"):
            out_k = cuda_cdist.euclid(x, y)
    else:
        out_k = cuda_cdist.euclid(x, y)
    assert cuda_cdist.last_variant() == variant
    assert _cdist_worst(out_k, cuda_cdist.euclid_plain(x, y, precision=plain), x, y, 0.0,
                        "dist") <= 1.0
    if plain == "DEFAULT":
        exact = cuda_cdist.euclid_plain(x, y, precision="HIGHEST")
        assert _cdist_worst(out_k, exact, x, y, 0.0, "dist", rel=2e-3) <= 1.0


@pytest.mark.parametrize("precision", ["bf16x3", "DEFAULT", "HIGHEST"])
def test_cdist_self_distance_diagonal(dev, precision):
    """x = y: every out[i, i] <= sqrt(2e-5 * 2 |x_i|^2 + 1e-6) in 3xTF32 and
    f32 (one TF32 pass: 2e-3), the rest within the tier's tolerance."""
    g = torch.Generator(device=dev).manual_seed(6)
    x = torch.rand((5000, 128), generator=g, device=dev)
    out = cuda_cdist.euclid(x, x, precision=precision)
    rel = 2e-3 if precision == "DEFAULT" else 2e-5
    assert bool((out.diagonal() <= torch.sqrt(rel * 2 * (x * x).sum(1) + 1e-6)).all())
    assert _cdist_worst(out, cuda_cdist.euclid_plain(x, x, precision=precision), x, x, 0.0,
                        "dist") <= 1.0
    assert torch.equal(out, cuda_cdist.euclid(x, x, precision=precision))


def test_cdist_unaligned_data_takes_the_fma_kernel(dev):
    """x's data one float past a 16-byte boundary: no bulk copy can read it,
    so the exact f32 FMA kernel runs by the gate, with cdist_kernel's bits."""
    g = torch.Generator(device=dev).manual_seed(7)
    m, n, k = 777, 555, 128
    x = torch.rand((m * k + 1,), generator=g, device=dev)[1:].view(m, k)
    y = torch.rand((n, k), generator=g, device=dev)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    out_k = cuda_cdist.euclid(x, y)
    assert cuda_cdist.last_variant() == "f32_fma_stream"
    assert _cdist_worst(out_k, cuda_cdist.euclid_plain(x, y), x, y, 0.0, "dist") <= 1.0
    assert torch.equal(out_k, cuda_cdist.euclid(x, y, _old_kernel=True))


def _cdist_span_variants(fn):
    """fn's result and the ``variant`` of each ``pallas_cdist`` span its
    calls record, telemetry on for the call (and as it was after it)."""
    reg = htt.telemetry.get_registry()
    was = htt.telemetry.enabled()
    start = len(reg.events)
    htt.telemetry.enable()
    try:
        out = fn()
    finally:
        if not was:
            htt.telemetry.disable()
    return out, [e.get("variant") for e in reg.events[start:]
                 if e["kind"] == "span" and e["name"] == "pallas_cdist"]


@pytest.mark.parametrize("k", [1, 3, 17, 18, 31, 32, 33, 64, 127, 128, 512])
@pytest.mark.parametrize("case", ["bulk", "guarded", "same", "misaligned", "wide", "special"])
@pytest.mark.parametrize("epilogue", ["dist", "rbf"])
def test_cdist_stream_kernel_matches_the_tile_kernel_bitwise(dev, k, case, epilogue):
    """The streamed exact kernel against cdist_kernel through the library
    (``_old_kernel=True``), bit for bit, at k <= 32 (a tile's features
    staged whole) and past it (panels of 32): m and n no multiples of 128
    and more tiles than the persistent grid's blocks; n % 4 == 0 (the bulk
    stores), n % 4 == 2 (the guarded stores), x is y, x a view one float
    past a 16-byte boundary, more column tiles than the grid's blocks
    (a block's consecutive tiles share a row tile and keep its staged rows),
    and rows off the epilogue's fast path: a norm between 2^125 and the
    largest float, one that overflows, a NaN and an inf feature, a y row
    equal to an x row (d2 = 0). Two calls bit-identical; the call's
    ``pallas_cdist`` span names the streamed variant."""
    g = torch.Generator(device=dev).manual_seed(100 * k + len(case))
    m, n = {"guarded": (3001, 4102), "wide": (259, 40_004)}.get(case, (3001, 4100))
    if case == "misaligned":
        x = torch.randn((m * k + 1,), generator=g, device=dev)[1:].view(m, k)
        assert x.is_contiguous() and x.data_ptr() % 16 != 0
    else:
        x = torch.randn((m, k), generator=g, device=dev)
    y = x if case == "same" else torch.randn((n, k), generator=g, device=dev)
    if case == "special":
        x[5] *= 2.0 ** 70
        x[6] = 2.0 ** 62 / k ** 0.5
        x[7, 0] = float("nan")
        x[8, k - 1] = float("inf")
        y[3] = x[3]
    gamma = 0.5 / k
    out, variants = _cdist_span_variants(
        lambda: cuda_cdist.euclid(x, y, gamma, epilogue, precision="HIGHEST"))
    assert cuda_cdist.last_variant() == "f32_fma_stream" and variants == ["f32_fma_stream"]
    old = cuda_cdist.euclid(x, y, gamma, epilogue, _old_kernel=True)
    assert cuda_cdist.last_variant() == "f32_fma"
    assert out.shape == (m, y.shape[0]) and torch.equal(out, old)
    assert torch.equal(out, cuda_cdist.euclid(x, y, gamma, epilogue, precision="HIGHEST"))


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


@pytest.mark.parametrize("n,d,k", [(2_000_000, 64, 64), (20_011, 512, 1024), (5_000, 64, 1),
                                   (70_001, 36, 100)])
def test_lloyd_tc_kernel_matches_plain_and_old(dev, n, d, k):
    """The tensor-core kernel (d % 4 == 0) at the main path's shape, at the
    gate's corner (the centers staged again for every tile), at k = 1 and
    at a d that is no multiple of 32: counts equal to the plain version's
    and the old kernel's, sums within the tolerance, two runs bit-identical."""
    g = torch.Generator(device=dev).manual_seed(n + d + k)
    protos = torch.randn((k, d), generator=g, device=dev) * 8
    lab = torch.randint(0, k, (n,), generator=g, device=dev)
    x = protos[lab] + torch.randn((n, d), generator=g, device=dev)
    s_k, n_k = cuda_lloyd.lloyd_update(x, protos)
    s_p, n_p = cuda_lloyd.lloyd_update_plain(x, protos)
    s_o, n_o = cuda_lloyd.lloyd_update(x, protos, _old_kernel=True)
    assert torch.equal(n_k, n_p) and torch.equal(n_k, n_o)
    abs_sums = torch.zeros_like(protos).index_add_(0, torch.argmin(torch.cdist(x, protos), 1), x.abs())
    assert bool(((s_k - s_p).abs() <= 1e-4 * abs_sums + 1e-5).all())
    s_k2, n_k2 = cuda_lloyd.lloyd_update(x, protos)
    assert torch.equal(s_k, s_k2) and torch.equal(n_k, n_k2)


def test_lloyd_off_the_tc_gate_takes_the_old_kernel(dev):
    """d % 4 != 0: a row stride the bulk copies cannot take; the same kernel
    runs whatever the switch says."""
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((10_007, 33), generator=g, device=dev)
    c = torch.randn((17, 33), generator=g, device=dev)
    s_k, n_k = cuda_lloyd.lloyd_update(x, c)
    s_o, n_o = cuda_lloyd.lloyd_update(x, c, _old_kernel=True)
    assert torch.equal(s_k, s_o) and torch.equal(n_k, n_o)


def test_kmeans_on_card_leaves_the_tf32_flag_as_it_was(dev):
    g = torch.Generator(device=dev).manual_seed(4)
    htt.use_device(None)
    x = htt.array(torch.randn((5000, 16), generator=g, device=dev), split=0)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        km = htt.cluster.KMeans(n_clusters=4, init="random", random_state=0, max_iter=10).fit(x)
        assert torch.backends.cuda.matmul.allow_tf32 is True
        km.predict(x)
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.parametrize("k,old", [(3, False), (4, False), (33, False), (3, True)],
                         ids=["3", "4", "33", "3-old"])
def test_cdist_kernel_past_65535_row_tiles(dev, k, old):
    """More 128-row tiles of x than a grid's y dimension takes, in every
    kernel (k = 3: streamed f32 FMAs; k = 4: 3xTF32, n % 4 != 0; k = 33:
    streamed, two feature panels; old: cdist_kernel, with the streamed
    kernel's bits)."""
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.rand((65535 * 128 + 5, k), generator=g, device=dev)
    y = torch.rand((2, k), generator=g, device=dev)
    out_k = cuda_cdist.euclid(x, y, _old_kernel=old)
    assert cuda_cdist.last_variant() == (
        "f32_fma" if old else "3xtf32_wgmma" if k == 4 else "f32_fma_stream")
    if old:
        assert torch.equal(out_k, cuda_cdist.euclid(x, y))
    out_p = cuda_cdist.euclid_plain(x, y, precision="bf16x3")
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
    assert cuda_cdist.last_variant() == "3xtf32_wgmma"
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
    want = cuda_quant.int8_gemm_plain(qa, sa, qb, sb)
    assert torch.equal(cuda_quant.int8_gemm(qa, sa, qb, sb), want)
    assert torch.equal(cuda_quant.int8_gemm(qa, sa, qb, sb, _old_kernel=True), want)


@pytest.mark.parametrize("m,n,k", [(8192, 8192, 8192), (8192, 4096, 1024), (1000, 777, 1040),
                                   (129, 300, 16)])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_int8_wgmma_kernel_bit_identical_to_plain_and_old(dev, m, n, k, out_dtype):
    """The wgmma kernel (K % 16 == 0) at the W8A8 chain's 8192^3, QuantDense's
    8192 tokens x 1024 -> 4096, and ragged M and N with K % 128 != 0."""
    g = torch.Generator(device=dev).manual_seed(m + n + k)
    qa, sa = quantize_int8(torch.randn((m, k), generator=g, device=dev), axis=1)
    qb, sb = quantize_int8(torch.randn((k, n), generator=g, device=dev), axis=0)
    htt.reset_launch_counts()
    got = cuda_quant.int8_gemm(qa, sa, qb, sb, out_dtype)
    assert htt.launch_counts()["int8_gemm"] == 1
    assert got.dtype == out_dtype and torch.equal(got, cuda_quant.int8_gemm_plain(qa, sa, qb, sb,
                                                                                  out_dtype))
    assert torch.equal(got, cuda_quant.int8_gemm(qa, sa, qb, sb, out_dtype, _old_kernel=True))


def test_int8_kernel_refuses_a_k_past_the_exact_accumulator(dev):
    k = 2 ** 31 // 128 ** 2  # 128^2 K reaches 2^31
    qa = torch.ones((1, k), dtype=torch.int8, device=dev)
    qb = torch.ones((k, 1), dtype=torch.int8, device=dev)
    ones = torch.ones((1, 1), device=dev)
    with pytest.raises(ValueError, match="int32 accumulator"):
        cuda_quant.int8_gemm(qa, ones, qb, ones)


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


RANDOM_SLICES = [((1000, 7), None, 0, None), ((10, 3), 0, 7, 3), ((4, 37, 11), 1, 5, 9),
                 ((3, 5, 2), 2, 1, 1), ((123457,), 0, 1000, 5000), ((2_000_001, 3), 0, 0, 1)]


@pytest.mark.parametrize("epilogue", ["bits32", "bits64", "uniform_f32", "normal_f32"])
@pytest.mark.parametrize("shape,split,start,length", RANDOM_SLICES)
def test_random_kernel_matches_plain(dev, epilogue, shape, split, start, length):
    """The threefry kernel bit for bit against its plain version on the
    card: the same counters, the same rounded float operations (no FMA
    contraction on either side), the same log1pf."""
    from heat_tpu_torch.core import _threefry as tf, cuda_random

    key = tf.fold_in(tf.prng_key(9), 4)
    sl = tf.Slice(shape, split, start, length)
    before = htt.launch_counts()["random"]
    got = cuda_random.draw(key, sl, epilogue, -2.5, 7.25, device=dev)
    torch.cuda.synchronize()
    assert htt.launch_counts()["random"] == before + 1
    want = tf.draw_plain(key, sl, epilogue, -2.5, 7.25, device=dev)
    assert got.shape == want.shape == sl.shape and got.dtype == want.dtype and got.is_cuda
    if got.is_floating_point():
        got, want = got.view(torch.int32), want.view(torch.int32)
    assert torch.equal(got, want)


def test_random_golden_values_on_card(dev):
    """The card's draws give the golden values that chip_smoke.py embeds
    (pinned against the JAX package in test_torch_random.py)."""
    import importlib.util

    from heat_tpu_torch.core import _threefry as tf, cuda_random

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    rows, cols = smoke.GOLDEN_RANDN_SHAPE
    key = tf.fold_in(tf.prng_key(0), 0)
    first = cuda_random.draw(key, tf.Slice((rows, cols), 0, 0, 1), "normal_f32", device=dev)
    last = cuda_random.draw(key, tf.Slice((rows, cols), 0, rows - 1, 1), "normal_f32",
                            device=dev)
    got = torch.cat([first.reshape(-1)[:4], last.reshape(-1)[-4:]]).cpu()
    gold = torch.tensor(smoke.GOLDEN_RANDN_FIRST4 + smoke.GOLDEN_RANDN_LAST4)
    assert (got.view(torch.int32).long() - gold.view(torch.int32).long()).abs().max() <= 4
    idx = tf.choice(tf.prng_key(1), smoke.GOLDEN_KMEANS_ROWS_OF[0], (64,), replace=False,
                    device=dev, draw=cuda_random.draw)
    assert idx.cpu().tolist() == smoke.GOLDEN_KMEANS_ROWS
    htt.use_device(None)
    htt.random.seed(0)
    ints = htt.random.randint(0, 8, (8192, 1))
    assert ints.larray.is_cuda and ints.larray.reshape(-1)[:16].cpu().tolist() == \
        smoke.GOLDEN_RANDINT_FIRST16


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
    # ht.random: each rank draws its own chunk of the global stream
    ht.random.seed(3)
    res["draw_rand_0"] = ht.random.rand(1_000_003, 7, split=0).numpy()
    res["draw_randn_1"] = ht.random.randn(33, 1001, split=1).numpy()
    res["draw_randint_0"] = ht.random.randint(-7, 2 ** 40, (100_003,), dtype=ht.int64,
                                              split=0).numpy()
    res["draw_permutation_0"] = ht.random.permutation(ht.array(xc, split=0)).numpy()
    return res
"""

_WORKER_HEAD = """
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
"""
_WORKER_TAIL = """
res = run(ht, torch.device("cuda", rank) if backend == "nccl" else torch.device("cpu"))
np.savez(f"{out}/rank{rank}.npz", **res)
dist.barrier()
dist.destroy_process_group()
"""


def _spmd_ranks(tmp_path, world, backend, data=_DATA):
    """Run ``data``'s ``run(ht, device)`` on ``world`` ranks; returns each
    rank's saved results."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    repo = Path(__file__).resolve().parent.parent
    worker = _WORKER_HEAD + data + _WORKER_TAIL
    procs = [subprocess.Popen([sys.executable, "-c", worker, str(r), str(world), str(port),
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
    must give the world-of-one results of this process, and the random
    draws split 0 and 1 (and ``permutation`` of a split array) its arrays
    bit for bit."""
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
        for name in ("draw_rand_0", "draw_randn_1", "draw_randint_0", "draw_permutation_0"):
            np.testing.assert_array_equal(r[name], want[name])
    counts, _ = communication.counts_displs(1_000_003, world)
    assert [int(r["lshape"][0]) for r in ranks] == list(counts)


_LINALG_DATA = """
import numpy as np
import torch

def make_linalg_data():
    g = torch.Generator().manual_seed(1)
    return {name: torch.randn(shape, generator=g) for name, shape in (
        ("a", (1001, 517)), ("b", (517, 301)), ("x", (1003, 257)), ("t", (4001, 64)),
        ("w", (100, 300)))}

def run(ht, device):
    torch.backends.cuda.matmul.allow_tf32 = False
    d = {k: v.to(device) for k, v in make_linalg_data().items()}
    res = {}
    def keep(name, x):
        res[name] = x.numpy()
        res[name + "_split"] = np.array(-1 if x.split is None else x.split)
        res[name + "_lshape"] = np.array(x.lshape)
    for sa in (None, 0, 1):
        for sb in (None, 0, 1):
            keep(f"mm_{sa}_{sb}", ht.array(d["a"], split=sa) @ ht.array(d["b"], split=sb))
    for s0, s1 in ((0, 1), (1, 0)):
        keep(f"resplit_{s0}{s1}", ht.array(d["x"], split=s0).resplit(s1))
    for name, split in (("tsqr", 0), ("cholqr", 1)):
        q, r = ht.linalg.qr(ht.array(d["t"], split=split))
        keep(name + "_Q", q)
        keep(name + "_R", r)
        u, s, v = ht.linalg.svd(ht.array(d["t"], split=split))
        keep(name + "_U", u)
        keep(name + "_S", s)
        keep(name + "_V", v)
    for split in (0, 1):
        q, r = ht.linalg.qr(ht.array(d["w"], split=split))
        keep(f"wide{split}_Q", q)
        keep(f"wide{split}_R", r)
    return res
"""


def _sign_normalised(q, r):
    s = np.sign(np.diagonal(r))
    s[s == 0] = 1
    return q * s[None, :], r * s[:, None]


def test_nccl_linalg_ranks_match_world_of_one(dev, tmp_path):
    """Every card one rank over NCCL: matmul in every split pair (f32, TF32
    off; the partials summed in another order: within 1e-5 of the result's
    largest magnitude), resplit 0 <-> 1 (exact), TSQR and CholeskyQR2 qr (Q
    and R after sign normalisation within 1e-4, Q R within 1e-5 of |A|, Q^T Q
    within 1e-5 of I) and svd (S within 1e-5 relative, U S V^T within 1e-5
    of |A|), each against the world of one of this process, with the JAX
    package's splits and the ceil rule's local shapes."""
    world = torch.cuda.device_count()
    if world < 2:
        pytest.skip("needs two or more CUDA cards")
    ranks = _spmd_ranks(tmp_path, world, "nccl", _LINALG_DATA)
    ns = {}
    exec(_LINALG_DATA, ns)
    htt.use_device(None)
    want = ns["run"](htt, dev)
    data = {k: v.numpy().astype(np.float64) for k, v in ns["make_linalg_data"]().items()}
    splits = {(None, None): -1, (None, 0): 0, (None, 1): 1, (0, None): 0, (0, 0): 0, (0, 1): 0,
              (1, None): 0, (1, 0): 0, (1, 1): 0}
    for rank, r in enumerate(ranks):
        for (sa, sb), split in splits.items():
            name = f"mm_{sa}_{sb}"
            assert int(r[name + "_split"]) == split
            scale = np.abs(want[name]).max()
            np.testing.assert_allclose(r[name], want[name], rtol=0, atol=1e-5 * scale)
            if split >= 0:
                lshape = communication.chunk(want[name].shape, split, rank, world)[1]
                assert tuple(r[name + "_lshape"]) == lshape
        for s0, s1 in ((0, 1), (1, 0)):
            name = f"resplit_{s0}{s1}"
            np.testing.assert_array_equal(r[name], data["x"].astype(np.float32))
            assert tuple(r[name + "_lshape"]) == communication.chunk((1003, 257), s1, rank, world)[1]
        for name, a, q_split, r_split in (("tsqr", data["t"], 0, -1), ("cholqr", data["t"], 1, 1),
                                          ("wide0", data["w"], 0, 0), ("wide1", data["w"], 1, 1)):
            q, rr = r[name + "_Q"], r[name + "_R"]
            assert (int(r[name + "_Q_split"]), int(r[name + "_R_split"])) == (q_split, r_split)
            np.testing.assert_allclose(q @ rr, a, rtol=0, atol=1e-5 * np.abs(a).max())
            np.testing.assert_allclose(q.T @ q, np.eye(q.shape[1]), rtol=0, atol=1e-5)
            gq, gr = _sign_normalised(q, rr)
            wq, wr = _sign_normalised(want[name + "_Q"], want[name + "_R"])
            np.testing.assert_allclose(gq, wq, rtol=0, atol=1e-4)
            np.testing.assert_allclose(gr, wr, rtol=0, atol=1e-4 * np.abs(wr).max())
        for name in ("tsqr", "cholqr"):
            u, s, v = r[name + "_U"], r[name + "_S"], r[name + "_V"]
            np.testing.assert_allclose(s, want[name + "_S"], rtol=1e-5, atol=1e-5 * s.max())
            np.testing.assert_allclose((u * s) @ v.T, data["t"], rtol=0,
                                       atol=1e-5 * np.abs(data["t"]).max())


_MANIP_DATA = """
import numpy as np
import torch

def make_manip_data():
    g = torch.Generator().manual_seed(2)
    x = torch.round(torch.randn((100_003, 16), generator=g) * 4)  # ties
    ints = torch.randint(0, 1000, (100_003,), generator=g)
    rows = torch.randint(0, 3, (20_001, 2), generator=g)
    idx = torch.randint(-100_003, 100_003, (5_000,), generator=g)
    return x, ints, rows, idx

def run(ht, device):
    x_t, ints_t, rows_t, idx_t = (t.to(device) for t in make_manip_data())
    res = {}
    def keep(name, x):
        if isinstance(x, (tuple, list)):
            for j, part in enumerate(x):
                keep(f"{name}.{j}", part)
            return
        res[name] = x.numpy()
        res[name + "_split"] = np.array(-1 if x.split is None else x.split)
        res[name + "_lshape"] = np.array(x.lshape)
    x, ints = ht.array(x_t, split=0), ht.array(ints_t, split=0)
    keep("sort", ht.sort(x, axis=0))
    keep("sort_desc", ht.sort(x, axis=0, descending=True))
    keep("topk", ht.topk(x, 50, dim=0))
    keep("unique", ht.unique(ints, return_inverse=True))
    keep("unique_rows", ht.unique(ht.array(rows_t, split=0), return_inverse=True, axis=0))
    keep("percentile", ht.percentile(x, [1, 33.3, 50, 99.9], axis=0))
    keep("get_step", x[5::7])
    keep("get_negstep", x[::-3])
    keep("get_int", x[77_777])
    keep("get_idx", x[ht.array(idx_t)])
    keep("get_mask", x[x > 3])
    keep("get_rows", x[x[:, 0] > 0])
    y = ht.array(x_t, split=0)
    y[10:90_010] = ht.array(x_t[:90_000] * 2, split=1)
    keep("set_split_value", y)
    y = ht.array(x_t, split=0)
    y[y > 2] = 0
    keep("set_mask", y)
    keep("concat", ht.concatenate([x, x[:1001], ht.array(x_t[:7], split=None)], axis=0))
    keep("reshape", ht.reshape(x, (16, 100_003), new_split=1))
    keep("flip", ht.flip(x, 0))
    keep("roll", ht.roll(x, 40_000, 0))
    keep("nonzero", ht.nonzero(ints < 3))
    return res
"""


def test_nccl_manipulations_ranks_match_world_of_one(dev, tmp_path):
    """Every card one rank over NCCL: sort both ways, topk, unique (flat
    and rows, with the inverse), percentile, getitem (steps, an int, an
    index vector, masks), setitem (a value split along the other axis, a
    mask), concatenate, reshape with new_split, flip, roll and nonzero give
    the world of one's results exactly, each on the ceil-rule chunks of the
    JAX package's split."""
    world = torch.cuda.device_count()
    if world < 2:
        pytest.skip("needs two or more CUDA cards")
    ranks = _spmd_ranks(tmp_path, world, "nccl", _MANIP_DATA)
    _hold_manip_ranks(ranks, world, dev)


def _hold_manip_ranks(ranks, world, dev):
    ns = {}
    exec(_MANIP_DATA, ns)
    want = ns["run"](htt, dev)
    names = [k for k in want if not k.endswith(("_split", "_lshape"))]
    for rank, r in enumerate(ranks):
        for name in names:
            np.testing.assert_array_equal(r[name], want[name], err_msg=f"{name}, rank {rank}")
            split = int(want[name + "_split"])
            assert int(r[name + "_split"]) == split, name
            if split >= 0:
                lshape = communication.chunk(want[name].shape, split, rank, world)[1]
                assert tuple(r[name + "_lshape"]) == lshape, (name, rank)


def test_matmul_honours_the_callers_tf32_flag(dev):
    """matmul reads torch.backends.cuda.matmul.allow_tf32 and sets nothing.
    Errors against float64 over sum |a||b|: off, f32 accumulation, within
    2^-16; on, TF32 operands (2^-11 relative each, rounded), within 2^-9
    and measurably above the f32 error."""
    g = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn((1024, 2048), generator=g, device=dev)
    b = torch.randn((2048, 1024), generator=g, device=dev)
    ref = a.double() @ b.double()
    scale = a.abs().double() @ b.abs().double()
    flags = torch.backends.cuda.matmul
    caller = flags.allow_tf32
    try:
        errs = {}
        for on in (False, True):
            flags.allow_tf32 = on
            got = (htt.array(a, split=0) @ htt.array(b, split=0)).larray
            assert flags.allow_tf32 is on
            errs[on] = ((got.double() - ref).abs() / scale).max().item()
    finally:
        flags.allow_tf32 = caller
    assert errs[False] <= 2.0 ** -16, errs
    assert errs[True] <= 2.0 ** -9, errs
    assert errs[True] > 4 * errs[False], errs


def test_matmul_bf16_accumulates_in_f32(dev):
    """A bf16 product at K = 16384 within one bf16 rounding of its output
    (2^-8 |ref|) plus 2^-20 sum |a||b| of float64 on the same bf16 inputs,
    with torch's reduced-precision flag cleared for the product and the
    caller's value restored."""
    g = torch.Generator(device=dev).manual_seed(1)
    a = torch.randn((256, 16384), generator=g, device=dev).bfloat16()
    b = torch.randn((16384, 256), generator=g, device=dev).bfloat16()
    flags = torch.backends.cuda.matmul
    caller = flags.allow_bf16_reduced_precision_reduction
    try:
        flags.allow_bf16_reduced_precision_reduction = True
        got = (htt.array(a, split=0) @ htt.array(b)).larray
        assert flags.allow_bf16_reduced_precision_reduction is True
    finally:
        flags.allow_bf16_reduced_precision_reduction = caller
    assert got.dtype == torch.bfloat16
    ref = a.double() @ b.double()
    scale = a.abs().double() @ b.abs().double()
    assert bool(((got.double() - ref).abs() <= 2.0 ** -8 * ref.abs() + 2.0 ** -20 * scale).all())


@pytest.mark.parametrize("dtype", ["bool", "int8", "int32", "int64", "uint8", "uint32"])
def test_exact_products_on_card(dev, dtype):
    """matmul and dot of bool and the integer types on the card (torch's
    CUDA GEMM has none) equal numpy's, wrapping as the type does."""
    rng = np.random.default_rng(3)
    if dtype == "bool":
        a, b = (rng.integers(0, 2, (300, 257)).astype(bool), rng.integers(0, 2, (257, 129))
                .astype(bool))
    else:
        info = np.iinfo(dtype)
        a, b = (rng.integers(info.min, info.max, s, dtype=dtype, endpoint=True)
                for s in ((300, 257), (257, 129)))
    htt.use_device(None)
    got = (htt.array(a) @ htt.array(b)).numpy()
    got_dot = htt.dot(htt.array(a[0]), htt.array(b[:, 0])).numpy()
    with np.errstate(over="ignore"):
        want = (a.astype(np.int64) @ b.astype(np.int64)) > 0 if dtype == "bool" else a @ b
        want_dot = np.dot(a[0].astype(np.int64), b[:, 0].astype(np.int64)) > 0 \
            if dtype == "bool" else np.dot(a[0], b[:, 0])
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_dot, want_dot)


@pytest.mark.parametrize("dtype", ["uint16", "uint32", "uint64"])
def test_wide_unsigned_operations_on_card(dev, dtype):
    """uint16, uint32 and uint64 on the card, values past 2^31 and 2^63:
    each operation equals numpy's (cumsum in the type)."""
    info = np.iinfo(dtype)
    rng = np.random.default_rng(4)
    a, b = (rng.integers(0, info.max, (301, 33), dtype=dtype, endpoint=True) for _ in range(2))
    a[0, 0], a[1, 1] = info.max, 2 ** (info.bits - 1) + 5
    htt.use_device(None)
    x, y = htt.array(a, split=0), htt.array(b, split=0)
    with np.errstate(over="ignore"):
        cases = [((x + y), a + b), ((x * y), a * b), ((x > 2), a > 2), (x[x > 2], a[a > 2]),
                 (htt.max(x), a.max()), (htt.argmax(x), a.argmax()),
                 (htt.min(x, axis=0), a.min(axis=0)), (htt.cumsum(x, 0), np.cumsum(a, 0, dtype=a.dtype)),
                 (x // (y | 1), a // (b | 1)), (x % (y | 1), a % (b | 1)), (x >> 3, a >> 3),
                 (htt.sort(x, axis=0)[0], np.sort(a, axis=0)),
                 (htt.where(x > y, x, y), np.where(a > b, a, b)),
                 (x.astype(htt.float64), a.astype(np.float64))]
    for got, want in cases:
        got = got.numpy()
        assert got.dtype == np.asarray(want).dtype
        np.testing.assert_array_equal(got, want)


def test_lasso_graph_replayed_epoch_equals_the_eager_epoch(dev):
    """One coordinate-descent epoch through its registry program (site
    ``streaming.lasso``, a CUDA graph captured at the first call) gives the
    eager epoch's coefficients bit for bit, and three epochs on the card
    equal the same epochs on the CPU within 1e-5."""
    from heat_tpu_torch.core import program_cache
    from heat_tpu_torch.regression.lasso import _curvature, _epoch, _epoch_program

    g = torch.Generator(device=dev).manual_seed(6)
    x = torch.randn((100_003, 17), generator=g, device=dev)
    y = x @ torch.randn((17,), generator=g, device=dev) + 0.25 + 0.1 * torch.randn(
        (x.shape[0],), generator=g, device=dev)
    xt = torch.cat([torch.ones((x.shape[0], 1), device=dev), x], 1).t().contiguous()
    start = torch.randn((18,), generator=g, device=dev) * 0.1
    z = _curvature(xt, x.shape[0], None)
    lam, n = torch.tensor(0.01, device=dev), torch.tensor(float(x.shape[0]), device=dev)
    eager, _ = _epoch(start.clone(), lam, n, xt, y, z, comm=None)
    program_cache.reset()
    prog = _epoch_program(xt, None)
    first, _ = prog(start.clone(), lam, n, xt, y, z)  # the capture
    again, _ = prog(start.clone(), lam, n, xt, y, z)  # a replay
    torch.cuda.synchronize()
    assert torch.equal(first, eager) and torch.equal(again, eager)
    assert program_cache.site_stats("streaming.lasso") == {"hits": 0, "misses": 1}
    htt.use_device(None)
    card = htt.regression.Lasso(lam=0.01, max_iter=3, tol=0.0).fit(
        htt.array(x, split=0), htt.array(y, split=0))
    cpu = htt.regression.Lasso(lam=0.01, max_iter=3, tol=0.0).fit(
        htt.array(x.cpu(), split=0, device="cpu"), htt.array(y.cpu(), split=0, device="cpu"))
    assert card.n_iter == cpu.n_iter == 3
    np.testing.assert_allclose(card.theta.numpy(), cpu.theta.numpy(), atol=1e-5)


def test_a_lasso_path_over_penalties_holds_one_static_copy(dev):
    """Fits at three penalties on one card share one ``streaming.lasso``
    program and one parameter set: the memory allocated after the second
    and the third fit equals that after the first, which is the baseline
    plus the parameters' one static copy, the graph's pool and the cuBLAS
    workspace of the capture's stream (32 MiB on Hopper), and not a second
    design matrix (the caller's is not held)."""
    import gc

    from heat_tpu_torch.core import program_cache

    g = torch.Generator(device=dev).manual_seed(8)
    x = htt.array(torch.randn((2_000_000, 31), generator=g, device=dev), split=0)
    y = htt.array(torch.randn((2_000_000,), generator=g, device=dev), split=0)
    program_cache.reset()
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    after = []
    for lam in (0.1, 0.01, 0.001):
        htt.regression.Lasso(lam=lam, max_iter=3, tol=0.0).fit(x, y)
        gc.collect()
        torch.cuda.synchronize()
        after.append(torch.cuda.memory_allocated(dev))
    assert program_cache.site_stats("streaming.lasso") == {"hits": 2, "misses": 1}
    sets = [v for k, v in program_cache._SHARED.items() if k[0] == "streaming.lasso"]
    assert len(sets) == 1
    rows, cols = x.shape
    assert sets[0].nbytes() == 4 * ((cols + 1) * rows + rows + cols + 1)
    assert after[1] == after[0] and after[2] == after[0]
    # the static copy, the graph's pool and the workspace (256 MB of design
    # matrix against 32 MiB of workspace), not a second design matrix
    assert after[0] - base < sets[0].nbytes() + 4 * (cols + 1) * rows


_SLICE_DATA = """
import numpy as np
import torch

def make_slice_data():
    g = torch.Generator().manual_seed(9)
    x = torch.randn((100_003, 64), generator=g)
    y = x @ torch.randn((64, 1), generator=g)
    ids = torch.randint(0, 8, (4001, 1), generator=g)
    pts = 0.1 * torch.randn((4001, 32), generator=g) + ids * 8.0
    return x, y, pts

def run(ht, device):
    from heat_tpu_torch.regression.lasso import _curvature, _design, _epoch
    x_t, y_t, pts_t = (t.to(device) for t in make_slice_data())
    res = {}
    x, y = ht.array(x_t, split=0), ht.array(y_t, split=0)
    est = ht.regression.Lasso(lam=0.01, max_iter=30, tol=0.0).fit(x, y)
    res["lasso_theta"] = est.theta.numpy()
    res["lasso_n_iter"] = np.array(est.n_iter)
    res["lasso_1_theta"] = ht.regression.Lasso(lam=0.01, max_iter=30, tol=0.0).fit(
        ht.array(x_t, split=1), ht.array(y_t)).theta.numpy()
    ht.random.seed(3)
    sp = ht.cluster.Spectral(n_clusters=8, gamma=0.05, n_lanczos=40).fit(ht.array(pts_t, split=0))
    res["spectral_labels"] = sp.labels_.numpy()
    res["spectral_split"] = np.array(sp.labels_.split)
    # whether one epoch with its NCCL allreduces can be captured as a CUDA
    # graph (the fit itself runs several ranks eagerly)
    if x_t.is_cuda and x.comm.size > 1:
        xt, yb, comm = _design(x, y, torch.float32)
        z = _curvature(xt, x.shape[0], comm)
        zero = torch.zeros(65, device=device)
        lam, n = torch.tensor(0.01, device=device), torch.tensor(float(x.shape[0]), device=device)

        def sweep():
            return _epoch(zero, lam, n, xt, yb, z, comm=comm)[0]

        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            sweep()
        torch.cuda.current_stream().wait_stream(side)
        eager = sweep()
        again = sweep()
        try:
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = sweep()
            graph.replay()
            torch.cuda.synchronize()
            res["capture"] = np.array("captured, replay equals eager: "
                                      f"{bool(torch.equal(out, again))}")
        except RuntimeError as e:
            res["capture"] = np.array(f"capture failed: {str(e)[:300]}")
        res["eager_repeat_equal"] = np.array(bool(torch.equal(eager, again)))
    return res
"""


def test_nccl_lasso_spectral_ranks_match_world_of_one(dev, tmp_path):
    """Every card one rank over NCCL: Lasso (rows split, and a feature split
    resplit once; one scalar allreduce a coordinate, eager) within 1e-5 of
    the world of one's coefficients with the same epoch count, and Spectral
    with the world of one's labels up to a relabelling. Prints whether one
    epoch with its NCCL allreduces could be captured as a CUDA graph."""
    world = torch.cuda.device_count()
    if world < 2:
        pytest.skip("needs two or more CUDA cards")
    ranks = _spmd_ranks(tmp_path, world, "nccl", _SLICE_DATA)
    ns = {}
    exec(_SLICE_DATA, ns)
    htt.use_device(None)
    want = ns["run"](htt, dev)
    for r in ranks:
        assert int(r["lasso_n_iter"]) == int(want["lasso_n_iter"]) == 30
        np.testing.assert_allclose(r["lasso_theta"], want["lasso_theta"], atol=1e-5)
        np.testing.assert_allclose(r["lasso_1_theta"], want["lasso_theta"], atol=1e-5)
        pairs = set(zip(r["spectral_labels"].tolist(), want["spectral_labels"].tolist()))
        assert len(pairs) == len(set(want["spectral_labels"].tolist()))
        assert int(r["spectral_split"]) == 0
        assert bool(r["eager_repeat_equal"])
    print("lasso epoch under NCCL:", str(ranks[0]["capture"]))


def _sparse_inputs(seed=21, m=3001, n=2503, density=0.01):
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal((m, n)) * (rng.random((m, n)) < density)).astype(np.float32)
    a[7] = 0.0  # an empty row
    return a, rng.standard_normal(n).astype(np.float32)


def test_sparse_products_on_card_match_the_cpu_port(dev):
    """csr_from_dense compacted on the card, an integer spmv, a pattern
    min-spmv over int64 labels, min/max, a float spmv and spmm (cuSPARSE) and
    the transpose, each against the CPU port on the same input: structure,
    integer, pattern and min/max results bit for bit, float sums within
    1e-5 of the largest |value|."""
    htt.use_device(None)
    a, x = _sparse_inputs()
    ai = np.round(a * 4).astype(np.int64)
    labels = np.arange(a.shape[1], dtype=np.int64)[::-1].copy()
    results = {}
    for where in ("cuda", "cpu"):
        kw = {} if where == "cuda" else {"device": "cpu"}
        A = htt.sparse.csr_from_dense(htt.array(a, split=0, **kw))
        Ai = htt.sparse.csr_from_dense(ai, **kw)
        assert A.indptr.device.type == where and A.values.device.type == where
        results[where] = {
            "indptr": A.indptr.cpu(), "indices": A.indices[:A.lnnz].cpu(),
            "int_sum": htt.sparse.spmv(Ai, htt.array(labels, **kw)).numpy(),
            "pattern_min": htt.sparse.spmv(A, htt.array(labels, **kw), reduce="min",
                                           pattern=True, out_split=None).numpy(),
            "min": htt.sparse.spmv(A, htt.array(x, **kw), reduce="min").numpy(),
            "max": htt.sparse.spmv(A, htt.array(x, split=0, **kw), reduce="max").numpy(),
            "sum": htt.sparse.spmv(A, htt.array(x, **kw), out_split=None).numpy(),
            "spmm": htt.sparse.spmm(A, htt.array(np.stack([x] * 8, 1), **kw)).numpy(),
            "T": A.transpose().to_dense().numpy(),
            "T_slab": htt.sparse.transpose(A, slab=max(1, A.capacity // 4)).to_dense().numpy(),
        }
    got, want = results["cuda"], results["cpu"]
    for name in ("indptr", "indices"):
        assert torch.equal(got[name], want[name]), name
    for name in ("int_sum", "pattern_min", "min", "max", "T", "T_slab"):
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    for name in ("sum", "spmm"):
        np.testing.assert_allclose(got[name], want[name], rtol=0,
                                   atol=1e-5 * float(np.abs(want[name]).max()), err_msg=name)
    np.testing.assert_array_equal(got["T"], a.T)


def test_knn_planted_ties_on_card(dev):
    """Equal distances on the card: the lower training index is nearer, a
    tied vote goes to the lower class, as on the CPU."""
    htt.use_device(None)
    x = np.array([[1.0, 0.0], [-1.0, 0.0], [0.0, 1.0], [0.0, -1.0], [5.0, 5.0]], np.float32)
    y = np.array([3, 1, 1, 3, 0])
    for k, want in ((1, 3), (2, 1), (3, 1), (4, 1)):
        est = htt.classification.KNeighborsClassifier(k).fit(htt.array(x), htt.array(y))
        assert int(est.predict(htt.array(np.zeros((1, 2), np.float32))).numpy()[0]) == want


_SPARSE_DATA = """
import numpy as np
import torch

def make_sparse_data():
    rng = np.random.default_rng(17)
    a = (rng.standard_normal((4099, 4099)) * (rng.random((4099, 4099)) < 0.01)).astype(np.float32)
    x = rng.standard_normal(4099).astype(np.float32)
    ids = rng.integers(0, 8, (2003, 1))
    # blobs close enough to link into one graph: a non-degenerate embedding
    pts = (rng.standard_normal((2003, 32)) + ids * 1.5).astype(np.float32)
    return a, x, pts

def run(ht, device):
    a, x, pts = make_sparse_data()
    res = {}
    A = ht.sparse.csr_from_dense(ht.array(torch.from_numpy(a).to(device), split=0))
    res["counts"] = A.counts
    res["dense"] = A.to_dense().numpy()
    xs = ht.array(torch.from_numpy(x).to(device), split=0)
    res["spmv"] = ht.sparse.spmv(A, xs, out_split=None).numpy()
    res["spmv_0"] = ht.sparse.spmv(A, xs).numpy()
    res["spmv_max"] = ht.sparse.spmv(A, xs, reduce="max").numpy()
    res["spmm"] = ht.sparse.spmm(A, ht.array(torch.from_numpy(np.stack([x] * 8, 1)).to(device)),
                                 out_split=None).numpy()
    res["T"] = A.transpose().to_dense().numpy()
    res["T_slab"] = ht.sparse.transpose(A, slab=max(1, A.capacity // 4)).to_dense().numpy()
    res["components"] = ht.graph.connected_components(
        ht.sparse.csr_from_dense(ht.array(torch.from_numpy(a[:600, :600]).to(device),
                                          split=0))).numpy()
    ht.random.seed(3)
    sp = ht.cluster.Spectral(n_clusters=8, gamma=0.05, laplacian="eNeighbour", threshold=3e-3,
                             boundary="lower", n_lanczos=40)
    pts_d = ht.array(torch.from_numpy(pts).to(device), split=0)
    L = sp._laplacian.construct(pts_d)
    res["laplacian_sparse"] = np.array(isinstance(L, ht.sparse.SparseDNDarray))
    res["laplacian"] = L.to_dense().numpy()
    res["spectral_labels"] = sp.fit(pts_d).labels_.numpy()
    return res
"""


def test_nccl_sparse_ranks_match_world_of_one(dev, tmp_path):
    """Every card one rank over NCCL: csr_from_dense of a 1% 4099² matrix,
    spmv (a row-split x gathered; replicated and row-split results), spmm,
    the transpose staged and not, connected components and the sparse
    Spectral's Laplacian and labels equal the world of one (structure,
    max and labels bit for bit, float sums within 1e-5 of the largest
    |value|, Spectral's labels up to a relabelling; its blobs are linked
    into one graph, since the null space of disconnected ones is taken in
    an order that rounding decides)."""
    world = torch.cuda.device_count()
    if world < 2:
        pytest.skip("needs two or more CUDA cards")
    ranks = _spmd_ranks(tmp_path, world, "nccl", _SPARSE_DATA)
    ns = {}
    exec(_SPARSE_DATA, ns)
    htt.use_device(None)
    want = ns["run"](htt, dev)
    _hold_sparse_ranks(ranks, want, world)


def _hold_sparse_ranks(ranks, want, world):
    for r in ranks:
        assert int(r["counts"].sum()) == int(want["counts"].sum()) and len(r["counts"]) == world
        for name in ("dense", "spmv_max", "T", "T_slab", "components"):
            np.testing.assert_array_equal(r[name], want[name], err_msg=name)
        for name in ("spmv", "spmv_0", "spmm", "laplacian"):
            np.testing.assert_allclose(r[name], want[name], rtol=0,
                                       atol=1e-5 * float(np.abs(want[name]).max()), err_msg=name)
        assert bool(r["laplacian_sparse"]) and bool(want["laplacian_sparse"])
        pairs = set(zip(r["spectral_labels"].tolist(), want["spectral_labels"].tolist()))
        assert len(pairs) == len(set(want["spectral_labels"].tolist()))


_PARALLEL_DATA = """
import os
import numpy as np
import torch

def _chunk(a, comm, axis):
    c = a.shape[axis] // comm.size
    return a.narrow(axis, comm.rank * c, c)

def _err(got, ref):
    g, r = got.double(), ref.double()
    return np.array([((g - r).pow(2).sum() / r.pow(2).sum()).sqrt().item(),
                     ((g - r).abs().max() / r.abs().max()).item()])

def _attention(ht, device, comm, res):
    # (1, 4 x 8192, 16, 64) bf16 causal; each rank its chunk of 8192 positions,
    # against one card's flash_attention of the whole sequence (on this card)
    t, h, d = (4 * 8192, 16, 64) if device.type == "cuda" else (4 * 32, 16, 16)
    g = torch.Generator().manual_seed(21)
    q, k, v, w = (torch.randn((1, t, h, d), generator=g).to(torch.bfloat16).to(device)
                  for _ in range(4))
    def run(fn, inputs, weight):
        xs = [x.detach().clone().requires_grad_(True) for x in inputs]
        o = fn(*xs)
        o.backward(weight)
        return [o.detach()] + [x.grad for x in xs]
    ref = run(lambda *a: ht.parallel.flash_attention(*a, causal=True), (q, k, v), w)
    ref = [_chunk(x, comm, 1) for x in ref]
    vmax = v.float().abs().max().item()
    for name, fn in (("ring", ht.parallel.ring_attention),
                     ("ulysses", lambda *a, **kw: ht.parallel.ulysses_attention(
                         *a, use_pallas=True, **kw))):
        ht.reset_launch_counts()
        got = run(lambda *a: fn(*a, comm=comm, causal=True),
                  [_chunk(x, comm, 1) for x in (q, k, v)], _chunk(w, comm, 1))
        res[f"{name}_launches"] = np.array([ht.launch_counts()[n] for n in (
            "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")])
        res[f"{name}_o_err_over_vmax"] = np.array(
            (got[0].float() - ref[0].float()).abs().max().item() / vmax)
        for gname, a, b in zip(("o", "dq", "dk", "dv"), got, ref):
            res[f"{name}_{gname}_err"] = _err(a, b)

def run(ht, device):
    comm = ht.get_comm()
    res = {}
    if comm.size > 1:
        _attention(ht, device, comm, res)

    # DataParallel in both modes: a small f32 flash TransformerLM and AdamW,
    # 3 steps on one global batch of 8 x 128 tokens
    import torch.nn.functional as F
    tokens = torch.from_numpy(np.random.default_rng(4).integers(0, 256, (8, 128))).to(device)
    def lm_loss(model, tok):
        return F.cross_entropy(model(tok)[:, :-1].reshape(-1, 256), tok[:, 1:].reshape(-1))
    for blocking in (True, False):
        lm = ht.nn.TransformerLM(256, 128, 4, 2, max_len=128, attn_impl="flash", device=device,
                                 generator=torch.Generator(device=device).manual_seed(0))
        if blocking:
            res["lm_init"] = np.concatenate([p.detach().reshape(-1).cpu().numpy()
                                             for p in lm.parameters()])
        opt = torch.optim.AdamW(lm.parameters(), lr=1e-3, weight_decay=1e-4)
        dp = ht.nn.DataParallel(lm, optimizer=opt, blocking_parameter_updates=blocking)
        step = dp.make_train_step(lm_loss)
        pending = dp.init_pending(lm)
        for _ in range(3):
            if blocking:
                _, _, loss = step(lm, opt, *dp.shard_batch(tokens))
            else:
                _, _, pending, loss = step(lm, opt, pending, *dp.shard_batch(tokens))
        res[f"dp_{blocking}"] = np.concatenate([p.detach().reshape(-1).cpu().numpy()
                                                for p in lm.parameters()])
        res[f"dp_{blocking}_loss"] = np.array(float(loss))

    # DASO: an MLP classifier through warmup (1 epoch), cycling and cooldown (1)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((256, 16)).astype(np.float32)).to(device)
    y = torch.from_numpy(rng.integers(0, 4, 256)).to(device)
    mlp = torch.nn.Sequential(torch.nn.Linear(16, 32), torch.nn.ReLU(), torch.nn.Linear(32, 4))
    torch.manual_seed(0)
    for p in mlp.parameters():
        torch.nn.init.normal_(p, std=0.1)
    mlp = mlp.to(device)
    daso = ht.optim.DASO(torch.optim.Adam(mlp.parameters(), lr=5e-3), total_epochs=6,
                         warmup_epochs=1, cooldown_epochs=1, max_global_skips=4)
    daso.set_loss(lambda m, xb, yb: F.cross_entropy(m(xb), yb))
    daso.last_batch = 7
    params, state = daso.stack_params(mlp), daso.init(mlp)
    states = []
    for epoch in range(6):
        total = 0.0
        for b in range(8):
            params, state, loss = daso.step(params, state, (x[b * 32:(b + 1) * 32],
                                                            y[b * 32:(b + 1) * 32]))
            total += float(loss)
        daso.epoch_loss_logic(total / 8)
        states.append([daso.epoch, daso.global_skip, daso.local_skip, daso.batches_to_wait])
        res[f"daso_e{epoch}"] = np.concatenate([p.detach().reshape(-1).cpu().numpy()
                                                for p in mlp.parameters()])
    res["daso_states"] = np.array(states)
    res["daso_layout"] = np.array([daso.n_nodes, daso.n_local])

    # the ring distances: the whole matrix's rows of this rank
    g = torch.Generator().manual_seed(6)
    xc, yc = torch.rand((4099, 64), generator=g), torch.rand((3001, 64), generator=g)
    xd, yd = ht.array(xc.to(device), split=0), ht.array(yc.to(device), split=0)
    os.environ["HEAT_TPU_CDIST_PREC"] = "highest"  # the non-ring GEMM form in exact f32
    try:
        for ring in (True, False):
            res[f"cdist_{ring}"] = ht.spatial.cdist(xd, yd, ring=ring).larray.cpu().numpy()
            res[f"cdist_q_{ring}"] = ht.spatial.cdist(xd, yd, quadratic_expansion=True,
                                                      ring=ring).larray.cpu().numpy()
            res[f"rbf_{ring}"] = ht.spatial.rbf(xd, yd, sigma=2.0, quadratic_expansion=True,
                                                ring=ring).larray.cpu().numpy()
            res[f"manhattan_{ring}"] = ht.spatial.manhattan(xd, yd, ring=ring).larray.cpu().numpy()
    finally:
        del os.environ["HEAT_TPU_CDIST_PREC"]

    # ring_pipeline (A B^T by circulating B) and the halos, against numpy
    a = torch.from_numpy(np.random.default_rng(7).standard_normal((4096, 64)).astype(np.float32))
    c = a.shape[0] // comm.size
    def tile(t_, origin, stat, circ, acc):
        acc[:, origin * c:(origin + 1) * c] = stat @ circ.T
        return acc
    ac = _chunk(a, comm, 0).to(device)
    res["pipeline"] = ht.parallel.ring_pipeline(
        tile, ac, ac.clone(), torch.zeros((c, a.shape[0]), device=device), comm=comm).cpu().numpy()
    hx = ht.array(torch.arange(40 * 3, dtype=torch.float32).reshape(40, 3).to(device), split=0)
    res["halo_zero"] = ht.parallel.halo_exchange(hx, 2).cpu().numpy()
    res["halo_wrap"] = ht.parallel.halo_exchange(hx, 2, wrap=True).cpu().numpy()
    res["stencil"] = ht.parallel.halo_stencil(hx, 1, lambda blk: blk[2:] - blk[:-2],
                                              wrap=True).cpu().numpy()

    # MoEMLP: 8 experts over the ranks against all 8 on this rank
    xm = torch.from_numpy(np.random.default_rng(8).standard_normal((4, 256, 64))
                          .astype(np.float32)).to(device)
    outs = []
    for moe_comm in (comm, None):
        layer = ht.nn.MoEMLP(8, 128, comm=moe_comm, d_model=64, device=device,
                             generator=torch.Generator(device=device).manual_seed(9))
        y_m = layer(xm)
        (y_m * xm).sum().backward()
        outs.append((y_m.detach(), layer.gate.grad, layer.w_in.grad, layer.expert_range()))
    lo, hi = outs[0][3]
    res["moe_out_err"] = np.array((outs[0][0] - outs[1][0]).abs().max().item())
    res["moe_gate_grad_err"] = np.array((outs[0][1] - outs[1][1]).abs().max().item())
    res["moe_w_in_grad_err"] = np.array((outs[0][2] - outs[1][2][lo:hi]).abs().max().item())
    res["moe_scale"] = np.array(outs[1][0].abs().max().item())
    return res
"""


def _hold_parallel_ranks(ranks, want, world):
    """The world of ``world`` ranks against the world of one (``want``) and
    numpy. Tolerances: ring and Ulysses against one card's flash_attention
    (bf16), O and the gradients each by its own scale on this rank's chunk (a
    late chunk's |O| is far below max|v|): relative RMS 2e-3 and largest
    error 2^-6 of the largest for Ulysses (the flash kernels on each head
    group), 1e-2 and 2^-5 for the ring (its plain block rounds P to bf16
    against each block's own maximum, and its autograd backward rounds
    at other points), and O within 2^-7 max|v|; DataParallel's updates within 1e-3 relative RMS of the
    world of one's (the mean of the ranks' mean gradients sums in another
    order); the ring distances 1e-5 relative of their scale (the GEMM form
    1e-4: its cancellation), manhattan 1e-6 (the same 64 terms, summed by a
    reduction whose split may follow the block's shape); ring_pipeline 1e-4 of
    the product's scale; halos bit for bit; MoEMLP 1e-5 of the output's
    scale."""
    a = np.random.default_rng(7).standard_normal((4096, 64)).astype(np.float32)
    prod = a @ a.T
    h = np.arange(40 * 3, dtype=np.float32).reshape(40, 3)
    _, displs = communication.counts_displs(40, world)
    c = 40 // world
    init = want["lm_init"]
    for rank, r in enumerate(ranks):
        for name, (rms_tol, max_tol) in (("ulysses", (2e-3, 2.0 ** -6)),
                                         ("ring", (1e-2, 2.0 ** -5))):
            assert float(r[f"{name}_o_err_over_vmax"]) <= 2.0 ** -7, name
            for gname in ("o", "dq", "dk", "dv"):
                rms, mx = r[f"{name}_{gname}_err"]
                assert rms <= rms_tol and mx <= max_tol, (name, gname, rms, mx)
        if r["ulysses_launches"].size and torch.cuda.is_available():
            np.testing.assert_array_equal(r["ulysses_launches"], [1, 1, 1])
            np.testing.assert_array_equal(r["ring_launches"], [0, 0, 0])
        for blocking in (True, False):
            du = r[f"dp_{blocking}"].astype(np.float64) - want[f"dp_{blocking}"]
            ref = want[f"dp_{blocking}"].astype(np.float64) - init
            assert np.sqrt((du ** 2).sum() / (ref ** 2).sum()) <= 1e-3, blocking
            np.testing.assert_allclose(r[f"dp_{blocking}_loss"], want[f"dp_{blocking}_loss"],
                                       rtol=1e-4)
        np.testing.assert_array_equal(r["daso_layout"], [2, world // 2])
        np.testing.assert_array_equal(r["daso_states"], ranks[0]["daso_states"])
        skips = [s[1] for s in r["daso_states"].tolist()]
        assert 4 in skips and skips[-1] == 0, skips  # cycling, then cooldown
        node0 = ranks[(rank // (world // 2)) * (world // 2)]
        # within a node every epoch; the whole world during warmup (past it each
        # node merges the cross-node sum with its own weight)
        for e in range(6):
            np.testing.assert_array_equal(r[f"daso_e{e}"], node0[f"daso_e{e}"])
        np.testing.assert_array_equal(r["daso_e0"], ranks[0]["daso_e0"])
        rows = slice(*communication.chunk((4099, 3001), 0, rank, world)[2][0].indices(4099)[:2])
        for name, tol in (("cdist", 1e-5), ("cdist_q", 1e-4), ("rbf", 1e-4)):
            np.testing.assert_allclose(r[f"{name}_True"], want[f"{name}_False"][rows], rtol=0,
                                       atol=tol * float(np.abs(want[f"{name}_False"]).max()),
                                       err_msg=name)
        np.testing.assert_allclose(r["manhattan_True"], want["manhattan_False"][rows], rtol=0,
                                   atol=1e-6 * float(np.abs(want["manhattan_False"]).max()))
        np.testing.assert_allclose(r["pipeline"], prod[rank * 4096 // world:
                                                       (rank + 1) * 4096 // world],
                                   rtol=0, atol=1e-4 * float(np.abs(prod).max()))
        lo = displs[rank]
        blk = h[lo:lo + c]
        prev = h[lo - 2:lo] if rank > 0 else np.zeros((2, 3), np.float32)
        nxt = h[lo + c:lo + c + 2] if rank < world - 1 else np.zeros((2, 3), np.float32)
        np.testing.assert_array_equal(r["halo_zero"], np.concatenate([prev, blk, nxt]))
        wprev = h[(np.arange(lo - 2, lo)) % 40]
        wnxt = h[(np.arange(lo + c, lo + c + 2)) % 40]
        np.testing.assert_array_equal(r["halo_wrap"], np.concatenate([wprev, blk, wnxt]))
        ext = h[np.arange(lo - 1, lo + c + 1) % 40]
        np.testing.assert_array_equal(r["stencil"], ext[2:] - ext[:-2])
        scale = float(r["moe_scale"])
        for name in ("moe_out_err", "moe_gate_grad_err", "moe_w_in_grad_err"):
            assert float(r[name]) <= 1e-5 * max(scale, 1.0), (name, float(r[name]))


def test_nccl_parallel_ranks_match_world_of_one(dev, tmp_path):
    """Every card one rank over NCCL: ring_attention and
    ulysses_attention(use_pallas=True) at (1, 4 x 8192, 16, 64) bf16 causal,
    forward and gradients, against one card's flash_attention of the whole
    sequence; DataParallel in both modes against the world of one on the
    same global batch; DASO on 2 x 2 through its schedule, its replicas
    equal within a node every epoch and across the world during warmup; the ring
    cdist/rbf/manhattan against the world of one's ordinary path;
    ring_pipeline and the halos against numpy; MoEMLP with comm against
    comm=None (tolerances in ``_hold_parallel_ranks``)."""
    world = torch.cuda.device_count()
    if world < 2:
        pytest.skip("needs two or more CUDA cards")
    ranks = _spmd_ranks(tmp_path, world, "nccl", _PARALLEL_DATA)
    ns = {}
    exec(_PARALLEL_DATA, ns)
    htt.use_device(None)
    want = ns["run"](htt, dev)
    _hold_parallel_ranks(ranks, want, world)
    print("parallel ranks' errors:", [{key: r[key].tolist() for key in r if key.endswith(
        ("_err", "_err_over_vmax"))} for r in ranks])


# -- out-of-core streaming ---------------------------------------------------------

_STREAM_DATA = """
import os
import numpy as np
import torch

def protos():
    return (np.random.default_rng(0).standard_normal((12, 64)) * 8).astype(np.float32)

def make_files(where):
    '''Two .npy files of 12 well separated blobs in 64 columns (the
    chunking restarts at each file: chunks of 65,536 rows end short).'''
    rng = np.random.default_rng(1)
    centers = protos()
    paths = []
    for i, n in enumerate((300_001, 170_003)):
        path = os.path.join(where, f"part{i}.npy")
        if not os.path.exists(path):
            x = centers[rng.integers(0, 12, n)] + rng.standard_normal((n, 64)).astype(np.float32)
            np.save(path + ".tmp.npy", x.astype(np.float32))
            os.replace(path + ".tmp.npy", path)
        paths.append(path)
    return paths

def run(ht, device):
    ckpt = os.path.join(out, "ckpt_" + device.type)
    paths = [os.path.join(out, f"part{i}.npy") for i in range(2)]
    stream = ht.streaming.ChunkStream(paths, chunk_rows=65_536)
    res = {"chunks": np.array(len(stream))}
    # the initial centers near the blobs' own: no row is a near tie of two centers
    c0 = ht.array(protos() + 0.5)
    ht.reset_launch_counts()
    moments = ht.streaming.StreamingMoments()
    mbk = ht.streaming.MiniBatchKMeans(n_clusters=12, init=c0, inner_iter=3)
    for i, chunk in enumerate(stream):
        assert chunk.larray.device.type == device.type
        moments.partial_fit(chunk)
        mbk.partial_fit(chunk)
        if i == 4:  # the end of the first file
            moments.save(ckpt + "_m")
            mbk.save(ckpt + "_k")
            skip = int(moments.n_seen)
    counts = ht.launch_counts()
    res["launches"] = np.array([counts["moments"], counts["lloyd"]])
    res["mean"], res["var"], res["n"] = moments.mean, moments.var(), np.array(moments.n_seen)
    res["centers"], res["counts"] = mbk._centers_np, mbk._counts_np
    res["inertia"] = np.array(mbk.inertia_)
    rm = ht.streaming.StreamingMoments.restore(ckpt + "_m")
    rk = ht.streaming.MiniBatchKMeans.restore(ckpt + "_k")
    for chunk in ht.streaming.ChunkStream(paths, chunk_rows=65_536, skip_rows=skip):
        rm.partial_fit(chunk)
        rk.partial_fit(chunk)
    res["resumed_bitwise"] = np.array(
        np.array_equal(rm._mean, moments._mean) and np.array_equal(rm._m2, moments._m2)
        and np.array_equal(rk._centers_np, mbk._centers_np)
        and np.array_equal(rk._counts_np, mbk._counts_np) and rk._shift == mbk._shift)
    x = ht.load_npy(paths[1], split=0)
    kw = dict(n_clusters=12, init=c0, max_iter=12, tol=0.0)
    plain = ht.cluster.KMeans(**kw).fit(x)
    ck = ht.cluster.KMeans(**kw, checkpoint_every=5, checkpoint_path=ckpt + "_km").fit(x)
    res["kmeans_checkpointed_bitwise"] = np.array(
        torch.equal(plain.cluster_centers_.larray, ck.cluster_centers_.larray)
        and torch.equal(plain.labels_.larray, ck.labels_.larray) and plain.n_iter_ == ck.n_iter_)
    res["kmeans_centers"] = plain.cluster_centers_.numpy()
    ht.save_npy(x, ckpt + "_x.npy")
    back = ht.load_npy(ckpt + "_x.npy", split=0)
    res["npy_roundtrip"] = np.array(torch.equal(back.larray, x.larray))
    return res
"""


def test_streaming_estimators_launch_k2_and_k4_and_match_plain(dev, tmp_path):
    """StreamingMoments launches K2 once a chunk and MiniBatchKMeans K4 at
    most inner_iter times a chunk; the moments within 1e-5 of the column's
    spread (M2 1e-4 relative) of the CPU port's plain version, the centers
    within 1e-5 of the largest |center| of the same estimator on the plain
    Lloyd pass on the card and of the CPU's (separated blobs: the same
    labels, sums in another order), counts exactly; the resumes and the
    checkpointed KMeans bit for bit."""
    ns = {"out": str(tmp_path)}
    exec(_STREAM_DATA, ns)
    ns["make_files"](str(tmp_path))
    htt.use_device(None)
    got = ns["run"](htt, dev)
    chunks = int(got["chunks"])
    assert chunks == 8 and int(got["launches"][0]) == chunks
    assert 0 < int(got["launches"][1]) <= 3 * chunks
    assert bool(got["resumed_bitwise"]) and bool(got["kmeans_checkpointed_bitwise"])
    assert bool(got["npy_roundtrip"])
    htt.use_device("cpu")
    try:
        want = ns["run"](htt, torch.device("cpu"))
    finally:
        htt.use_device(None)
    spread = np.abs(want["mean"]) + np.sqrt(want["var"])
    assert (np.abs(got["mean"] - want["mean"]) <= 1e-5 * spread).all()
    np.testing.assert_allclose(got["var"], want["var"], rtol=1e-4)
    ref = htt.streaming.MiniBatchKMeans(n_clusters=12, init=htt.array(ns["protos"]() + 0.5),
                                        inner_iter=3)
    ref._update = cuda_lloyd.lloyd_update_plain
    for chunk in htt.streaming.ChunkStream([str(tmp_path / f"part{i}.npy") for i in range(2)],
                                           chunk_rows=65_536):
        ref.partial_fit(chunk)
    atol = 1e-5 * float(np.abs(ref._centers_np).max())
    np.testing.assert_allclose(got["centers"], ref._centers_np, rtol=0, atol=atol)
    np.testing.assert_array_equal(got["counts"], ref._counts_np)
    np.testing.assert_allclose(got["centers"], want["centers"], rtol=0, atol=atol)
    np.testing.assert_array_equal(got["counts"], want["counts"])


def _hold_stream_ranks(ranks, want):
    """Each rank's streamed estimates against the world of one's: the row
    count exactly, the moments within 1e-5 of the column's spread (M2 1e-4
    relative: the ranks' moments merge in closed form), the centers within
    1e-5 of the largest |center| (their sums add the ranks' partial sums, in
    another order, over 12 iterations) and the counts exactly (separated
    blobs), the resumes and the checkpointed KMeans bit for bit on every
    rank."""
    spread = np.abs(want["mean"]) + np.sqrt(want["var"])
    for r in ranks:
        assert int(r["chunks"]) == int(want["chunks"])
        assert int(r["launches"][0]) == int(want["launches"][0])
        assert float(r["n"]) == float(want["n"])
        assert (np.abs(r["mean"] - want["mean"]) <= 1e-5 * spread).all()
        np.testing.assert_allclose(r["var"], want["var"], rtol=1e-4)
        for name in ("centers", "kmeans_centers"):
            np.testing.assert_allclose(r[name], want[name], rtol=0,
                                       atol=1e-5 * float(np.abs(want[name]).max()))
        np.testing.assert_array_equal(r["counts"], want["counts"])
        for name in ("resumed_bitwise", "kmeans_checkpointed_bitwise", "npy_roundtrip"):
            assert bool(r[name]), name


def test_nccl_stream_ranks_match_world_of_one(dev, tmp_path):
    """Every card one rank over NCCL: the ranks stream the same two files,
    each reading its slab of every chunk; StreamingMoments, MiniBatchKMeans,
    their checkpoints (rank 0 writes) and resumes, the checkpointed KMeans
    and a split save_npy/load_npy against the world of one."""
    world = torch.cuda.device_count()
    if world < 2:
        pytest.skip("needs two or more CUDA cards")
    ns = {"out": str(tmp_path)}
    exec(_STREAM_DATA, ns)
    ns["make_files"](str(tmp_path))
    ranks = _spmd_ranks(tmp_path, world, "nccl", _STREAM_DATA)
    htt.use_device(None)
    want = ns["run"](htt, dev)
    _hold_stream_ranks(ranks, want)


# -- the program registry's CUDA graphs and the serving forms (card only) ---------------


def test_program_cache_captures_replays_and_copies_only_what_changed(dev):
    """A registry program on card tensors: the first call of a signature
    captures a CUDA graph (one build), later calls replay it (none); a
    card tensor passed again unchanged is not copied, one changed in place
    (its version counter moves) or replaced is, a host tensor is copied on
    every call; each result is a clone that
    the next replay leaves alone; ``program_bytes`` reads the graph's pool;
    a program that synchronises cannot be captured and raises naming its
    site."""
    from heat_tpu_torch import telemetry
    from heat_tpu_torch.core import program_cache as pc
    from heat_tpu_torch.resilience import memory_guard

    pc.reset()
    w = torch.randn(64, 32, device=dev)
    prog = pc.cached_program("t.graph", 0, lambda: lambda x, w: torch.relu(x @ w) + 1.0)
    x1 = torch.randn(16, 64)  # a host batch: copied into the graph's input
    with telemetry.CompileWatcher() as cw:
        out1 = prog(x1, w)
    assert cw.backend_compiles == 1
    assert memory_guard.program_bytes(prog, (x1, w)) > 0
    graph = next(iter(prog.__wrapped__._graphs.values()))
    x2 = torch.randn(16, 64)
    with telemetry.CompileWatcher() as cw:
        out2 = prog(x2, w)
    assert cw.backend_compiles == 0
    assert graph.last[1][0] is w and graph.last[0] is None  # the host batch: always copied
    torch.testing.assert_close(out1, torch.relu(x1.to(dev) @ w) + 1.0, rtol=0, atol=1e-5)
    torch.testing.assert_close(out2, torch.relu(x2.to(dev) @ w) + 1.0, rtol=0, atol=1e-5)
    assert not torch.equal(out1, out2)  # the second replay left the first clone alone
    w.mul_(2.0)
    torch.testing.assert_close(prog(x2, w), torch.relu(x2.to(dev) @ w) + 1.0, rtol=0, atol=1e-5)
    w2 = torch.randn(64, 32, device=dev)
    torch.testing.assert_close(prog(x2, w2), torch.relu(x2.to(dev) @ w2) + 1.0, rtol=0,
                               atol=1e-5)
    bad = pc.cached_program("t.sync", 0, lambda: lambda x: x * x.sum().item())
    with pytest.raises(RuntimeError, match="t.sync"):
        bad(torch.ones(4, device=dev))
    pc.reset()


def test_program_cache_shares_parameters_and_recopies_host_tensors(dev):
    """The programs of one parameter set (``params_from``, ``params_key``)
    read one set of static parameter buffers on the card, copied into once
    a change; a host tensor refilled through numpy (its version counter
    does not move) gives the new answer; ``tf32=False`` captures the
    product with TF32 off (within f32 rounding of float64) and restores
    the caller's flag."""
    from heat_tpu_torch.core import program_cache as pc

    pc.reset()
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.standard_normal((256, 64)).astype(np.float32)).to(dev)

    def make():
        return lambda x, w: x @ w

    progs = {b: pc.cached_program("t.shared", b, make, params_from=1, params_key="w", tf32=False)
             for b in (4, 16)}
    stage = torch.from_numpy(np.zeros((4, 256), np.float32))
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        for b, prog in progs.items():
            prog(torch.zeros(b, 256), w)
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    p4, p16 = progs[4].__wrapped__, progs[16].__wrapped__
    assert p4.shared is p16.shared and p4.param_bytes() == w.numel() * 4
    assert p4.shared.static[0].data_ptr() == p16.shared.static[0].data_ptr()
    for fill in (1.0, 2.0, 3.0):
        stage.numpy()[:] = rng.standard_normal((4, 256)).astype(np.float32) * fill
        got = progs[4](stage, w).double()
        want = stage.double().to(dev) @ w.double()
        bound = 256 * 2.0 ** -24 * (stage.double().abs().to(dev) @ w.double().abs())
        assert bool(((got - want).abs() <= bound).all()), "stale batch or a TF32 product"
    w2 = torch.from_numpy(rng.standard_normal((256, 64)).astype(np.float32)).to(dev)
    x16 = torch.from_numpy(rng.standard_normal((16, 256)).astype(np.float32))
    torch.testing.assert_close(progs[16](x16, w2), x16.to(dev) @ w2, rtol=1e-5, atol=1e-4)
    assert p4.shared.last[0][0] is w2
    torch.testing.assert_close(progs[4](stage, w), stage.to(dev) @ w, rtol=1e-5, atol=1e-4)
    pc.reset()


def test_serve_exact_forms_batched_equal_solo_on_card(dev):
    """Every endpoint kind on the card in exact mode: a request inside a
    padded coalesced bucket is the same bits as alone (the halving-tree
    sums), and the answers agree with the same endpoints on the CPU within
    f32 rounding (labels on separated blobs exactly)."""
    from heat_tpu_torch import serve

    rng = np.random.default_rng(0)
    protos = rng.standard_normal((4, 32)) * 8
    xt = (protos[rng.integers(0, 4, 400)] + rng.standard_normal((400, 32))).astype(np.float32)
    labels = rng.integers(0, 4, 400)
    w = rng.standard_normal((32, 8)).astype(np.float32)
    b = rng.standard_normal(8).astype(np.float32)
    eps = {
        "km": lambda d: serve.Endpoint("kmeans_predict", [protos.astype(np.float32)],
                                       features=32, dtype=np.float32, device=d),
        "knn": lambda d: serve.Endpoint("knn_classify", [xt, labels, np.arange(4)], {"k": 5},
                                        features=32, dtype=np.float32, device=d),
        "gnb": lambda d: serve.Endpoint("gaussian_nb_predict",
                                        [protos, np.ones((4, 32)), np.full(4, 0.25),
                                         np.arange(4)], features=32, dtype=np.float64, device=d),
        "lasso": lambda d: serve.Endpoint("lasso_predict", [w[:, 0], np.float32(0.5)],
                                          features=32, dtype=np.float32, device=d),
        "cdist": lambda d: serve.cdist_query(xt[:64], device=d),
        "rbf": lambda d: serve.rbf_query(xt[:64], sigma=4.0, device=d),
        "dense": lambda d: serve.dense_forward(w, b, activation="tanh", device=d),
        "sparse": lambda d: serve.sparse_query(w, b, activation="relu", device=d),
    }
    for name, make in eps.items():
        dtype = np.float64 if name == "gnb" else np.float32
        payloads = []
        for r in (1, 3, 2, 7, 1, 5):
            q = (protos[rng.integers(0, 4, r)] + rng.standard_normal((r, 32))).astype(dtype)
            if name == "sparse":
                q[rng.random(q.shape) < 0.7] = 0
            payloads.append(q)
        with serve.Server(max_batch=16, max_wait_ms=20.0) as card, \
                serve.Server(max_batch=16) as cpu:
            card.register("e", make("cuda"))
            cpu.register("e", make("cpu"))
            card.warmup()
            solo = [card.predict("e", q) for q in payloads]
            batched = [f.result(60) for f in [card.submit("e", q) for q in payloads]]
            for s, bt, q in zip(solo, batched, payloads):
                assert s.tobytes() == bt.tobytes(), name
                ref = cpu.predict("e", q)
                if name in ("km", "knn", "gnb"):
                    np.testing.assert_array_equal(s, ref)
                else:
                    np.testing.assert_allclose(s, ref, rtol=1e-5, atol=1e-5)


# -- data and observability (utils.data, telemetry.memory) ---------------------------------------


def test_data_device_memory_stats_on_card(dev):
    """The caching allocator's counters under the JAX package's names:
    ``peak_bytes_in_use`` is ``torch.cuda.max_memory_allocated``."""
    from heat_tpu_torch.telemetry import memory

    x = torch.empty((1 << 20,), device=dev)
    stats = memory.device_memory_stats()
    s = stats["cuda:0"]
    assert s["bytes_in_use"] == torch.cuda.memory_allocated(0) >= x.numel() * 4
    assert s["peak_bytes_in_use"] == torch.cuda.max_memory_allocated(0)
    assert s["bytes_limit"] == torch.cuda.get_device_properties(0).total_memory
    a = htt.array(np.zeros((256, 16), np.float32), split=0, device="gpu")
    snap = memory.watermark()
    assert snap["per_device"]["cuda:0"] >= 256 * 16 * 4 and "cuda:0" in snap["device_stats"]
    del x, a


def test_data_loader_batches_land_on_card_from_pinned_memory(dev):
    """A host dataset's batches go to cuda:0 through pinned memory; a card
    dataset's batches stay on it. Both give the host loader's rows."""
    htt.use_device("cpu")
    rng = np.random.default_rng(3)
    x = rng.standard_normal((100, 8)).astype(np.float32)
    y = np.arange(100, dtype=np.int64)
    host = htt.utils.data.Dataset(htt.array(x, split=0), targets=htt.array(y, split=0))
    want = [(b[0].numpy(), b[1].numpy()) for b in htt.utils.data.DataLoader(host, batch_size=16)]
    host = htt.utils.data.Dataset(htt.array(x, split=0), targets=htt.array(y, split=0))
    loader = htt.utils.data.DataLoader(host, batch_size=16, device="gpu")
    got = list(loader)
    assert len(got) == len(want) == 7
    for (xb, yb), (wx, wy) in zip(got, want):
        assert xb.larray.device == dev and yb.larray.device == dev
        assert np.array_equal(xb.numpy(), wx) and np.array_equal(yb.numpy(), wy)
    htt.use_device("gpu")
    card = htt.utils.data.Dataset(htt.array(x, split=0), targets=htt.array(y, split=0))
    for (xb, yb), (wx, wy) in zip(htt.utils.data.DataLoader(card, batch_size=16), want):
        assert xb.larray.device == dev and np.array_equal(yb.numpy(), wy)
    htt.use_device(None)


def test_data_partial_h5_dataset_on_card(dev, tmp_path):
    """Batches of an HDF5 file on the card through the pinned staging
    buffers: the host iterator's rows, bit for bit."""
    h5py = pytest.importorskip("h5py")
    rng = np.random.default_rng(5)
    data = rng.standard_normal((5000, 16)).astype(np.float32)
    path = str(tmp_path / "d.h5")
    with h5py.File(path, "w") as f:
        f["data"] = data
    host = htt.utils.data.PartialH5Dataset(path, initial_load=1000, load_length=700,
                                           device="cpu")
    card = htt.utils.data.PartialH5Dataset(path, initial_load=1000, load_length=700,
                                           device="gpu")
    try:
        want = [b[0].numpy() for b in htt.utils.data.PartialDataLoaderIter(host, 256, seed=1)]
        got = list(htt.utils.data.PartialDataLoaderIter(card, 256, seed=1))
        assert len(got) == len(want) == 19
        for (b,), w in zip(got, want):
            assert b.larray.device == dev and np.array_equal(b.numpy(), w)
    finally:
        host.close()
        card.close()


def test_data_partial_memmap_dataset_on_card(dev, tmp_path):
    """PartialDataset over a .npy memory map on the card (the HDF5 class
    without h5py): the host iterator's rows, bit for bit, shuffled."""
    rng = np.random.default_rng(6)
    data = rng.standard_normal((5000, 16)).astype(np.float32)
    np.save(tmp_path / "d.npy", data)
    mm = np.load(tmp_path / "d.npy", mmap_mode="r")
    host = htt.utils.data.PartialDataset({"x": mm}, initial_load=1000, load_length=700,
                                         device="cpu")
    card = htt.utils.data.PartialDataset({"x": mm}, initial_load=1000, load_length=700,
                                         device="gpu")
    want = [b[0].numpy() for b in htt.utils.data.PartialDataLoaderIter(host, 256, seed=1)]
    got = list(htt.utils.data.PartialDataLoaderIter(card, 256, seed=1))
    assert len(got) == len(want) == 19
    for (b,), w in zip(got, want):
        assert b.larray.device == dev and np.array_equal(b.numpy(), w)
    assert card.stats["rows"] == 5000 and card.stats["read_seconds"] > 0


def test_fusion_flush_inside_a_capture_is_recorded_into_it(dev):
    """A pending chain read inside another program's CUDA graph capture runs
    inline into that capture (no capture of its own), and the graph's replay
    gives the eager bits."""
    from heat_tpu_torch.core import fusion

    htt.use_device("gpu")
    try:
        xn = np.arange(12.0, dtype=np.float32).reshape(3, 4)
        x = htt.array(xn)
        with fusion.fusing(False):
            want = (htt.exp(x) * 2.0 + 1.0).larray.clone()
        out = {}
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            pending = htt.exp(x) * 2.0 + 1.0
            assert pending._fused_node() is not None
            out["r"] = pending.larray
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out["r"], want)
    finally:
        htt.use_device("cpu")


# -- the autotuner on the card ------------------------------------------------------------------

_CDIST_VARIANTS = {"bf16x3": "3xtf32_wgmma", "high": "3xtf32_wgmma", "default": "tf32_wgmma",
                   "highest": "f32_fma_stream"}


def _cdist_tune(tmp_path, rows=4096):
    from heat_tpu_torch import _knobs, autotune

    htt.random.seed(0)
    x = htt.random.rand(rows, 128, dtype=htt.float32, split=0)
    seen = {}

    def work():
        out = htt.spatial.cdist(x, x, quadratic_expansion=True).larray
        seen.setdefault(_knobs.default_raw("HEAT_TPU_CDIST_PREC"), set()).add(
            cuda_cdist.last_variant())
        return out

    res = autotune.tune("cdist", work, signature=("cdist", (rows, 128), "float32"),
                        search=["HEAT_TPU_CDIST_PREC"], error_budget=1e-3, trials_per_config=3,
                        db_dir=str(tmp_path / "db"), adopt=False)
    return res, seen


def test_autotune_cdist_trials_launch_the_named_variants(dev, tmp_path):
    """Each HEAT_TPU_CDIST_PREC candidate's trials launch the K3 variant it
    names; the pick is no slower than the default, a lossy pick is within
    the 1e-3 budget, and the record is stored."""
    from heat_tpu_torch import autotune
    from heat_tpu_torch.autotune import db

    autotune.reset()
    res, seen = _cdist_tune(tmp_path)
    assert {k: v for k, v in seen.items()} == {k: {v} for k, v in _CDIST_VARIANTS.items()}
    rec = res.record
    assert rec["tuned_wall"] <= rec["baseline_wall"]
    assert rec["validation"] == "digest" or rec["max_rel_err"] <= 1e-3
    assert db.TuneDB(str(tmp_path / "db")).lookup(res.key)["config"] == res.config


def test_autotune_cdist_warm_start_in_a_fresh_process(dev, tmp_path):
    """A fresh process with HEAT_TPU_AUTOTUNE=1 and the same HEAT_TPU_TUNE_DB
    adopts the pick with zero trials into the knob overlay, and its cdist
    launches the picked variant."""
    from heat_tpu_torch import autotune

    autotune.reset()
    res, _ = _cdist_tune(tmp_path)
    repo = Path(__file__).resolve().parent.parent
    script = (
        "import heat_tpu_torch as ht\n"
        "from heat_tpu_torch import _knobs, autotune, telemetry\n"
        "from heat_tpu_torch.spatial.cuda_cdist import last_variant\n"
        "telemetry.enable()\n"
        "ht.random.seed(0)\n"
        "x = ht.random.rand(4096, 128, dtype=ht.float32, split=0)\n"
        "r = autotune.tune('cdist', lambda: ht.spatial.cdist(x, x, quadratic_expansion=True)"
        ".larray, signature=('cdist', (4096, 128), 'float32'), search=['HEAT_TPU_CDIST_PREC'],"
        " error_budget=1e-3, trials_per_config=3)\n"
        "ht.spatial.cdist(x, x, quadratic_expansion=True).larray\n"
        "print('WARM', r.from_db, r.trials_run, "
        "int(telemetry.get_registry().counters.get('autotune.trials', 0)), r.config, "
        "last_variant(), _knobs.raw('HEAT_TPU_CDIST_PREC'), autotune.adopted())\n")
    env = dict(os.environ, HEAT_TPU_AUTOTUNE="1", HEAT_TPU_TUNE_DB=str(tmp_path / "db"))
    out = subprocess.run([sys.executable, "-c", script], cwd=repo, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("WARM")][-1]
    pick = res.config["HEAT_TPU_CDIST_PREC"]
    assert line == (f"WARM True 0 0 {res.config} {_CDIST_VARIANTS[pick]} {pick} "
                    f"{ {'cdist': res.config} }")
