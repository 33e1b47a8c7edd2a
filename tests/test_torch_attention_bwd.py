"""The flash-attention backward against heat_tpu's, on the CPU.

The same numpy inputs and cotangent go through ``jax.grad`` of heat_tpu's
``flash_attention`` (the Pallas kernels run by the interpreter,
``interpret=True``) and through the port's ``flash_attention`` under
autograd, whose backward on a CPU tensor is ``flash_attention_bwd_plain``.
Both backward schedules are held: ``"two_pass"`` (kernels K7a and K7b on
the card) and ``"fused"`` (K8).

Tolerances, each against the largest magnitude of the reference gradient:

- f32: within 1e-5 (both sides sum exact f32 products over a few hundred
  keys in other orders, and exponentiate with their own ``exp``; the error
  seen is ~7e-7);
- bf16: the inputs are the same bf16 values and every product is exact in
  f32, but each side rounds O (hence D), p and dS to bf16 at its own
  points, and a value near a rounding boundary goes the other way. The
  relative RMS error is held within 2e-3 (seen: up to 3.6e-4) and the
  largest within 2^-6 (seen: up to 4e-3; one bf16 ulp is 2^-8 relative).

The oracle independent of both is autograd through the plain forward in
float64, against which the plain backward in f32 is held within 1e-5 of
each gradient's largest magnitude.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from heat_tpu.parallel import pallas_attention as jpal

from heat_tpu_torch import _build
from heat_tpu_torch.parallel import cuda_attention

F32_TOL = 1e-5
BF16_RMS = 2e-3
BF16_MAX = 2.0 ** -6

# b, t_q, t_k, h, d, causal, kv_valid: tests/test_pallas_attention.py's
# backward shapes (:156-159, :225-227) and two ragged T_q != T_k cases
SHAPES = [
    (1, 256, 256, 2, 64, False, None),
    (2, 384, 384, 2, 32, True, None),
    (1, 300, 300, 1, 64, False, 260),
    (1, 128, 128, 2, 128, True, 100),
    (1, 256, 256, 2, 64, True, 200),
    (1, 50, 77, 2, 24, False, 60),
    (1, 70, 45, 2, 16, True, 30),
]
FUSED_SHAPES = [SHAPES[i] for i in (0, 1, 4, 5, 6)]


def _inputs(b, t_q, t_k, h, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, t_q, h, d), (b, t_k, h, d), (b, t_k, h, d), (b, t_q, h, d))]


def _jax_grads(arrays, dtype, causal, kv_valid, bwd_impl):
    jq, jk, jv, jg = (jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrays)

    def loss(q, k, v):
        out = jpal.flash_attention(q, k, v, causal=causal, kv_valid=kv_valid, interpret=True,
                                   bwd_impl=bwd_impl)
        return (out.astype(jnp.float32) * jg.astype(jnp.float32)).sum()

    grads = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
    return [np.asarray(g.astype(jnp.float32)) for g in grads]


def _torch_grads(arrays, dtype, causal, kv_valid, bwd_impl):
    q, k, v = (torch.from_numpy(a).to(getattr(torch, dtype)).requires_grad_() for a in arrays[:3])
    g = torch.from_numpy(arrays[3]).to(getattr(torch, dtype))
    out = cuda_attention.flash_attention(q, k, v, causal=causal, kv_valid=kv_valid,
                                         bwd_impl=bwd_impl)
    out.backward(g)
    for x in (q, k, v):
        assert x.grad.dtype == x.dtype and x.grad.shape == x.shape
    return [x.grad.float().numpy() for x in (q, k, v)]


def _assert_close(got, want, dtype):
    for name, a, w in zip("qkv", got, want):
        peak = max(np.abs(w).max(), 1e-30)
        err = np.abs(a - w).max() / peak
        if dtype == "float32":
            assert err <= F32_TOL, (name, err)
            continue
        rms = np.sqrt(((a - w) ** 2).sum() / max((w ** 2).sum(), 1e-30))
        assert rms <= BF16_RMS, (name, rms)
        assert err <= BF16_MAX, (name, err)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,t_q,t_k,h,d,causal,kv_valid", SHAPES)
def test_two_pass_grads_match_jax_kernels(dtype, b, t_q, t_k, h, d, causal, kv_valid):
    arrays = _inputs(b, t_q, t_k, h, d, t_q + d)
    want = _jax_grads(arrays, dtype, causal, kv_valid, "two_pass")
    _assert_close(_torch_grads(arrays, dtype, causal, kv_valid, "two_pass"), want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,t_q,t_k,h,d,causal,kv_valid", FUSED_SHAPES)
def test_fused_grads_match_jax_fused_kernel(dtype, b, t_q, t_k, h, d, causal, kv_valid):
    arrays = _inputs(b, t_q, t_k, h, d, 17 + t_k)
    want = _jax_grads(arrays, dtype, causal, kv_valid, "fused")
    _assert_close(_torch_grads(arrays, dtype, causal, kv_valid, "fused"), want, dtype)


@pytest.mark.parametrize("bwd_impl", ["two_pass", "fused"])
def test_kv_valid_zero_gives_zero_grads(bwd_impl):
    """Every key masked: O is 0, the LSE +1e30, so p and every gradient are
    exactly 0, as in the JAX kernels."""
    arrays = _inputs(1, 40, 40, 2, 16, 3)
    want = _jax_grads(arrays, "float32", False, 0, bwd_impl)
    got = _torch_grads(arrays, "float32", False, 0, bwd_impl)
    for a, w in zip(got, want):
        assert (a == 0).all() and (w == 0).all()


@pytest.mark.parametrize("causal,kv_valid", [(True, None), (False, 50), (True, 20)])
def test_plain_backward_matches_float64_autograd(causal, kv_valid):
    """An oracle independent of both packages: autograd through the plain
    forward in float64."""
    arrays = _inputs(2, 64, 80, 2, 16, 11)
    q, k, v = (torch.from_numpy(a) for a in arrays[:3])
    g = torch.from_numpy(arrays[3])
    scale = 0.3
    out, lse = cuda_attention.flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                                    kv_valid=kv_valid, return_lse=True)
    got = cuda_attention.flash_attention_bwd_plain(q, k, v, out, lse, g, causal=causal,
                                                   scale=scale, kv_valid=kv_valid, block_k=32)
    q64, k64, v64 = (x.double().requires_grad_() for x in (q, k, v))
    cuda_attention.flash_attention_plain(q64, k64, v64, causal=causal, scale=scale,
                                         kv_valid=kv_valid, block_k=32).backward(g.double())
    for x, want in zip(got, (q64.grad, k64.grad, v64.grad)):
        assert x.dtype == torch.float32
        torch.testing.assert_close(x.double(), want, rtol=0,
                                   atol=F32_TOL * want.abs().max().item())


def test_plain_backward_block_k_changes_only_summation_order():
    arrays = _inputs(1, 48, 300, 2, 8, 5)
    q, k, v, g = (torch.from_numpy(a) for a in arrays)
    out, lse = cuda_attention.flash_attention_plain(q, k, v, causal=True, scale=0.5,
                                                    return_lse=True)
    a = cuda_attention.flash_attention_bwd_plain(q, k, v, out, lse, g, causal=True, scale=0.5,
                                                 block_k=128)
    b = cuda_attention.flash_attention_bwd_plain(q, k, v, out, lse, g, causal=True, scale=0.5,
                                                 block_k=1024)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=F32_TOL * y.abs().max().item())


def test_auto_resolves_by_the_ports_rule(monkeypatch):
    """``"auto"`` takes the two-pass backward for the operands the Hopper
    kernels take, at any length; for the others the fused backward up to
    ``_FUSED_MAX_T_Q`` query rows and the two-pass one past it; the choice
    depends on shapes only."""
    limit = cuda_attention._FUSED_MAX_T_Q
    assert cuda_attention._resolve_bwd_impl("auto", limit) == "fused"
    assert cuda_attention._resolve_bwd_impl("auto", limit + 1) == "two_pass"
    for impl in ("two_pass", "fused"):
        assert cuda_attention._resolve_bwd_impl(impl, 1) == impl
        assert cuda_attention._resolve_bwd_impl(impl, 1, "bf16_wgmma") == impl
    # the operands that the Hopper K7a and K7b take go to them at any length
    for t_q in (1, limit, 100 * limit):
        assert cuda_attention._resolve_bwd_impl("auto", t_q, "bf16_wgmma") == "two_pass"
    for variant in ("f32", "bf16_mma", "bf16_scalar"):
        assert cuda_attention._resolve_bwd_impl("auto", limit + 1, variant) == "two_pass"
    x = torch.zeros((1, 8, 2, 64), dtype=torch.bfloat16)
    assert cuda_attention._bwd_variant(x, x, x, x) == "bf16_wgmma"
    assert cuda_attention._bwd_variant(*[x[..., :32].contiguous()] * 4) == "bf16_mma"
    off = torch.zeros(8 * 2 * 64 + 8, dtype=torch.bfloat16)[1:-7].view(1, 8, 2, 64)
    assert off.data_ptr() % 16 == 2  # a cotangent whose base is not 16-byte aligned
    assert cuda_attention._bwd_variant(x, x, x, off) == "bf16_scalar"
    assert cuda_attention._bwd_variant(*[x.float()] * 4) == "f32"
    taken = []
    real = {name: getattr(cuda_attention, name) for name in ("_flash_bwd", "_flash_bwd_fused")}
    for name, fn in real.items():
        monkeypatch.setattr(cuda_attention, name,
                            lambda *a, _n=name, _f=fn: taken.append(_n) or _f(*a))
    arrays = _inputs(1, 32, 32, 1, 8, 2)
    _torch_grads(arrays, "float32", True, None, "auto")
    assert taken == ["_flash_bwd_fused"]


def test_dispatch_rejects_unknown_bwd_impl():
    q = torch.zeros((1, 4, 1, 8))
    lse = torch.zeros((1, 1, 4))
    with pytest.raises(ValueError, match="bwd_impl"):
        cuda_attention._flash_bwd_dispatch("three_pass", q, q, q, q, lse, q, 1.0, False, 4)


def test_forward_without_grad_computes_no_lse(monkeypatch):
    """As the JAX package's primal ``_flash``: a call that records no graph
    runs the forward alone, without the LSE; one that does keeps it."""
    calls = []
    real = cuda_attention._flash_forward

    def spy(*args, **kwargs):
        calls.append(kwargs.get("return_lse", False))
        return real(*args, **kwargs)

    monkeypatch.setattr(cuda_attention, "_flash_forward", spy)
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in _inputs(1, 16, 16, 1, 8, 4)[:3])
    with torch.no_grad():
        out = cuda_attention.flash_attention(q, k, v, causal=True)
    assert calls == [False] and out.grad_fn is None
    cuda_attention.flash_attention(q.detach(), k.detach(), v.detach(), causal=True)
    assert calls == [False, False]
    out = cuda_attention.flash_attention(q, k, v, causal=True)
    assert calls == [False, False, True] and out.grad_fn is not None


def test_grads_flow_to_only_the_inputs_that_need_them():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 24, 24, 2, 8, 6)[:3])
    k.requires_grad_()
    cuda_attention.flash_attention(q, k, v, causal=True).sum().backward()
    assert q.grad is None and v.grad is None and k.grad is not None
    assert bool(torch.isfinite(k.grad).all())


def test_one_launch_counter_per_backward_kernel():
    """flash_bwd holds three kernels, each with its own counter; a name that
    is no kernel's raises."""
    assert "flash_bwd" in _build.SOURCES
    for name in ("flash_bwd_dq", "flash_bwd_dkv", "flash_bwd_fused"):
        assert name in _build.KERNELS
    before = _build.launch_counts()
    with pytest.raises(KeyError, match="flash_bwd"):
        _build.count_launch("flash_bwd")
    assert _build.launch_counts() == before


# ------------------------------------- K8's workspace and the "auto" rule

@pytest.mark.parametrize("b,h,t_q,d", [(2, 3, 64, 64), (1, 2, 65, 128), (2, 1, 1, 64),
                                       (1, 4, 300, 64)])
def test_dq_workspace_shape_padding_and_read_back(b, h, t_q, d):
    """The wgmma K8's workspace is (B, H, T_q rounded up to 64, D) f32 and
    zeroed; the read-back drops the padding, transposes to (B, T_q, H, D),
    casts and is contiguous."""
    ws = cuda_attention._dq_workspace(b, h, t_q, d, torch.device("cpu"))
    t_pad = -(-t_q // 64) * 64
    assert ws.shape == (b, h, t_pad, d) and ws.dtype == torch.float32
    assert ws.is_contiguous() and bool((ws == 0).all())
    # a 64-row tile of one head is one contiguous run of 64 * d floats
    assert ws.stride() == (h * t_pad * d, t_pad * d, d, 1)
    rng = np.random.default_rng(t_q)
    dq = torch.from_numpy(rng.standard_normal((b, t_q, h, d)).astype(np.float32))
    ws[:, :, :t_q] = dq.transpose(1, 2)
    ws[:, :, t_q:] = 7.0  # whatever lies in the padding is dropped
    for dtype in (torch.bfloat16, torch.float32):
        back = cuda_attention._dq_from_workspace(ws, t_q, dtype)
        assert back.shape == (b, t_q, h, d) and back.dtype == dtype and back.is_contiguous()
        assert torch.equal(back, dq.to(dtype))


@pytest.mark.parametrize("b,t_q,t_k,h,d,causal,kv_valid", [SHAPES[0], SHAPES[4], SHAPES[3]])
def test_fused_wrapper_around_the_plain_backward(b, t_q, t_k, h, d, causal, kv_valid):
    """The wrapper's Python around K8, with the plain backward in the
    kernel's place: 64-row f32 dQ partials of each 64-key tile are added
    into the workspace tile by tile, as the bulk reduce-add does, and the
    read-back equals the plain dQ up to the order of the f32 sums."""
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16)
                   for a in _inputs(b, t_q, t_k, h, d, 11 * t_q + d))
    scale = d ** -0.5
    kv = t_k if kv_valid is None else kv_valid
    o, lse = cuda_attention._flash_forward(q, k, v, scale, causal, kv, return_lse=True)
    want = cuda_attention.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                                    scale=scale, kv_valid=kv)
    ws = cuda_attention._dq_workspace(b, h, t_q, d, q.device)
    flat = ws.view(b * h, -1)  # a head's padded rows, contiguous
    for k0 in range(0, t_k, 64):  # one key tile's partial, kept in f32
        part = _dq_partial(q, k, v, o, lse, do, scale, causal, kv, k0)
        for q0 in range(0, t_q, 64):
            rows = part[:, :, q0:q0 + 64]
            tile = torch.zeros((b * h, 64 * d))
            tile[:, :rows.shape[2] * d] = rows.reshape(b * h, -1)
            flat[:, q0 * d:(q0 + 64) * d] += tile  # one contiguous 64 x d add
    got = cuda_attention._dq_from_workspace(ws, t_q, q.dtype)
    peak = want[0].float().abs().max().item()
    assert (got.float() - want[0].float()).abs().max().item() <= BF16_MAX * peak


def _dq_partial(q, k, v, o, lse, do, scale, causal, kv_end, k0):
    """dS K of the keys [k0, k0 + 64) in f32, (B, H, T_q, D), with p and dS
    rounded to bf16 before their products as the kernels round them."""
    kb, vb = k[:, k0:k0 + 64].float(), v[:, k0:k0 + 64].float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kb) * scale
    k_pos = k0 + torch.arange(kb.shape[1])
    mask = (k_pos < kv_end)[None, :]
    if causal:
        mask = mask & (k_pos[None, :] <= torch.arange(q.shape[1])[:, None])
    p = torch.where(mask, torch.exp(s - lse[..., None]), torch.zeros(()))
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), vb)
    dd = (do.float() * o.float()).sum(-1).transpose(1, 2)[..., None]
    ds = (p * (dp - dd) * scale).to(q.dtype).float()
    return torch.einsum("bhqk,bkhd->bhqd", ds, kb)


# ------------------------- the Hopper two-pass backward's routing and wrapper

def _two_pass_operands(b, t_q, t_k, h, d, dtype, causal, kv_valid, transposed=False):
    """q, k, v, O, LSE and dO on the CPU as the wrapper gets them, O and the
    LSE from the plain forward."""
    q, k, v, do = (torch.from_numpy(a).to(dtype) for a in _inputs(b, t_q, t_k, h, d, 7 * t_q + d))
    if transposed:  # (B, H, T, D) memory behind the (B, T, H, D) view
        q, k, v, do = (x.transpose(1, 2).contiguous().transpose(1, 2) for x in (q, k, v, do))
    scale = d ** -0.5
    o, lse = cuda_attention.flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                                  kv_valid=kv_valid, return_lse=True)
    return q, k, v, o, lse, do, scale, causal, kv_valid


def _spy_launchers(monkeypatch):
    """Records each backward launcher the two-pass wrapper calls, with its
    arguments, and whether the plain D prologue ran; launches nothing."""
    calls = []
    monkeypatch.setattr(cuda_attention, "_launch_bwd",
                        lambda name, *a: calls.append((name, a)))
    monkeypatch.setattr(cuda_attention, "_launch_dq_wgmma",
                        lambda *a: calls.append(("dq_wgmma", a)))
    monkeypatch.setattr(cuda_attention, "_launch_dkv_wgmma",
                        lambda *a: calls.append(("dkv_wgmma", a)))
    real = cuda_attention._row_terms
    monkeypatch.setattr(cuda_attention, "_row_terms",
                        lambda o, do: calls.append(("row_terms", ())) or real(o, do))
    return calls


@pytest.mark.parametrize("d,dtype,transposed,misaligned_do,old_kernel,hopper", [
    (64, torch.bfloat16, False, False, False, True),
    (128, torch.bfloat16, True, False, False, True),
    (64, torch.bfloat16, False, False, True, False),    # _old_kernel
    (32, torch.bfloat16, False, False, False, False),   # D off the Hopper gate
    (64, torch.float32, False, False, False, False),    # f32
    (64, torch.bfloat16, False, True, False, False),    # dO's base not on 16 bytes
])
def test_two_pass_routes_by_the_variant_rule(monkeypatch, d, dtype, transposed, misaligned_do,
                                             old_kernel, hopper):
    """The inputs that _attention_variant calls "bf16_wgmma" reach the
    wgmma K7a and K7b, which share one D buffer that K7a fills, with no
    plain prologue; every other input, or _old_kernel, reaches the
    mma.sync or f32 kernels after the plain prologue."""
    b, t_q, t_k, h = 1, 40, 56, 2
    q, k, v, o, lse, do, scale, causal, kv = _two_pass_operands(b, t_q, t_k, h, d, dtype, True,
                                                                50, transposed)
    if misaligned_do:
        flat = torch.zeros(do.numel() + 8, dtype=dtype)[1:-7]
        do = flat.view(do.shape).copy_(do)
        assert do.data_ptr() % 16 != 0
    calls = _spy_launchers(monkeypatch)
    dq, dk, dv = cuda_attention._two_pass_kernels(q, k, v, o, lse, do, scale, causal, kv,
                                                  old_kernel)
    assert dq.shape == q.shape and dk.shape == k.shape and dv.shape == v.shape
    assert dq.dtype == dk.dtype == dv.dtype == dtype
    names = [name for name, _ in calls]
    if not hopper:
        assert names == ["row_terms", "flash_bwd_dq", "flash_bwd_dkv"]
        return
    assert names == ["dq_wgmma", "dkv_wgmma"]
    dq_args, dkv_args = calls[0][1], calls[1][1]
    dd = dq_args[6]
    assert dd is dkv_args[5]  # K7b reads the buffer that K7a writes
    assert dd.shape == (b, h, t_q) and dd.dtype == torch.float32 and dd.is_contiguous()
    assert dq_args[7] is dq and dkv_args[6] is dk and dkv_args[7] is dv
    assert dq_args[-1] == cuda_attention._bwd_dq_tiles(t_q, d)
    assert dkv_args[-1] == cuda_attention._bwd_dkv_stages(d)
    assert dq_args[8:11] == (scale, causal, kv) and dkv_args[8:11] == (scale, causal, kv)


@pytest.mark.parametrize("t_q,t_k", [(0, 24), (24, 0)])
def test_two_pass_sends_empty_inputs_to_the_old_kernels(monkeypatch, t_q, t_k):
    """No tensor map spans a dimension of size 0: an empty T_q or T_k goes
    to the mma.sync kernels, which return zeros of the right shapes."""
    q, k, v, do = (torch.zeros((1, t, 2, 64), dtype=torch.bfloat16) for t in (t_q, t_k, t_k, t_q))
    lse = torch.full((1, 2, t_q), 1e30)
    calls = _spy_launchers(monkeypatch)
    dq, dk, dv = cuda_attention._two_pass_kernels(q, k, v, do, lse, do, 0.125, True, t_k)
    assert [name for name, _ in calls] == ["row_terms", "flash_bwd_dq", "flash_bwd_dkv"]
    assert dq.shape == q.shape and dk.shape == k.shape and dv.shape == v.shape


def test_two_pass_hands_k7a_an_aligned_o(monkeypatch):
    """K7a reads O by 16-byte loads: an O whose rows do not start on 16
    bytes reaches it as a contiguous copy, an aligned one as it is."""
    q, k, v, o, lse, do, scale, causal, kv = _two_pass_operands(1, 24, 24, 2, 64,
                                                                torch.bfloat16, True, 24)
    flat = torch.zeros(o.numel() + 8, dtype=o.dtype)[1:-7]
    o_off = flat.view(o.shape).copy_(o)
    assert not cuda_attention._rows_aligned(o_off) and cuda_attention._rows_aligned(o)
    for given, copied in ((o, False), (o_off, True)):
        calls = _spy_launchers(monkeypatch)
        cuda_attention._two_pass_kernels(q, k, v, given, lse, do, scale, causal, kv)
        passed = calls[0][1][4]
        assert cuda_attention._rows_aligned(passed) and torch.equal(passed, o)
        assert (passed is not given) == copied


@pytest.mark.parametrize("t_q", [1, 64, 65, 1024, 4096])
@pytest.mark.parametrize("d", [64, 128])
def test_bwd_tile_rules_pick_what_the_kernels_take(t_q, d):
    """The wgmma K7a's (rows a block, keys a tile) and K7b's ring slots are
    among the instantiations the C entries take (128 x 64 only at D = 128),
    and depend on shapes only."""
    bm, bn = cuda_attention._bwd_dq_tiles(t_q, d)
    assert bm in (64, 128) and bn in (64, 128) and not (d == 128 and (bm, bn) != (128, 64))
    assert cuda_attention._bwd_dkv_stages(d) in (2, 4)
    assert cuda_attention._bwd_dq_tiles(t_q, d) == (bm, bn)


def _plain_k7a(q, k, v, do, o, lse, dd, dq, scale, causal, kv_valid, tiles):
    """K7a's function in plain torch, in the wgmma launcher's place: D of
    every row into ``dd`` and dQ into ``dq``."""
    dd.copy_(cuda_attention._row_terms(o, do))
    dq.copy_(_blockwise_two_pass(q, k, v, do, lse, dd, scale, causal, kv_valid)[0])


def _plain_k7b(q, k, v, do, lse, dd, dk, dv, scale, causal, kv_valid, stages):
    """K7b's function in plain torch, reading D from the buffer it is
    handed, as the kernel does."""
    _, dk_, dv_ = _blockwise_two_pass(q, k, v, do, lse, dd, scale, causal, kv_valid)
    dk.copy_(dk_)
    dv.copy_(dv_)


def _blockwise_two_pass(q, k, v, do, lse, dd, scale, causal, kv_end):
    """dQ, dK, dV in f32 from a given D, 64-key tile by tile, with p and dS
    rounded to the input dtype before their products, as the kernels do."""
    t_q, t_k = q.shape[1], k.shape[1]
    qf, dof = q.float(), do.float()
    q_pos = torch.arange(t_q)
    outs = [torch.zeros(x.shape) for x in (q, k, v)]
    for k0 in range(0, t_k, 64):
        kb, vb = k[:, k0:k0 + 64].float(), v[:, k0:k0 + 64].float()
        k_pos = k0 + torch.arange(kb.shape[1])
        mask = (k_pos < kv_end)[None, :]
        if causal:
            mask = mask & (k_pos[None, :] <= q_pos[:, None])
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kb) * scale
        p = torch.where(mask, torch.exp(s - lse[..., None]), torch.zeros(()))
        dp = torch.einsum("bqhd,bkhd->bhqk", dof, vb)
        ds = (p * (dp - dd[..., None]) * scale).to(q.dtype).float()
        outs[0] += torch.einsum("bhqk,bkhd->bqhd", ds, kb)
        outs[1][:, k0:k0 + 64] = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
        outs[2][:, k0:k0 + 64] = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), dof)
    return outs


@pytest.mark.parametrize("b,t_q,t_k,h,d,causal,kv_valid,transposed", [
    (1, 100, 137, 2, 64, True, 137, False),
    (2, 70, 45, 1, 128, False, 30, True),
    (1, 64, 64, 2, 64, True, 0, False),
])
def test_two_pass_wrapper_around_the_plain_kernels(monkeypatch, b, t_q, t_k, h, d, causal,
                                                   kv_valid, transposed):
    """The wrapper's Python around the wgmma K7a and K7b, with plain
    functions in the kernels' place: K7a fills the D buffer, K7b reads it,
    and the gradients equal the plain backward's within the bf16
    tolerance (only the order of the f32 sums differs)."""
    args = _two_pass_operands(b, t_q, t_k, h, d, torch.bfloat16, causal, kv_valid, transposed)
    q, k, v, o, lse, do, scale, causal, kv = args
    monkeypatch.setattr(cuda_attention, "_launch_dq_wgmma", _plain_k7a)
    monkeypatch.setattr(cuda_attention, "_launch_dkv_wgmma", _plain_k7b)
    got = cuda_attention._two_pass_kernels(*args)
    want = cuda_attention.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                                    scale=scale, kv_valid=kv)
    for x, w in zip(got, want):
        assert x.shape == w.shape and x.dtype == w.dtype
        x, w = x.float(), w.float()
        peak = w.abs().max().item()
        if peak == 0.0:
            assert bool((x == 0).all())
            continue
        assert ((x - w).norm() / w.norm()).item() <= BF16_RMS
        assert (x - w).abs().max().item() <= BF16_MAX * peak
