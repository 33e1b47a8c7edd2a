"""The attention cores against heat_tpu's, on the CPU.

The port's ``flash_attention`` runs its plain version here; it is held
against heat_tpu's Pallas kernel run by the interpreter
(``interpret=True``), and the port's ``local_attention`` against heat_tpu's.
Inputs come from numpy seeds.

Tolerances: in f32, 2e-6 absolute on O (|O| <= max|v| ~ 4; both sides sum
exact f32 products in other orders) and 2e-6 (1 + |lse|) on the
log-sum-exp. In bf16 the inputs are the same bf16 values on both sides and
the products exact in f32, but each side rounds p and O to bf16 at its own
points: O within 2^-7 max|v| (one bf16 ulp of |O| <= max|v| is
2^-8 max|v|, plus a probability that rounds the other way).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from heat_tpu import parallel as jpar
from heat_tpu.parallel import pallas_attention as jpal

import heat_tpu_torch as htt
from heat_tpu_torch.parallel import cuda_attention

F32_TOL = 2e-6
BF16_TOL = 2.0 ** -7

CASES = [
    # b, t_q, t_k, h, d, causal, kv_valid
    (2, 64, 64, 4, 8, True, None),
    (2, 64, 64, 4, 8, False, None),
    (1, 50, 77, 2, 24, False, 60),
    (1, 70, 45, 2, 16, True, 30),
    (1, 33, 33, 3, 12, True, 20),
    (1, 130, 200, 1, 32, False, None),
]


def _inputs(b, t_q, t_k, h, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, t_q, h, d)).astype(np.float32),
            rng.standard_normal((b, t_k, h, d)).astype(np.float32),
            rng.standard_normal((b, t_k, h, d)).astype(np.float32))


def _pair(arrays, dtype):
    """The same values as jax and torch arrays of ``dtype`` ("float32" or
    "bfloat16")."""
    jx = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrays]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    return jx, tx


def _close(got, want, v, dtype):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    tol = F32_TOL if dtype == "float32" else BF16_TOL * np.abs(np.asarray(v, np.float32)).max()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,t_q,t_k,h,d,causal,kv_valid", CASES)
def test_flash_matches_jax_kernel_interpret(dtype, b, t_q, t_k, h, d, causal, kv_valid):
    arrays = _inputs(b, t_q, t_k, h, d, t_q + t_k + d)
    (jq, jk, jv), (tq, tk, tv) = _pair(arrays, dtype)
    want = jpal.flash_attention(jq, jk, jv, causal=causal, kv_valid=kv_valid, interpret=True)
    got = cuda_attention.flash_attention(tq, tk, tv, causal=causal, kv_valid=kv_valid)
    assert got.dtype == tq.dtype
    _close(got, want, tv.float(), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,t_q,t_k,h,d,causal,kv_valid", CASES)
def test_local_matches_jax_local(dtype, b, t_q, t_k, h, d, causal, kv_valid):
    arrays = _inputs(b, t_q, t_k, h, d, 7 * t_q + d)
    (jq, jk, jv), (tq, tk, tv) = _pair(arrays, dtype)
    want = jpar.local_attention(jq, jk, jv, causal=causal, kv_valid=kv_valid, block_size=32)
    got = htt.parallel.local_attention(tq, tk, tv, causal=causal, kv_valid=kv_valid,
                                       block_size=32)
    assert got.dtype == tq.dtype
    _close(got, want, tv.float(), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,t_q,t_k,h,d,causal,kv_valid", CASES[2:5])
def test_lse_matches_jax_kernel_interpret(dtype, b, t_q, t_k, h, d, causal, kv_valid):
    arrays = _inputs(b, t_q, t_k, h, d, 3 * t_k + d)
    (jq, jk, jv), (tq, tk, tv) = _pair(arrays, dtype)
    scale = 1.0 / np.sqrt(d)
    kv = t_k if kv_valid is None else kv_valid
    bhtd = [x.transpose(0, 2, 1, 3) for x in (jq, jk, jv)]
    want_o, want_lse = jpal._flash_forward(*bhtd, scale, causal, kv, 512, 1024, True,
                                           return_lse=True)
    got_o, got_lse = cuda_attention._flash_forward(tq, tk, tv, scale, causal, kv,
                                                   return_lse=True)
    assert got_lse.shape == (b, h, t_q) and got_lse.dtype == torch.float32
    want_lse = np.asarray(want_lse)[..., :t_q, 0]
    np.testing.assert_allclose(got_lse.numpy(), want_lse, rtol=F32_TOL, atol=F32_TOL)
    _close(got_o, want_o.transpose(0, 2, 1, 3), tv.float(), dtype)


def test_fully_masked_rows_give_zero_and_big_lse():
    """kv_valid = 0 masks every key: O is 0 and the LSE +1e30, as in the
    JAX kernel."""
    arrays = _inputs(1, 16, 16, 2, 8, 0)
    (jq, jk, jv), (tq, tk, tv) = _pair(arrays, "float32")
    _, want_lse = jpal._flash_forward(*[x.transpose(0, 2, 1, 3) for x in (jq, jk, jv)],
                                      0.5, False, 0, 512, 1024, True, return_lse=True)
    got_o, got_lse = cuda_attention._flash_forward(tq, tk, tv, 0.5, False, 0, return_lse=True)
    assert bool((got_o == 0).all())
    assert bool((got_lse == 1e30).all()) and (np.asarray(want_lse)[..., :16, 0] == 1e30).all()
    plain = cuda_attention.flash_attention(tq, tk, tv, kv_valid=0)
    assert bool((plain == 0).all())


def test_block_k_is_the_plain_versions_chunk():
    """block_k changes only the summation order of the plain version."""
    (q, k, v) = (torch.from_numpy(a) for a in _inputs(1, 40, 300, 2, 16, 4))
    a = cuda_attention.flash_attention(q, k, v, causal=True, block_k=128)
    b = cuda_attention.flash_attention(q, k, v, causal=True, block_k=1024)
    torch.testing.assert_close(a, b, rtol=0, atol=F32_TOL)


def test_bwd_impl_is_validated_as_in_jax():
    (q, k, v) = (torch.from_numpy(a) for a in _inputs(1, 8, 8, 1, 4, 1))
    jq = jnp.asarray(q.numpy())
    for impl in ("two_pass", "fused", "auto"):
        cuda_attention.flash_attention(q, k, v, bwd_impl=impl)
    with pytest.raises(ValueError, match="bwd_impl") as got:
        cuda_attention.flash_attention(q, k, v, bwd_impl="three_pass")
    with pytest.raises(ValueError, match="bwd_impl") as want:
        jpal.flash_attention(jq, jq, jq, bwd_impl="three_pass", interpret=True)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="B, T, H, D"):
        cuda_attention.flash_attention(q[0], k[0], v[0])


def test_sequence_parallel_variants_name_the_missing_collectives():
    # the collectives and, since ROADMAP item 2, the attention over them: on a
    # world of one both variants give the JAX package's result on one device
    import jax

    from heat_tpu.core.communication import MeshCommunication

    assert callable(htt.get_comm().ppermute) and callable(htt.get_comm().all_to_all)
    rng = np.random.default_rng(11)
    q, k, v = (rng.standard_normal((1, 12, 2, 8)).astype(np.float32) for _ in range(3))
    jcomm = MeshCommunication(devices=jax.devices()[:1])
    for got_fn, want_fn in ((htt.parallel.ring_attention, jpar.ring_attention),
                            (htt.parallel.ulysses_attention, jpar.ulysses_attention)):
        got = got_fn(*(torch.from_numpy(a) for a in (q, k, v)), comm=htt.get_comm(),
                     causal=True, seq_len=9)
        want = want_fn(*(jnp.asarray(a) for a in (q, k, v)), comm=jcomm, causal=True,
                       seq_len=9)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=F32_TOL)
        with pytest.raises(TypeError):
            got_fn(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
# ------------------------------------------------- the kernels' shape rules

def _bthd(b=2, t=32, h=4, d=64, dtype=torch.bfloat16):
    return torch.zeros((b, t, h, d), dtype=dtype)


VARIANT_CASES = [
    # dtype, d, element strides (batch, time, head), base 16-byte aligned, want
    (torch.float32, 64, (8192, 256, 64), True, "f32"),
    (torch.bfloat16, 64, (8192, 256, 64), True, "bf16_wgmma"),
    (torch.bfloat16, 128, (16384, 128, 2048), True, "bf16_wgmma"),  # (B, H, T, D) memory
    (torch.bfloat16, 64, (8192, 256, 64), False, "bf16_scalar"),    # base not aligned
    (torch.bfloat16, 64, (8200, 260, 64), True, "bf16_scalar"),     # rows not aligned
    (torch.bfloat16, 32, (4096, 128, 32), True, "bf16_mma"),
    (torch.bfloat16, 96, (12288, 384, 96), True, "bf16_mma"),
    (torch.bfloat16, 24, (3072, 96, 24), True, "bf16_mma"),
    (torch.bfloat16, 100, (12800, 400, 100), True, "bf16_scalar"),
    (torch.bfloat16, 64, (0, 256, 64), True, "bf16_mma"),           # a broadcast batch
    (torch.bfloat16, 64, (2 ** 40, 256, 64), True, "bf16_mma"),     # past a tensor map's stride
]


@pytest.mark.parametrize("dtype,d,strides,aligned,want", VARIANT_CASES)
def test_attention_variant_is_a_shape_rule(dtype, d, strides, aligned, want):
    assert cuda_attention._attention_variant(dtype, d, strides, aligned) == want


def test_attention_variant_of_real_tensors():
    """The rule on the strides the wrappers compute: contiguous, transposed
    and sliced views of bf16 tensors take the Hopper kernels when their rows
    stay 16-byte aligned."""
    x = _bthd()
    variant = lambda t: cuda_attention._attention_variant(
        t.dtype, t.shape[-1], cuda_attention._strides(t), t.data_ptr() % 16 == 0)
    assert variant(x) == "bf16_wgmma"
    bf16 = torch.bfloat16
    assert variant(torch.zeros((2, 4, 32, 64), dtype=bf16).transpose(1, 2)) == "bf16_wgmma"
    assert variant(torch.zeros((2, 32, 3, 4, 64), dtype=bf16).unbind(2)[1]) == "bf16_wgmma"
    assert variant(x[:, 3:19]) == "bf16_wgmma"              # a slice of whole rows
    assert variant(torch.zeros((2, 32, 4, 72), dtype=torch.bfloat16)[..., 4:68]) == "bf16_scalar"
    assert variant(x.float()) == "f32"
    assert variant(_bthd(d=16)) == "bf16_mma"
    # a dimension of size 1 is never stepped over: whatever stride torch gives it is ignored
    one = torch.zeros((1, 32, 4, 64), dtype=bf16).as_strided((1, 32, 4, 64), (3, 256, 64, 1))
    assert cuda_attention._strides(one) == [32 * 4 * 64, 256, 64]
    assert variant(one) == "bf16_wgmma"


def test_tensor_map_layout_of_contiguous_transposed_and_sliced_inputs():
    """D, T, H, B and the byte strides of T, H, B that the tensor maps are
    encoded from."""
    layout = lambda x: list(cuda_attention._tensor_map_layout(x))
    assert layout(_bthd(2, 32, 4, 64)) == [64, 32, 4, 2, 4 * 64 * 2, 64 * 2, 32 * 4 * 64 * 2]
    bhtd = torch.zeros((2, 4, 32, 128), dtype=torch.bfloat16).transpose(1, 2)
    assert layout(bhtd) == [128, 32, 4, 2, 128 * 2, 32 * 128 * 2, 4 * 32 * 128 * 2]
    sliced = _bthd(2, 32, 4, 64)[:, 8:24, 1:3]
    assert layout(sliced) == [64, 16, 2, 2, 4 * 64 * 2, 64 * 2, 32 * 4 * 64 * 2]
    assert sliced.data_ptr() % 16 == 0
    qkv = torch.zeros((2, 32, 3, 4, 64), dtype=torch.bfloat16)
    assert layout(qkv.unbind(2)[2]) == [64, 32, 4, 2, 3 * 4 * 64 * 2, 64 * 2, 32 * 3 * 4 * 64 * 2]
    # every byte stride a tensor map takes is a multiple of 16
    for x in (bhtd, sliced, qkv.unbind(2)[2]):
        assert all(s % 16 == 0 for s in layout(x)[4:])


@pytest.mark.parametrize("t_q,d,want", [(1, 64, (64, 64)), (64, 128, (64, 128)),
                                        (65, 128, (128, 128)), (1024, 64, (64, 64)),
                                        (4096, 128, (128, 128))])
def test_forward_tiles_rule(t_q, d, want):
    assert cuda_attention._fwd_tiles(t_q, d) == want
