"""The transformer modules against heat_tpu's flax modules, on the CPU.

Each flax module is initialised with ``init``, its variables carried into
the port by ``heat_tpu_torch.interop`` (as numpy arrays), and both are
applied to the same numpy input, at a small size: 2 layers, d_model 32,
4 heads, T 64, vocab 50. The flash core runs the JAX kernel in the Pallas
interpreter and the port's plain version.

Tolerances: in f32, 2e-5 of the output's largest magnitude (|logits| ~ 4;
f32 GEMMs and softmax sums in other orders across a few layers). In bf16
both sides round every activation to bf16 but at their own points and
with their own GEMM summation orders, so the gate is on the relative RMS
error, 2e-2 (a few bf16 roundings of 2^-9 each per layer), and on the
largest error, 2^-4 of the output's largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heat_tpu import nn as jnn

import heat_tpu_torch as htt
from heat_tpu_torch import interop

VOCAB, D_MODEL, HEADS, LAYERS, T = 50, 32, 4, 2, 64
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True)
def on_cpu():
    htt.use_device("cpu")
    yield
    htt.use_device(None)


def _numpy(variables):
    return jax.tree.map(np.asarray, variables)


def _close(got, want, dtype):
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape
    peak = np.abs(want).max()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-5 * peak)
        return
    rms = np.sqrt(((got - want) ** 2).mean() / (want ** 2).mean())
    assert rms <= 2e-2, rms
    assert np.abs(got - want).max() <= 2.0 ** -4 * peak


def _tokens(seed=0, t=T):
    return np.random.default_rng(seed).integers(0, VOCAB, (2, t)).astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["local", "flash"])
def test_multi_head_attention_matches_flax(impl, dtype):
    jdt, tdt = DTYPES[dtype]
    x = np.random.default_rng(1).standard_normal((2, T, D_MODEL)).astype(np.float32)
    ref = jnn.MultiHeadAttention(HEADS, attn_impl=impl, dtype=jdt)
    variables = ref.init(jax.random.PRNGKey(1), jnp.asarray(x))
    want = ref.apply(variables, jnp.asarray(x))
    mod = htt.nn.MultiHeadAttention(HEADS, attn_impl=impl, dtype=tdt, d_model=D_MODEL)
    interop.load_flax_params(mod, _numpy(variables))
    with torch.inference_mode():
        got = mod(torch.from_numpy(x))
    assert got.dtype == tdt
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["local", "flash"])
def test_transformer_block_matches_flax(impl, dtype):
    jdt, tdt = DTYPES[dtype]
    x = np.random.default_rng(2).standard_normal((2, T, D_MODEL)).astype(np.float32)
    ref = jnn.TransformerBlock(HEADS, attn_impl=impl, dtype=jdt)
    variables = ref.init(jax.random.PRNGKey(2), jnp.asarray(x))
    want = ref.apply(variables, jnp.asarray(x))
    mod = htt.nn.TransformerBlock(HEADS, attn_impl=impl, dtype=tdt, d_model=D_MODEL)
    interop.load_flax_params(mod, _numpy(variables))
    with torch.inference_mode():
        got = mod(torch.from_numpy(x))
    _close(got, want, dtype)


def _lm_pair(impl, dtype, t=T):
    jdt, tdt = DTYPES[dtype]
    cfg = dict(vocab_size=VOCAB, d_model=D_MODEL, num_heads=HEADS, num_layers=LAYERS,
               max_len=T, attn_impl=impl)
    ref = jnn.TransformerLM(**cfg, dtype=jdt)
    variables = ref.init(jax.random.PRNGKey(0), jnp.asarray(_tokens(0, t)))
    mod = interop.transformer_lm_from_flax(_numpy(variables), **cfg, dtype=tdt)
    return ref, variables, mod


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["local", "flash"])
def test_transformer_lm_matches_flax(impl, dtype):
    ref, variables, mod = _lm_pair(impl, dtype)
    tokens = _tokens(3)
    want = ref.apply(variables, jnp.asarray(tokens))
    with torch.inference_mode():
        got = mod(torch.from_numpy(tokens).long())
    assert got.shape == (2, T, VOCAB) and got.dtype == DTYPES[dtype][1]
    _close(got, want, dtype)


def test_flash_and_local_lm_agree():
    _, _, flash = _lm_pair("flash", "float32")
    _, _, local = _lm_pair("local", "float32")
    tokens = torch.from_numpy(_tokens(4)).long()
    with torch.inference_mode():
        torch.testing.assert_close(flash(tokens), local(tokens), rtol=0, atol=2e-5 * 4)


@pytest.mark.parametrize("impl", ["local", "flash"])
def test_lm_is_causal(impl):
    """Changing the last token leaves every earlier position's logits
    bit-identical: every operation is row-wise, a GEMM over the same shape,
    or attention over keys at or before the row."""
    _, _, mod = _lm_pair(impl, "bfloat16")
    tokens = torch.from_numpy(_tokens(5)).long()
    other = tokens.clone()
    other[:, -1] = (other[:, -1] + 1) % VOCAB
    with torch.inference_mode():
        a, b = mod(tokens), mod(other)
    assert torch.equal(a[:, :-1], b[:, :-1])
    assert not torch.equal(a[:, -1], b[:, -1])


def test_d_model_not_divisible_by_heads_raises_like_flax():
    x = jnp.zeros((1, 4, 30))
    with pytest.raises(ValueError, match="not divisible") as want:
        jnn.MultiHeadAttention(4).init(jax.random.PRNGKey(0), x)
    with pytest.raises(ValueError, match="not divisible") as got:
        htt.nn.MultiHeadAttention(4, d_model=30)
    assert str(got.value) == str(want.value)


def test_sequence_past_max_len_raises_like_flax():
    ref, variables, mod = _lm_pair("local", "float32")
    long = _tokens(6, T + 1)
    with pytest.raises(ValueError, match="exceeds max_len") as want:
        ref.apply(variables, jnp.asarray(long))
    with pytest.raises(ValueError, match="exceeds max_len") as got:
        mod(torch.from_numpy(long).long())
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_sequence_parallel_impls_raise(impl):
    # without comm= there is no world to split the sequence over; with a
    # world of one the block is the local core's (the spawned worlds are in
    # tests/test_torch_parallel.py)
    mod = htt.nn.MultiHeadAttention(HEADS, attn_impl=impl, d_model=D_MODEL)
    with pytest.raises(ValueError, match="needs comm="):
        mod(torch.zeros((1, 8, D_MODEL)))
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 8, D_MODEL))
                         .astype(np.float32))
    seq = htt.nn.MultiHeadAttention(HEADS, attn_impl=impl, comm=htt.get_comm(),
                                    d_model=D_MODEL)
    local = htt.nn.MultiHeadAttention(HEADS, attn_impl="local", d_model=D_MODEL)
    local.load_state_dict(seq.state_dict())
    np.testing.assert_allclose(seq(x).detach().numpy(), local(x).detach().numpy(),
                               rtol=0, atol=2e-5)


def test_weights_come_from_the_generator():
    """Two modules from equal generators hold equal weights; another seed
    gives others; nothing is drawn from torch's global generator."""
    def build(seed):
        return htt.nn.TransformerLM(VOCAB, D_MODEL, HEADS, LAYERS, max_len=T,
                                    generator=torch.Generator().manual_seed(seed))
    torch.manual_seed(123)
    before = torch.get_rng_state()
    a, b, c = build(0), build(0), build(1)
    assert torch.equal(torch.get_rng_state(), before)
    for (name, pa), pb, pc in zip(a.named_parameters(), b.parameters(), c.parameters()):
        assert torch.equal(pa, pb), name
        if not name.endswith(("scale", "bias")):
            assert not torch.equal(pa, pc), name
    # flax's initialisers: LeCun-normal dense kernels, N(0, 1/d) embeddings
    w = a.blocks[0].gate.detach()
    assert abs(w.std().item() * np.sqrt(D_MODEL) - 1.0) < 0.1
    assert w.abs().max().item() <= 2.0 / 0.87962566103423978 / np.sqrt(D_MODEL) + 1e-6
    assert abs(a.embed.detach().std().item() * np.sqrt(D_MODEL) - 1.0) < 0.1
