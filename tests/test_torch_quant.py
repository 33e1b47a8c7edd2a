"""The W8A8 path against heat_tpu's, bit for bit, on the CPU.

``quantize_int8``, ``int8_matmul`` and ``matmul_int8`` of the port (the
GEMM's plain version here) against heat_tpu's, whose GEMM runs in the
Pallas interpreter. The int32 accumulation is exact and both sides round
the epilogue in the same order, so every result is bit-equal, ragged shapes
included. ``QuantDense`` is held to flax's with carried weights, also bit
for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heat_tpu.core import linalg as jlinalg
from heat_tpu import nn as jnn

import heat_tpu_torch as htt
from heat_tpu_torch import interop
from heat_tpu_torch.core import linalg
from heat_tpu_torch.core.linalg import cuda_quant

SHAPES = [(16, 32, 24), (37, 70, 45), (1, 1, 1), (130, 257, 129), (5, 600, 3)]
OUT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True)
def on_cpu():
    htt.use_device("cpu")
    yield
    htt.use_device(None)


def _eq(got, want):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _operands(m, k, n, seed):
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal((m, k)) * rng.uniform(0.1, 10)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    return a, b


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_quantize_int8_bit_equal(m, k, n, axis):
    a, _ = _operands(m, k, n, m + k)
    a[0] = 0.0  # an all-zero row takes scale 1
    a[-1, -1] = 2.5 * np.abs(a).max() / 127  # ties round to even
    q, s = linalg.quantize_int8(torch.from_numpy(a), axis=axis)
    jq, js = jlinalg.quantize_int8(jnp.asarray(a), axis=axis)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def test_quantize_rounds_half_to_even_like_jnp():
    x = np.array([[0.5, 1.5, 2.5, -0.5, -2.5, 127.0]], np.float32)
    q, _ = linalg.quantize_int8(torch.from_numpy(x), axis=1)
    jq, _ = jlinalg.quantize_int8(jnp.asarray(x), axis=1)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert q.tolist() == [[0, 2, 2, 0, -2, 127]]


@pytest.mark.parametrize("out", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_int8_matmul_bit_equal(m, k, n, out):
    jdt, tdt = OUT[out]
    a, b = _operands(m, k, n, 3 * m + n)
    qa, sa = linalg.quantize_int8(torch.from_numpy(a), axis=1)
    qb, sb = linalg.quantize_int8(torch.from_numpy(b), axis=0)
    got = linalg.int8_matmul(qa, sa, qb, sb, out_dtype=tdt)
    want = jlinalg.int8_matmul(jnp.asarray(qa.numpy()), jnp.asarray(sa.numpy()),
                               jnp.asarray(qb.numpy()), jnp.asarray(sb.numpy()),
                               out_dtype=jdt, interpret=True)
    assert got.dtype == tdt
    _eq(got, want)
    _eq(cuda_quant.int8_gemm_plain(qa, sa, qb, sb, tdt), want)


@pytest.mark.parametrize("m,k,n", SHAPES[:3])
def test_matmul_int8_bit_equal(m, k, n):
    a, b = _operands(m, k, n, 5 * k)
    got = linalg.matmul_int8(torch.from_numpy(a), torch.from_numpy(b))
    want = jlinalg.matmul_int8(jnp.asarray(a), jnp.asarray(b), interpret=True)
    _eq(got, want)


@pytest.mark.parametrize("m,k,n", [(0, 8, 4), (4, 0, 4), (4, 8, 0)])
def test_empty_operand_gives_zeros(m, k, n):
    qa = torch.zeros((m, k), dtype=torch.int8)
    qb = torch.zeros((k, n), dtype=torch.int8)
    got = linalg.int8_matmul(qa, torch.ones((m, 1)), qb, torch.ones((1, n)),
                             out_dtype=torch.bfloat16)
    want = jlinalg.int8_matmul(jnp.zeros((m, k), jnp.int8), jnp.ones((m, 1)),
                               jnp.zeros((k, n), jnp.int8), jnp.ones((1, n)),
                               out_dtype=jnp.bfloat16, interpret=True)
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    _eq(got, want)


def test_contraction_mismatch_raises_like_jax():
    qa = torch.zeros((4, 8), dtype=torch.int8)
    qb = torch.zeros((7, 4), dtype=torch.int8)
    with pytest.raises(ValueError, match="contraction mismatch") as got:
        linalg.int8_matmul(qa, torch.ones((4, 1)), qb, torch.ones((1, 4)))
    with pytest.raises(ValueError, match="contraction mismatch") as want:
        jlinalg.int8_matmul(jnp.zeros((4, 8), jnp.int8), jnp.ones((4, 1)),
                            jnp.zeros((7, 4), jnp.int8), jnp.ones((1, 4)), interpret=True)
    assert str(got.value) == str(want.value)


def test_out_dtype_must_be_f32_or_bf16():
    q = torch.zeros((2, 2), dtype=torch.int8)
    with pytest.raises(ValueError, match="out_dtype"):
        linalg.int8_matmul(q, torch.ones((2, 1)), q, torch.ones((1, 2)), out_dtype=torch.float16)


@pytest.mark.parametrize("use_bias", [False, True])
@pytest.mark.parametrize("lead", [(3, 5), (7,), (0,)])
def test_quant_dense_matches_flax(lead, use_bias):
    x = np.random.default_rng(len(lead)).standard_normal((*lead, 16)).astype(np.float32)
    ref = jnn.QuantDense(features=24, use_bias=use_bias)
    variables = ref.init(jax.random.PRNGKey(1), jnp.ones((2, 16)))
    if use_bias:
        variables = jax.tree.map(lambda v: v, variables)
        variables["params"]["bias"] = jnp.linspace(-1, 1, 24, dtype=jnp.float32)
    want = ref.apply(variables, jnp.asarray(x))
    mod = interop.quant_dense_from_flax(jax.tree.map(np.asarray, variables), 24,
                                        use_bias=use_bias)
    got = mod(torch.from_numpy(x))
    assert got.shape == (*lead, 24)
    _eq(got, want)


def test_quant_dense_bf16_output_matches_flax():
    x = np.random.default_rng(9).standard_normal((4, 6, 32)).astype(np.float32)
    ref = jnn.QuantDense(features=8, dtype=jnp.bfloat16)
    variables = ref.init(jax.random.PRNGKey(2), jnp.asarray(x))
    mod = interop.quant_dense_from_flax(jax.tree.map(np.asarray, variables), 8,
                                        dtype=torch.bfloat16)
    got = mod(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    _eq(got, ref.apply(variables, jnp.asarray(x)))


def test_quant_dense_weight_from_generator():
    a = htt.nn.QuantDense(8, in_features=16, generator=torch.Generator().manual_seed(3))
    b = htt.nn.QuantDense(8, in_features=16, generator=torch.Generator().manual_seed(3))
    assert a.weight.shape == (8, 16) and torch.equal(a.weight, b.weight)
