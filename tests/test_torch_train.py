"""The TransformerLM training step against heat_tpu's flax model and optax, on
the CPU.

The small LM of ``tests/test_torch_transformer.py`` (2 layers, d_model 32,
4 heads, T 64, vocab 50) is initialised by flax and carried into the port
by ``heat_tpu_torch.interop``. The loss is the mean cross-entropy of the
next token, ``optax.softmax_cross_entropy_with_integer_labels`` in JAX and
``F.cross_entropy`` in the port; the gradients come from
``jax.value_and_grad`` and ``loss.backward()``; the optimizer is
``optax.adamw(1e-3)`` against ``torch.optim.AdamW`` with optax's defaults
(betas 0.9 and 0.999, eps 1e-8, weight decay 1e-4 on every parameter).
Flax's gradient and parameter trees go into twin modules through
``interop`` to be compared tensor by tensor. The flash core runs the JAX
kernels in the Pallas interpreter and the port's plain versions.

Tolerances:

- f32: the loss within 1e-5 relative; each gradient within 2e-5 of its
  largest magnitude (f32 GEMMs and softmax sums in other orders, through
  2 layers forward and back: ~1.3e-6 seen); AdamW's parameters within
  1e-6 after each step (0.1% of the learning rate: Adam divides each
  gradient by its own RMS, so a small gradient's relative error reaches
  the update; 2.4e-7 seen).
- bf16: both sides round every activation to bf16 but at their own points
  and with their own summation orders. The loss within 2e-3 relative
  (8e-4 seen); each gradient's relative RMS error within 5e-2 and its
  largest error within 1e-1 of its largest magnitude (~2% seen: a few bf16
  roundings of 2^-9 a layer, compounded through the backward). AdamW in
  bf16: an early Adam step is close to ``lr * sign(g)``, so an element
  whose small gradient changes sign moves by up to 2 lr the other way; the
  parameters are held within 2 lr per step taken, and the relative RMS of
  their difference over all tensors within 2e-1 of the update's RMS (up to
  ~0.1 seen).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from heat_tpu import nn as jnn

import heat_tpu_torch as htt
from heat_tpu_torch import interop

VOCAB, D_MODEL, HEADS, LAYERS, T = 50, 32, 4, 2, 64
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
LR = 1e-3


@pytest.fixture(autouse=True)
def on_cpu():
    htt.use_device("cpu")
    yield
    htt.use_device(None)


def _pair(impl, dtype, remat=False, remat_policy=None):
    jdt, tdt = DTYPES[dtype]
    cfg = dict(vocab_size=VOCAB, d_model=D_MODEL, num_heads=HEADS, num_layers=LAYERS,
               max_len=T, attn_impl=impl, remat=remat, remat_policy=remat_policy)
    tokens = np.random.default_rng(0).integers(0, VOCAB, (2, T)).astype(np.int32)
    ref = jnn.TransformerLM(**cfg, dtype=jdt)
    variables = ref.init(jax.random.PRNGKey(0), jnp.asarray(tokens))
    mod = interop.transformer_lm_from_flax(jax.tree.map(np.asarray, variables), **cfg, dtype=tdt)
    twin = lambda tree: interop.transformer_lm_from_flax(  # noqa: E731
        jax.tree.map(np.asarray, tree), **cfg, dtype=tdt)
    return ref, variables, mod, twin, tokens


def _jax_loss(ref, tokens):
    def loss(params):
        logits = ref.apply(params, tokens)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits[:, :-1].astype(jnp.float32), tokens[:, 1:]).mean()
    return loss


def _torch_loss(mod, tokens):
    logits = mod(tokens)
    return F.cross_entropy(logits[:, :-1].float().reshape(-1, VOCAB), tokens[:, 1:].reshape(-1))


def _tensors(mod):
    return {name: p.detach().float().numpy().copy() for name, p in mod.named_parameters()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("remat,remat_policy", [(False, None), (True, None), (True, "dots")])
@pytest.mark.parametrize("impl", ["local", "flash"])
def test_loss_and_gradients_match_flax(impl, remat, remat_policy, dtype):
    ref, variables, mod, twin, tokens = _pair(impl, dtype, remat, remat_policy)
    want_loss, want_grads = jax.value_and_grad(_jax_loss(ref, jnp.asarray(tokens)))(variables)
    loss = _torch_loss(mod, torch.from_numpy(tokens).long())
    loss.backward()
    rel = abs(loss.item() - float(want_loss)) / abs(float(want_loss))
    assert rel <= (1e-5 if dtype == "float32" else 2e-3), rel
    want = _tensors(twin(want_grads))
    for name, p in mod.named_parameters():
        got, w = p.grad.float().numpy(), want[name]
        peak = np.abs(w).max()
        err = np.abs(got - w).max() / peak
        if dtype == "float32":
            assert err <= 2e-5, (name, err)
            continue
        rms = np.sqrt(((got - w) ** 2).sum() / (w ** 2).sum())
        assert rms <= 5e-2 and err <= 1e-1, (name, rms, err)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["local", "flash"])
def test_three_adamw_steps_match_optax(impl, dtype):
    ref, variables, mod, twin, tokens = _pair(impl, dtype)
    jtokens, ttokens = jnp.asarray(tokens), torch.from_numpy(tokens).long()
    opt = optax.adamw(LR)
    state = opt.init(variables)
    topt = torch.optim.AdamW(mod.parameters(), lr=LR, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)
    params, start = variables, _tensors(mod)
    for step in range(1, 4):
        grads = jax.grad(_jax_loss(ref, jtokens))(params)
        updates, state = opt.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        topt.zero_grad()
        _torch_loss(mod, ttokens).backward()
        topt.step()
        got, want = _tensors(mod), _tensors(twin(params))
        worst = max(np.abs(got[n] - want[n]).max() for n in want)
        if dtype == "float32":
            assert worst <= 1e-6, (step, worst)
            continue
        assert worst <= 2 * LR * step, (step, worst)
        diff = sum(((got[n] - want[n]) ** 2).sum() for n in want)
        update = sum(((want[n] - start[n]) ** 2).sum() for n in want)
        assert np.sqrt(diff / update) <= 2e-1, (step, np.sqrt(diff / update))


def _grads(mod, tokens):
    mod.zero_grad()
    _torch_loss(mod, tokens).backward()
    return {name: p.grad.clone() for name, p in mod.named_parameters()}


@pytest.mark.parametrize("impl", ["local", "flash"])
def test_remat_changes_no_gradient_bit(impl):
    """The recompute repeats the forward's arithmetic, so full remat and the
    "dots" policy give the gradients of no remat bit for bit."""
    *_, mod, _, tokens = _pair(impl, "bfloat16")
    tokens = torch.from_numpy(tokens).long()
    want = _grads(mod, tokens)
    for remat, policy in ((True, None), (True, "dots")):
        mod.remat, mod.remat_policy = remat, policy
        got = _grads(mod, tokens)
        for name in want:
            assert torch.equal(got[name], want[name]), (remat, policy, name)


class _CountMatmuls(torch.utils._python_dispatch.TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("remat,remat_policy,recomputed", [
    (False, None, 0), (True, None, 6 * LAYERS), (True, "dots", 0)])
def test_remat_recomputes_what_its_policy_says(remat, remat_policy, recomputed):
    """The backward of a block runs 2 products per forward product (14 for
    its 7 projections). Full remat adds the forward's again, up to the last
    one whose output the backward needs (torch's checkpoint stops there):
    6 of the 7, all but the down projection. "dots" saves the products'
    outputs and recomputes none."""
    *_, mod, _, tokens = _pair("local", "float32", remat, remat_policy)
    loss = _torch_loss(mod, torch.from_numpy(tokens).long())
    with _CountMatmuls() as counter:
        loss.backward()
    baseline = 2 * 7 * LAYERS + 2  # each block's 7 products, and the logits' one
    assert counter.n == baseline + recomputed


def test_forward_without_grad_ignores_remat(monkeypatch):
    """An inference forward keeps no activations, so remat does not
    checkpoint it."""
    *_, mod, _, tokens = _pair("local", "float32", True)
    monkeypatch.setattr("heat_tpu_torch.nn.transformer.checkpoint",
                        lambda *a, **k: pytest.fail("checkpointed an inference forward"))
    with torch.no_grad():
        mod(torch.from_numpy(tokens).long())
