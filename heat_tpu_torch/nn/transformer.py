"""Transformer blocks and the causal LM, counterpart of ``heat_tpu/nn/transformer.py``.

* :class:`MultiHeadAttention`: QKV projection, an attention core, output
  projection.
* :class:`TransformerBlock`: pre-LN block, attention then a SwiGLU MLP
  (``silu(gate) * up``, ``d_ff = int(d_model * mlp_ratio)``).
* :class:`TransformerLM`: token and position embeddings, blocks, final LN,
  logit projection.

The constructors take the flax modules' arguments. Torch needs the widths
before the first call, so ``d_model`` (and nothing else) is added where
flax infers it from the input. ``attn_impl`` selects the core:
``"local"`` (plain blockwise, :func:`heat_tpu_torch.parallel.local_attention`),
``"flash"`` (the flash kernel,
:func:`heat_tpu_torch.parallel.flash_attention`), or the sequence-parallel
``"ring"`` and ``"ulysses"`` over ``comm`` (a
:class:`heat_tpu_torch.TorchCommunication`;
:func:`heat_tpu_torch.parallel.ring_attention`, ``ulysses_attention``).
With those two each rank passes its chunk of the sequence, the same length
on every rank: the tokens ``(B, T / p)`` of :class:`TransformerLM` (whose
position rows start at ``rank * T / p``), or ``(B, T / p, D)`` of a block;
everything but the attention core is per token.

Numerics follow the flax model: parameters are f32 and each forward casts
them to ``dtype`` (flax's ``param_dtype``/``dtype`` split), so no bf16 copy
is held; LayerNorm has ``epsilon=1e-6`` and takes its statistics in f32
(mean and ``E[x^2] - E[x]^2``); the embedding rows are cast to ``dtype``
(the lookup of a cast table, in the cheaper order) and the position rows are
added in ``dtype``. Weights are initialised as flax does (LeCun-normal,
truncated at two standard deviations; embeddings normal with std
``1/sqrt(d_model)``) from an explicit ``torch.Generator`` on the module's
device (seeded 0 when none is given). ``interop.transformer_lm_from_flax``
loads a flax model's weights instead.

``TransformerLM(remat=True)`` is flax's ``nn.remat(TransformerBlock)``: each
block runs under ``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``,
so only its input is kept and the block is recomputed in the backward.
``remat_policy="dots"`` is ``jax.checkpoint_policies.
dots_with_no_batch_dims_saveable``: the outputs of the non-batched
products (``aten.mm``/``aten.addmm``, the ``F.linear`` calls) are saved and
the rest is recomputed, through
``torch.utils.checkpoint.create_selective_checkpoint_contexts``.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..core.devices import sanitize_device
from ..parallel import flash_attention, local_attention, ring_attention, ulysses_attention

__all__ = ["LayerNorm", "MultiHeadAttention", "TransformerBlock", "TransformerLM"]

_IMPLS = ("local", "flash", "ring", "ulysses")


def _setup(device, generator):
    dev = sanitize_device(device).torch_device
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    return dev, generator


def _lecun_normal(out_features: int, in_features: int, device, generator) -> nn.Parameter:
    """flax's ``lecun_normal``: truncated normal with variance 1/fan_in, as a
    torch ``(out, in)`` weight."""
    std = math.sqrt(1.0 / in_features) / 0.87962566103423978
    w = torch.empty((out_features, in_features), dtype=torch.float32, device=device)
    nn.init.trunc_normal_(w, std=std, a=-2.0 * std, b=2.0 * std, generator=generator)
    return nn.Parameter(w)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm``: f32 statistics, ``epsilon=1e-6``, f32 scale and
    bias, output in ``dtype``."""

    def __init__(self, features: int, dtype: torch.dtype = torch.float32, eps: float = 1e-6,
                 device=None):
        super().__init__()
        dev = sanitize_device(device).torch_device
        self.dtype, self.eps = dtype, eps
        self.scale = nn.Parameter(torch.ones(features, dtype=torch.float32, device=dev))
        self.bias = nn.Parameter(torch.zeros(features, dtype=torch.float32, device=dev))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.scale
        return ((xf - mean) * mul + self.bias).to(self.dtype)


def _attend(q, k, v, *, impl, causal, comm, block_size, flash_bwd_impl):
    if impl == "flash":
        if block_size is None:  # the kernel's default tiles
            return flash_attention(q, k, v, causal=causal, bwd_impl=flash_bwd_impl)
        return flash_attention(q, k, v, causal=causal, block_q=block_size, block_k=block_size,
                               bwd_impl=flash_bwd_impl)
    if impl in ("ring", "ulysses") and comm is None:
        raise ValueError(f"attn_impl={impl!r} needs comm=, the world the sequence is split over")
    if impl == "ring":
        # the ring processes one rank's chunk a hop; there is no block knob
        return ring_attention(q, k, v, comm=comm, causal=causal)
    if impl == "ulysses":
        return ulysses_attention(q, k, v, comm=comm, causal=causal,
                                 block_size=512 if block_size is None else block_size)
    return local_attention(q, k, v, causal=causal,
                           block_size=512 if block_size is None else block_size)


class MultiHeadAttention(nn.Module):
    """QKV projection → attention core → output projection, ``(B, T, D)`` in
    and out, the core in ``(B, T, H, D_head)``. Weights ``query``, ``key``,
    ``value`` ``(H * D_head, D)`` and ``out`` ``(D, H * D_head)``, torch's
    ``(out, in)`` layout of flax's DenseGeneral kernels."""

    def __init__(self, num_heads: int, attn_impl: str = "local", causal: bool = True,
                 comm: Optional[Any] = None, block_size: Optional[int] = None,
                 dtype: torch.dtype = torch.float32, flash_bwd_impl: str = "two_pass", *,
                 d_model: int, device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        if d_model % num_heads:
            raise ValueError(f"d_model {d_model} not divisible by {num_heads} heads")
        if attn_impl not in _IMPLS:
            raise ValueError(f"attn_impl must be one of {_IMPLS}, got {attn_impl!r}")
        dev, gen = _setup(device, generator)
        self.num_heads, self.attn_impl, self.causal = num_heads, attn_impl, causal
        self.comm, self.block_size, self.dtype = comm, block_size, dtype
        self.flash_bwd_impl = flash_bwd_impl
        self.d_head = d_model // num_heads
        self.query = _lecun_normal(d_model, d_model, dev, gen)
        self.key = _lecun_normal(d_model, d_model, dev, gen)
        self.value = _lecun_normal(d_model, d_model, dev, gen)
        self.out = _lecun_normal(d_model, d_model, dev, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, _ = x.shape
        x = x.to(self.dtype)
        heads = (b, t, self.num_heads, self.d_head)
        q, k, v = (F.linear(x, w.to(self.dtype)).view(heads)
                   for w in (self.query, self.key, self.value))
        o = _attend(q, k, v, impl=self.attn_impl, causal=self.causal, comm=self.comm,
                    block_size=self.block_size, flash_bwd_impl=self.flash_bwd_impl)
        return F.linear(o.reshape(b, t, -1), self.out.to(self.dtype))


class TransformerBlock(nn.Module):
    """Pre-LN residual block: ``x + attn(LN(x))``; ``x + swiglu(LN(x))``."""

    def __init__(self, num_heads: int, mlp_ratio: float = 4.0, attn_impl: str = "local",
                 causal: bool = True, comm: Optional[Any] = None,
                 block_size: Optional[int] = None, dtype: torch.dtype = torch.float32,
                 flash_bwd_impl: str = "two_pass", *, d_model: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev, gen = _setup(device, generator)
        self.dtype = dtype
        d_ff = int(d_model * mlp_ratio)
        self.ln1 = LayerNorm(d_model, dtype, device=dev)
        self.attn = MultiHeadAttention(num_heads, attn_impl, causal, comm, block_size, dtype,
                                       flash_bwd_impl, d_model=d_model, device=dev,
                                       generator=gen)
        self.ln2 = LayerNorm(d_model, dtype, device=dev)
        self.gate = _lecun_normal(d_ff, d_model, dev, gen)
        self.up = _lecun_normal(d_ff, d_model, dev, gen)
        self.down = _lecun_normal(d_model, d_ff, dev, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln1(x))
        h = self.ln2(x)
        gate = F.linear(h, self.gate.to(self.dtype))
        up = F.linear(h, self.up.to(self.dtype))
        return x + F.linear(F.silu(gate) * up, self.down.to(self.dtype))


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """``dots_with_no_batch_dims_saveable``: keep the non-batched products'
    outputs, recompute everything else."""
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


class TransformerLM(nn.Module):
    """Causal LM: token embedding → blocks → final LN → logits.

    ``remat`` checkpoints each block (only its input is kept; it is
    recomputed in the backward), trading backward FLOPs for activation
    memory; ``remat_policy="dots"`` keeps the blocks' projection outputs
    too. Any other policy is full recompute, as in flax. Both act only when
    the forward records a graph."""

    def __init__(self, vocab_size: int, d_model: int, num_heads: int, num_layers: int,
                 max_len: int = 2048, mlp_ratio: float = 4.0, attn_impl: str = "local",
                 comm: Optional[Any] = None, block_size: Optional[int] = None,
                 remat: bool = False, remat_policy: Optional[str] = None,
                 dtype: torch.dtype = torch.float32, flash_bwd_impl: str = "two_pass", *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        dev, gen = _setup(device, generator)
        self.vocab_size, self.d_model, self.max_len = vocab_size, d_model, max_len
        self.comm = comm if attn_impl in ("ring", "ulysses") else None
        self.remat, self.remat_policy, self.dtype = remat, remat_policy, dtype
        std = 1.0 / math.sqrt(d_model)
        self.embed = nn.Parameter(
            torch.randn((vocab_size, d_model), generator=gen, device=dev) * std)
        self.pos = nn.Parameter(torch.randn((max_len, d_model), generator=gen, device=dev) * std)
        self.blocks = nn.ModuleList(
            TransformerBlock(num_heads, mlp_ratio, attn_impl, True, comm, block_size, dtype,
                             flash_bwd_impl, d_model=d_model, device=dev, generator=gen)
            for _ in range(num_layers))
        self.ln_f = LayerNorm(d_model, dtype, device=dev)
        self.lm_head = _lecun_normal(vocab_size, d_model, dev, gen)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        t = tokens.shape[-1]
        # a sequence-split model holds this rank's chunk: its positions start
        # at rank * t
        start = 0 if self.comm is None else self.comm.rank * t
        total = t if self.comm is None else t * self.comm.size
        if total > self.max_len:
            raise ValueError(f"sequence length {total} exceeds max_len {self.max_len}")
        x = F.embedding(tokens, self.embed).to(self.dtype)
        x = x + self.pos[start:start + t].to(self.dtype)[None]
        remat = self.remat and torch.is_grad_enabled()
        kwargs = {}
        if remat and self.remat_policy == "dots":
            kwargs["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                                     _save_dots)
        for block in self.blocks:
            x = checkpoint(block, x, use_reentrant=False, **kwargs) if remat else block(x)
        return F.linear(self.ln_f(x), self.lm_head.to(self.dtype))

    def stages(self) -> list:
        """The model as stages applied left to right, sharing this model's
        parameters: the embedding (tokens to activations), each block, and
        the head (final LN and logits), for :class:`heat_tpu_torch.nn.FSDP`.
        Their composition is :meth:`forward` without its ``remat``."""
        if self.comm is not None:
            raise ValueError("stages() takes a model whose attention is not sequence-parallel")
        return [_Embed(self), *self.blocks, _Head(self)]


class _Embed(nn.Module):
    """The LM's token and position embedding as a stage."""

    def __init__(self, lm: TransformerLM):
        super().__init__()
        self.embed, self.pos, self.dtype, self.max_len = lm.embed, lm.pos, lm.dtype, lm.max_len

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        t = tokens.shape[-1]
        if t > self.max_len:
            raise ValueError(f"sequence length {t} exceeds max_len {self.max_len}")
        return F.embedding(tokens, self.embed).to(self.dtype) + self.pos[:t].to(self.dtype)[None]


class _Head(nn.Module):
    """The LM's final LayerNorm and logit projection as a stage."""

    def __init__(self, lm: TransformerLM):
        super().__init__()
        self.ln_f, self.lm_head, self.dtype = lm.ln_f, lm.lm_head, lm.dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(self.ln_f(x), self.lm_head.to(self.dtype))
