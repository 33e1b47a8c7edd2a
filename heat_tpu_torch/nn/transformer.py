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
``"local"`` (plain blockwise, :func:`heat_tpu_torch.parallel.local_attention`)
or ``"flash"`` (the flash kernel,
:func:`heat_tpu_torch.parallel.flash_attention`); ``"ring"`` and
``"ulysses"`` need collectives the port does not have yet and raise.

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
"""

from __future__ import annotations

import math
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

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


def _attend(q, k, v, *, impl, causal, block_size, flash_bwd_impl):
    if impl == "flash":
        if block_size is None:  # the kernel's default tiles
            return flash_attention(q, k, v, causal=causal, bwd_impl=flash_bwd_impl)
        return flash_attention(q, k, v, causal=causal, block_q=block_size, block_k=block_size,
                               bwd_impl=flash_bwd_impl)
    if impl == "ring":
        return ring_attention(q, k, v)
    if impl == "ulysses":
        return ulysses_attention(q, k, v)
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
        o = _attend(q, k, v, impl=self.attn_impl, causal=self.causal,
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


class TransformerLM(nn.Module):
    """Causal LM: token embedding → blocks → final LN → logits.

    ``remat``/``remat_policy`` are accepted for the flax signature; they
    trade backward FLOPs for activation memory and take effect with the
    training slice (an inference forward keeps no activations)."""

    def __init__(self, vocab_size: int, d_model: int, num_heads: int, num_layers: int,
                 max_len: int = 2048, mlp_ratio: float = 4.0, attn_impl: str = "local",
                 comm: Optional[Any] = None, block_size: Optional[int] = None,
                 remat: bool = False, remat_policy: Optional[str] = None,
                 dtype: torch.dtype = torch.float32, flash_bwd_impl: str = "two_pass", *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        dev, gen = _setup(device, generator)
        self.vocab_size, self.d_model, self.max_len = vocab_size, d_model, max_len
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
        if t > self.max_len:
            raise ValueError(f"sequence length {t} exceeds max_len {self.max_len}")
        x = F.embedding(tokens, self.embed).to(self.dtype)
        x = x + self.pos[:t].to(self.dtype)[None]
        for block in self.blocks:
            x = block(x)
        return F.linear(self.ln_f(x), self.lm_head.to(self.dtype))
