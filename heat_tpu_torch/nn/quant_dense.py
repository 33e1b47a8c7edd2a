"""W8A8 Dense over the int8 GEMM kernel, counterpart of ``heat_tpu/nn/quant_dense.py``."""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..core.devices import sanitize_device
from ..core.linalg import int8_matmul, quantize_int8

__all__ = ["QuantDense"]


class QuantDense(nn.Module):
    """W8A8 variant of a bias-free dense layer. The weight stays f32 in
    torch's ``(features, in_features)`` layout (the transpose of flax's
    ``kernel``) and is quantised per output feature on every call, as the
    JAX module does; activations are quantised per row. Flax infers
    ``in_features`` from the first input; here it is a constructor
    argument. The weight is initialised LeCun-normal (flax's default) from
    an explicit ``torch.Generator`` on the module's device (seeded 0 when
    none is given)."""

    def __init__(self, features: int, use_bias: bool = False,
                 dtype: torch.dtype = torch.float32, *, in_features: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = sanitize_device(device).torch_device
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        self.features, self.use_bias, self.dtype = features, use_bias, dtype
        std = math.sqrt(1.0 / in_features) / 0.87962566103423978
        w = torch.empty((features, in_features), dtype=torch.float32, device=dev)
        nn.init.trunc_normal_(w, std=std, a=-2.0 * std, b=2.0 * std, generator=generator)
        self.weight = nn.Parameter(w)
        self.bias = (nn.Parameter(torch.zeros(features, dtype=torch.float32, device=dev))
                     if use_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-1]
        xf = x.reshape(-1, x.shape[-1]).to(torch.float32)
        qx, sx = quantize_int8(xf, axis=1)
        qw, sw = quantize_int8(self.weight.T, axis=0)
        y = int8_matmul(qx, sx, qw, sw, out_dtype=torch.float32)
        if self.bias is not None:
            y = y + self.bias
        return y.reshape(*lead, self.features).to(self.dtype)
