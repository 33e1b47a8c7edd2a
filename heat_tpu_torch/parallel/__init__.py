"""Attention cores and the ring and halo schedules (counterpart of
``heat_tpu/parallel``): the plain blockwise ``local_attention``, the
``flash_attention`` kernel, the sequence-parallel ``ring_attention`` and
``ulysses_attention``, ``ring_pipeline``, ``halo_exchange`` and
``halo_stencil``."""

from .attention import local_attention, ring_attention, ulysses_attention
from .cuda_attention import flash_attention
from .halo import halo_exchange, halo_stencil
from .ring import ring_pipeline

__all__ = ["flash_attention", "halo_exchange", "halo_stencil", "local_attention",
           "ring_attention", "ring_pipeline", "ulysses_attention"]
