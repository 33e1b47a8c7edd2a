"""Attention cores (counterpart of ``heat_tpu/parallel``'s attention): the
plain blockwise ``local_attention`` and the ``flash_attention`` kernel."""

from .attention import local_attention, ring_attention, ulysses_attention
from .cuda_attention import flash_attention

__all__ = ["flash_attention", "local_attention", "ring_attention", "ulysses_attention"]
