"""Data tooling and the vision transforms (counterpart of
``heat_tpu/utils``; reference heat/utils). The JAX package's
``backend_probe`` is TPU-runtime plumbing and has no counterpart."""

from . import data
from . import vision_transforms

__all__ = ["data", "vision_transforms"]
