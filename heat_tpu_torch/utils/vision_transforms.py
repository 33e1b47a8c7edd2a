"""Vision transforms (counterpart of ``heat_tpu/utils/vision_transforms.py``;
the reference forwards every name to ``torchvision.transforms``).

torchvision is optional: a name resolves when it is first read, so
importing this module never needs it, and without torchvision reading one
raises the JAX package's ``ImportError``.
"""

from __future__ import annotations

__all__ = []


def __getattr__(name):
    try:
        from torchvision import transforms as _transforms
    except ImportError as e:
        raise ImportError(f"heat_tpu_torch.utils.vision_transforms.{name} requires "
                          "torchvision, which is not installed") from e
    try:
        return getattr(_transforms, name)
    except AttributeError:
        raise AttributeError(f"torchvision.transforms has no attribute {name}") from None
