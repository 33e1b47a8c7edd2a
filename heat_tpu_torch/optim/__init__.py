"""Distributed optimizers and learning-rate schedules (counterpart of
``heat_tpu/optim``): ``DataParallelOptimizer``, ``DASO``,
``ZeroOptimizer``, ``DetectMetricPlateau`` and ``lr_scheduler``.

As the reference Heat's ``heat.optim`` (:19-36), every other name falls
through to ``torch.optim`` (``heat_tpu_torch.optim.AdamW`` is
``torch.optim.AdamW``); the JAX package falls through to optax.
"""

from . import lr_scheduler, utils
from .dp_optimizer import DASO, DataParallelOptimizer
from .utils import DetectMetricPlateau
from .zero_optimizer import ZeroOptimizer

__all__ = ["DASO", "DataParallelOptimizer", "DetectMetricPlateau", "ZeroOptimizer",
           "lr_scheduler", "utils"]


def __getattr__(name):
    """Fall through to torch.optim (reference optim/__init__.py:19-36)."""
    import torch.optim

    try:
        return getattr(torch.optim, name)
    except AttributeError:
        raise AttributeError(
            f"module {name} not implemented in torch.optim or heat_tpu_torch.optim") from None
