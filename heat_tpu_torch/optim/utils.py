"""Optimizer utilities (counterpart of ``heat_tpu/optim/utils.py``; reference
heat/optim/utils.py).

This package's own copy of the JAX package's pure-Python
:class:`DetectMetricPlateau`, the loss-plateau detector that drives DASO's
skip decay (reference heat/optim/utils.py:14-200, itself adapted from
torch's ReduceLROnPlateau). Host-side control logic, ported by behavior:
``test_if_improving`` returns True when the metric has failed to beat the
(threshold-adjusted) best for more than ``patience`` epochs, with a
``cooldown`` window after each trigger during which bad epochs are ignored.
``get_state``/``set_state`` expose the full state dict for checkpointing.
"""

from __future__ import annotations

import math
from typing import Dict, Union

__all__ = ["DetectMetricPlateau"]


class DetectMetricPlateau:
    """Detect when a metric stops improving.

    Parameters
    ----------
    mode : 'min' or 'max'
        Whether lower or higher metric values count as improvement.
    patience : int
        Bad epochs tolerated before reporting a plateau.
    threshold : float
        Minimum significant change.
    threshold_mode : 'rel' or 'abs'
        Relative (``best * (1 ± threshold)``) or absolute (``best ±
        threshold``) comparison.
    cooldown : int
        Epochs after a trigger during which bad epochs are ignored.
    """

    def __init__(
        self,
        mode: str = "min",
        patience: int = 10,
        threshold: float = 1e-4,
        threshold_mode: str = "rel",
        cooldown: int = 0,
    ):
        if mode not in ("min", "max"):
            raise ValueError(f"mode {mode} is unknown!")
        if threshold_mode not in ("rel", "abs"):
            raise ValueError(f"threshold mode {threshold_mode} is unknown!")
        self.mode = mode
        self.patience = patience
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self.cooldown = cooldown
        self.cooldown_counter = 0
        self.mode_worse = math.inf if mode == "min" else -math.inf
        self.last_epoch = 0
        self.best = self.mode_worse
        self.num_bad_epochs = 0

    def get_state(self) -> Dict:
        """State dict for checkpointing (reference utils.py:72-87)."""
        return {
            "patience": self.patience,
            "cooldown": self.cooldown,
            "cooldown_counter": self.cooldown_counter,
            "mode": self.mode,
            "threshold": self.threshold,
            "threshold_mode": self.threshold_mode,
            "best": self.best,
            "num_bad_epochs": self.num_bad_epochs,
            "mode_worse": self.mode_worse,
            "last_epoch": self.last_epoch,
        }

    def set_state(self, dic: Dict) -> None:
        """Restore from a :meth:`get_state` dict (reference utils.py:89-108)."""
        for key in self.get_state():
            setattr(self, key, dic[key])

    def reset(self) -> None:
        """Reset counters and best value (reference utils.py:110-117)."""
        self.best = self.mode_worse
        self.cooldown_counter = 0
        self.num_bad_epochs = 0

    @property
    def in_cooldown(self) -> bool:
        return self.cooldown_counter > 0

    def is_better(self, a: float, best: float) -> bool:
        """Threshold-adjusted comparison (reference utils.py:160-186)."""
        if self.mode == "min":
            if self.threshold_mode == "rel":
                comp = (
                    best * (1.0 - self.threshold)
                    if best >= 0
                    else best * (1.0 + self.threshold)
                )
                return a < comp
            return a < best - self.threshold
        if self.threshold_mode == "rel":
            return a > best * (1.0 + self.threshold)
        return a > best + self.threshold

    def test_if_improving(self, metrics: Union[float, int]) -> bool:
        """Record one epoch's metric; return True on plateau
        (reference utils.py:119-148)."""
        current = float(metrics)
        self.last_epoch += 1

        if self.is_better(current, self.best):
            self.best = current
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1

        if self.in_cooldown:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0

        if self.num_bad_epochs > self.patience:
            self.cooldown_counter = self.cooldown
            self.num_bad_epochs = 0
            return True
        return False
