"""Learning-rate schedules (counterpart of ``heat_tpu/optim/lr_scheduler.py``;
reference heat/optim/lr_scheduler.py).

The torch-named factories of the JAX package, each returning a schedule
``step -> lr`` (a Python float) with the values of the optax schedule that
the JAX package returns: ``exponential_decay``, ``piecewise_constant_schedule``,
``cosine_decay_schedule`` and ``polynomial_schedule`` are written out here
in plain Python, with optax's rules for degenerate arguments. A schedule
drives a torch optimizer through ``torch.optim.lr_scheduler.LambdaLR``
(``lambda k: schedule(k) / lr``), or DASO's ``scheduler=`` with
``scheduler_base_lr=lr``.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable

__all__ = [
    "StepLR",
    "MultiStepLR",
    "ExponentialLR",
    "CosineAnnealingLR",
    "ConstantLR",
    "LinearLR",
    "PolynomialLR",
]

Schedule = Callable[[int], float]


def _exponential_decay(init_value: float, transition_steps: int, decay_rate: float,
                       staircase: bool = False) -> Schedule:
    """optax's ``exponential_decay`` (``transition_begin=0``, no end value)."""
    if transition_steps <= 0 or decay_rate == 0:
        return lambda count: float(init_value)

    def schedule(count):
        p = count / transition_steps
        if staircase:
            p = math.floor(p)
        return float(init_value) if count <= 0 else init_value * decay_rate ** p

    return schedule


def _piecewise_constant(init_value: float, boundaries_and_scales: Dict[int, float]) -> Schedule:
    """optax's ``piecewise_constant_schedule``: each scale applies from its
    boundary on."""
    if any(scale < 0.0 for scale in boundaries_and_scales.values()):
        raise ValueError("`piecewise_constant_schedule` expects non-negative scale factors")
    steps = sorted(boundaries_and_scales.items())

    def schedule(count):
        v = float(init_value)
        for threshold, scale in steps:
            if count >= threshold:
                v *= scale
        return v

    return schedule


def _cosine_decay(init_value: float, decay_steps: int, alpha: float = 0.0) -> Schedule:
    """optax's ``cosine_decay_schedule`` (exponent 1)."""
    if not decay_steps > 0:
        raise ValueError(f"The cosine_decay_schedule requires positive decay_steps, got "
                         f"decay_steps={decay_steps}.")

    def schedule(count):
        count = min(count, decay_steps)
        cosine = 0.5 * (1 + math.cos(math.pi * count / decay_steps))
        return init_value * ((1 - alpha) * cosine + alpha)

    return schedule


def _polynomial(init_value: float, end_value: float, power: float,
                transition_steps: int) -> Schedule:
    """optax's ``polynomial_schedule`` (``transition_begin=0``)."""
    if transition_steps <= 0:
        return lambda count: float(init_value)

    def schedule(count):
        count = min(max(count, 0), transition_steps)
        frac = 1 - count / transition_steps
        return (init_value - end_value) * frac ** power + end_value

    return schedule


def StepLR(lr: float, step_size: int, gamma: float = 0.1) -> Schedule:
    """lr decayed by ``gamma`` every ``step_size`` steps."""
    return _exponential_decay(lr, step_size, gamma, staircase=True)


def MultiStepLR(lr: float, milestones: Iterable[int], gamma: float = 0.1) -> Schedule:
    """lr decayed by ``gamma`` at each milestone step."""
    return _piecewise_constant(lr, {int(m): gamma for m in milestones})


def ExponentialLR(lr: float, gamma: float) -> Schedule:
    """lr decayed by ``gamma`` every step."""
    return _exponential_decay(lr, 1, gamma)


def CosineAnnealingLR(lr: float, T_max: int, eta_min: float = 0.0) -> Schedule:
    """Cosine decay from ``lr`` to ``eta_min`` over ``T_max`` steps."""
    return _cosine_decay(lr, T_max, alpha=eta_min / lr if lr else 0.0)


def ConstantLR(lr: float, factor: float = 1.0 / 3.0, total_iters: int = 5) -> Schedule:
    """``lr*factor`` for the first ``total_iters`` steps, then ``lr``."""
    return _piecewise_constant(lr * factor,
                               {int(total_iters): 1.0 / factor if factor else 1.0})


def LinearLR(lr: float, start_factor: float = 1.0 / 3.0, end_factor: float = 1.0,
             total_iters: int = 5) -> Schedule:
    """Linear ramp from ``lr*start_factor`` to ``lr*end_factor``."""
    return _polynomial(lr * start_factor, lr * end_factor, 1, total_iters)


def PolynomialLR(lr: float, total_iters: int = 5, power: float = 1.0) -> Schedule:
    """Polynomial decay to zero over ``total_iters`` steps."""
    return _polynomial(lr, 0.0, power, total_iters)
