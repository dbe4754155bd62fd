"""Learning-rate schedules: callables from an update count to a float.

The same functions as ``wav2letter_pytorch_tpu.optim.schedules``, which are
optax schedules: ``one_cycle_lr`` is optax's ``cosine_onecycle_schedule``
(piecewise cosine interpolation between cumulative scales), which differs
from torch's ``OneCycleLR``.
"""

from __future__ import annotations

import math


def exponential_lr(init_lr: float, gamma: float, steps_per_epoch: int = 1):
    """lr = init_lr * gamma^epoch (torch ExponentialLR stepped once per
    epoch of ``steps_per_epoch`` updates)."""

    def schedule(step: int) -> float:
        return init_lr * gamma ** (int(step) // max(steps_per_epoch, 1))

    return schedule


def one_cycle_lr(max_lr: float, total_steps: int, pct_start: float = 0.3,
                 div_factor: float = 25.0, final_div_factor: float = 1e4):
    """optax ``cosine_onecycle_schedule(total_steps, max_lr, pct_start,
    div_factor, final_div_factor)``: from ``max_lr / div_factor`` up to
    ``max_lr`` at step ``int(pct_start * total_steps)``, down to
    ``max_lr / (div_factor * final_div_factor)`` at ``total_steps``, cosine
    in between, constant after."""
    if total_steps <= 0:
        raise ValueError('one_cycle_lr needs a positive total_steps')
    bounds = sorted({int(pct_start * total_steps): div_factor,
                     int(total_steps): 1.0 / (div_factor
                                              * final_div_factor)}.items())
    points, value = [(0, max_lr / div_factor)], max_lr / div_factor
    for bound, scale in bounds:
        value *= scale
        points.append((bound, value))

    def schedule(step: int) -> float:
        step = int(step)
        for (b0, v0), (b1, v1) in zip(points[:-1], points[1:]):
            if b0 <= step < b1:
                pct = (step - b0) / (b1 - b0)
                return v1 + (v0 - v1) / 2.0 * (math.cos(math.pi * pct) + 1)
        return points[-1][1] if step >= points[-1][0] else 0.0

    return schedule


def constant_lr(lr: float):
    def schedule(step: int) -> float:
        return lr

    return schedule
