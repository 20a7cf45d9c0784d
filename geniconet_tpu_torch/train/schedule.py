"""Cyclic triangular learning-rate schedule as a pure function of step.

Port of ``geniconet_tpu/train/schedule.py``: torch ``CyclicLR(base_lr,
max_lr, cycle_momentum=False)`` stepped every batch (reference run.py:446-452),
computed in float32 as the JAX version is.
"""

from __future__ import annotations

import numpy as np

__all__ = ["cyclic_triangular"]


def cyclic_triangular(step: int, base_lr: float, max_lr: float, step_size_up: int = 2000,
                      step_size_down: int = 2000) -> float:
    """lr(step): rises base -> max over ``step_size_up`` steps, falls back over
    ``step_size_down``, repeating. step 0 -> base_lr (torch semantics)."""
    f32 = np.float32
    pos = f32(step) % f32(step_size_up + step_size_down)
    if pos <= step_size_up:
        frac = pos / f32(step_size_up)
    else:
        frac = f32(1.0) - (pos - f32(step_size_up)) / f32(step_size_down)
    return float(f32(base_lr) + f32(max_lr - base_lr) * frac)
