"""Learning-rate schedules: the port of ``train/schedule.py``.

:func:`polynomial_decay_with_cycle` is ``tf.train.polynomial_decay(...,
cycle=True, power=0.5)``: with cycling the decay horizon stretches to the
next multiple of ``decay_steps``, so the rate saw-tooths toward ``end_lr``.
The arithmetic runs in float32, as the JAX schedule's does.
"""

from __future__ import annotations

from typing import Callable

import numpy as np


def polynomial_decay_with_cycle(init_lr: float, decay_steps: int,
                                end_lr: float = 1e-6, power: float = 0.5,
                                cycle: bool = True
                                ) -> Callable[[int], float]:
    """Returns a schedule: step -> learning rate (a Python float)."""
    f32 = np.float32

    def schedule(step) -> float:
        step = f32(step)
        if cycle:
            mult = max(f32(1.0), np.ceil((step + f32(1e-8))
                                         / f32(decay_steps)))
            horizon = f32(decay_steps) * mult
        else:
            horizon = f32(decay_steps)
            step = min(step, horizon)
        frac = f32(1.0) - step / horizon
        return float(f32(init_lr - end_lr) * frac ** f32(power)
                     + f32(end_lr))

    return schedule
