"""LR schedule (``repro.optim.schedules.warmup_constant``, the one the
train CLI uses), in f32 as the reference computes it.  The paper
(Table 5) uses linear warmup of 500 steps."""
from __future__ import annotations

import numpy as np


def warmup_constant(peak_lr: float, warmup_steps: int = 500):
    def schedule(step) -> float:
        step = np.float32(step)
        warm = np.minimum(step / np.float32(max(warmup_steps, 1)), np.float32(1.0))
        return float(np.float32(peak_lr) * warm)

    return schedule

