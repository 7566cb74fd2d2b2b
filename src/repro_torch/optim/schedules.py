"""Learning-rate schedules (the JAX package's ``optim/schedules.py``): a
schedule maps a step to a learning rate (a Python float)."""
from __future__ import annotations

import math


def constant(lr: float):
    return lambda step: float(lr)


def cosine_with_warmup(peak: float, warmup_steps: int, total_steps: int,
                       floor: float = 0.0):
    """Linear warm-up to ``peak`` over ``warmup_steps``, then a half cosine
    down to ``floor`` at ``total_steps`` (held there after)."""
    def sched(step):
        step = float(step)
        if step < warmup_steps:
            return peak * step / max(warmup_steps, 1)
        prog = min(max((step - warmup_steps)
                       / max(total_steps - warmup_steps, 1), 0.0), 1.0)
        return floor + 0.5 * (peak - floor) * (1.0 + math.cos(math.pi * prog))
    return sched
