"""Learning-rate schedules with linear warmup: const, linear, cosine and
const-with-cooldown (counterpart of ``clip_embeds_tpu/train/schedules.py``,
open_clip's ``scheduler.py``).

Each is a function of the update count, which is 0 for the first update (as
optax's count is), returning the learning rate as a float.
"""

from __future__ import annotations

import math
from typing import Callable

Schedule = Callable[[int], float]


def _warmup(base_lr: float, warmup: int, step: int) -> float:
    return base_lr * (step + 1) / max(warmup, 1)


def const_lr(base_lr: float, warmup: int = 0) -> Schedule:
    def fn(step: int) -> float:
        return _warmup(base_lr, warmup, step) if step < warmup else base_lr

    return fn


def linear_lr(base_lr: float, warmup: int, total_steps: int) -> Schedule:
    """Warmup, then linear decay to 0 at ``total_steps`` (the HF Trainer
    'linear' schedule of the VLM2Vec recipe)."""
    def fn(step: int) -> float:
        if step < warmup:
            return _warmup(base_lr, warmup, step)
        es = max(total_steps - warmup, 1)
        return base_lr * min(max(1.0 - (step - warmup) / es, 0.0), 1.0)

    return fn


def cosine_lr(base_lr: float, warmup: int, total_steps: int) -> Schedule:
    def fn(step: int) -> float:
        if step < warmup:
            return _warmup(base_lr, warmup, step)
        es = max(total_steps - warmup, 1)
        return 0.5 * (1 + math.cos(math.pi * (step - warmup) / es)) * base_lr

    return fn


def const_lr_cooldown(base_lr: float, warmup: int, total_steps: int,
                      cooldown_steps: int, cooldown_power: float = 1.0,
                      cooldown_end_lr: float = 0.0) -> Schedule:
    start_cooldown = total_steps - cooldown_steps

    def fn(step: int) -> float:
        if step < warmup:
            return _warmup(base_lr, warmup, step)
        if step < start_cooldown:
            return base_lr
        decay = (1 - (step - start_cooldown) / max(cooldown_steps, 1)
                 ) ** cooldown_power
        return decay * (base_lr - cooldown_end_lr) + cooldown_end_lr

    return fn
