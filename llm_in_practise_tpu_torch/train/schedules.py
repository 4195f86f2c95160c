"""LR schedules mirroring the reference's set (port of
``llm_in_practise_tpu/train/schedules.py``), as plain functions of the
step count with optax's formulas.

- constant (MiniGPT)
- cosine with warmup (HF Trainer ``lr_scheduler_type="cosine"``)
- StepLR-style step decay
"""

from __future__ import annotations

import math
from typing import Callable

Schedule = Callable[[int], float]


def constant(lr: float) -> Schedule:
    return lambda count: lr


def _linear(init_value: float, end_value: float,
            transition_steps: int) -> Schedule:
    if transition_steps <= 0:
        return lambda count: init_value

    def schedule(count):
        frac = 1 - min(max(count, 0), transition_steps) / transition_steps
        return (init_value - end_value) * frac + end_value

    return schedule


def _cosine(init_value: float, decay_steps: int, alpha: float) -> Schedule:
    if not decay_steps > 0:
        raise ValueError(f"cosine decay needs decay_steps > 0, got "
                         f"{decay_steps}")

    def schedule(count):
        count = min(count, decay_steps)
        cosine = 0.5 * (1 + math.cos(math.pi * count / decay_steps))
        return init_value * ((1 - alpha) * cosine + alpha)

    return schedule


def cosine_with_warmup(lr: float, total_steps: int, warmup_steps: int = 0,
                       final_scale: float = 0.0) -> Schedule:
    """optax ``warmup_cosine_decay_schedule``: linear warmup from 0 (from
    ``lr`` without warmup) to ``lr``, then cosine decay to
    ``lr * final_scale`` at ``total_steps``."""
    if total_steps <= 0:
        raise ValueError("cosine schedule requires total_steps > 0")
    end_value = lr * final_scale
    alpha = 0.0 if lr == 0.0 else end_value / lr
    warm = _linear(0.0 if warmup_steps else lr, lr, warmup_steps)
    decay = _cosine(lr, max(total_steps, warmup_steps + 1) - warmup_steps,
                    alpha)

    def schedule(count):
        return warm(count) if count < warmup_steps else decay(
            count - warmup_steps)

    return schedule


def step_decay(lr: float, step_size: int, gamma: float = 0.5) -> Schedule:
    def schedule(count):
        return lr * gamma ** (count // step_size)

    return schedule


def by_name(name: str, lr: float, *, total_steps: int = 0,
            warmup_steps: int = 0, step_size: int = 1000,
            gamma: float = 0.5) -> Schedule:
    if name == "constant":
        return constant(lr)
    if name == "cosine":
        return cosine_with_warmup(lr, total_steps, warmup_steps)
    if name == "step":
        return step_decay(lr, step_size, gamma)
    raise ValueError(f"unknown schedule {name!r}")
