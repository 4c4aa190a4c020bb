"""Learning-rate schedules as plain functions of the update step.

A copy of ``relora_tpu/core/schedules.py`` (the reference's
``training_utils.py:173-236`` lambdas, quirks included) written as Python
functions ``step -> lr``: the port sets the optimizer's rate on the host
before each applied update, so nothing here is traced.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

Schedule = Callable[[int], float]


def linear_with_warmup(peak_lr: float, warmup_steps: int, num_training_steps: int) -> Schedule:
    """HF-style linear warmup then linear decay to 0."""

    def schedule(step) -> float:
        step = float(step)
        if step < warmup_steps:
            return peak_lr * step / max(1, warmup_steps)
        return peak_lr * max(0.0, (num_training_steps - step) / max(1, num_training_steps - warmup_steps))

    return schedule


def cyclical_cosine_with_min_lr(
    peak_lr: float,
    warmup_steps: int,
    num_training_steps: int,
    cycle_length: Optional[int],
    min_lr_ratio: float = 0.1,
) -> Schedule:
    """Cyclical cosine with a min-LR floor; on later cycles the first two
    warmup steps return 1e-7 (the reference's quirk)."""
    if cycle_length is None:
        cycle_length = num_training_steps
    if num_training_steps % cycle_length != 0:
        raise ValueError(
            f"num_training_steps ({num_training_steps}) must be divisible by "
            f"cycle_length ({cycle_length})"
        )
    if not 0 < min_lr_ratio <= 1.0:
        raise ValueError("min_lr_ratio must be in (0, 1]")

    def schedule(step) -> float:
        step = float(step)
        cycle_step = step % cycle_length
        if cycle_step < warmup_steps:
            if step != cycle_step and cycle_step < 2:
                return peak_lr * 1e-7
            return peak_lr * cycle_step / max(1, warmup_steps)
        progress = (cycle_step - warmup_steps) / max(1, cycle_length - warmup_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * progress))
        return peak_lr * (min_lr_ratio + (1.0 - min_lr_ratio) * cosine)

    return schedule


def cosine_with_restarts(
    peak_lr: float,
    first_warmup_steps: int,
    restart_warmup_steps: int,
    restart_every: int,
    num_training_steps: int,
    min_lr_ratio: float = 0.1,
    adjust_step: int = 0,
) -> Schedule:
    """Cosine decay with periodic re-warmups to the decayed envelope: each
    restart ramps from 0 to the value the envelope has at the end of that
    warmup, then rejoins the global decay."""
    if restart_every is None:
        raise ValueError("restart_every (cycle_length) must be set for cosine_restarts")
    if restart_every <= 0:
        raise ValueError("restart_every must be positive")
    if num_training_steps % restart_every != 0:
        raise ValueError(
            f"num_training_steps ({num_training_steps}) must be divisible by "
            f"restart_every ({restart_every})"
        )
    if not 0 < min_lr_ratio <= 1.0:
        raise ValueError("min_lr_ratio must be in (0, 1]")
    if adjust_step + first_warmup_steps > num_training_steps:
        raise ValueError("warmup + adjust_step exceeds total training steps")
    if adjust_step + first_warmup_steps > restart_every:
        raise ValueError("the first restart would fire before the first warmup is done")

    denom = max(1, num_training_steps - first_warmup_steps)

    def envelope(progress: float) -> float:
        return min_lr_ratio + (1.0 - min_lr_ratio) * 0.5 * (1.0 + math.cos(math.pi * progress))

    def schedule(step) -> float:
        step = float(step)
        if step < first_warmup_steps:
            return peak_lr * step / max(1, first_warmup_steps)
        s = step + adjust_step
        restart_step = s % restart_every
        restart_number = s // restart_every
        if restart_step < restart_warmup_steps and step >= restart_every:
            end_of_warmup = (
                restart_number * restart_every + restart_warmup_steps - first_warmup_steps
            ) / denom
            return peak_lr * restart_step / max(1, restart_warmup_steps) * envelope(end_of_warmup)
        return peak_lr * envelope((s - first_warmup_steps) / denom)

    return schedule


def make_schedule(
    scheduler_type: str,
    *,
    lr: float,
    num_training_steps: int,
    warmup_steps: int,
    min_lr_ratio: float = 0.1,
    cycle_length: Optional[int] = None,
    restart_warmup_steps: Optional[int] = None,
    adjust_step: int = 0,
) -> Schedule:
    """Factory with the reference's dispatch semantics."""
    if adjust_step != 0 and scheduler_type != "cosine_restarts":
        raise ValueError("adjust_step is only supported for cosine_restarts")
    if scheduler_type == "linear":
        return linear_with_warmup(lr, warmup_steps, num_training_steps)
    if scheduler_type == "cosine":
        return cyclical_cosine_with_min_lr(
            lr, warmup_steps, num_training_steps, cycle_length, min_lr_ratio
        )
    if scheduler_type == "cosine_restarts":
        if restart_warmup_steps is None:
            raise ValueError("restart_warmup_steps must be set for cosine_restarts")
        return cosine_with_restarts(
            lr,
            first_warmup_steps=warmup_steps,
            restart_warmup_steps=restart_warmup_steps,
            restart_every=cycle_length,
            num_training_steps=num_training_steps,
            min_lr_ratio=min_lr_ratio,
            adjust_step=adjust_step,
        )
    raise NotImplementedError(f"Scheduler {scheduler_type!r} is not implemented")
