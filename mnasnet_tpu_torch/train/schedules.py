"""LR schedules of the reference and the MnasNet lineage.

Counterpart of ``mnasnet_tpu/train/schedules.py``, with optax's schedule
formulas written out (``exponential_decay``, ``cosine_decay_schedule``,
``linear_schedule``, ``join_schedules``):

  * ``step``: x0.1 every 30 epochs;
  * ``cosine``: cosine decay to 0 over the run;
  * ``exp``: x0.97 every 2.4 epochs;
  * ``constant``.

All take a linear warmup and are per-step: a schedule maps the optimizer's
update count to a learning rate (a Python float).
"""

from __future__ import annotations

import math
from typing import Callable

Schedule = Callable[[int], float]


def _staircase_decay(init_value: float, transition_steps: int, decay_rate: float) -> Schedule:
    if transition_steps <= 0 or decay_rate == 0:
        return lambda count: init_value

    def schedule(count: int) -> float:
        if count <= 0:
            return init_value
        return init_value * decay_rate ** math.floor(count / transition_steps)

    return schedule


def _cosine_decay(init_value: float, decay_steps: int) -> Schedule:
    def schedule(count: int) -> float:
        count = min(count, decay_steps)
        return init_value * (0.5 * (1 + math.cos(math.pi * count / decay_steps)))

    return schedule


def _linear(init_value: float, end_value: float, transition_steps: int) -> Schedule:
    def schedule(count: int) -> float:
        count = min(max(count, 0), transition_steps)
        return (init_value - end_value) * (1 - count / transition_steps) + end_value

    return schedule


def make_schedule(name: str, base_lr: float, steps_per_epoch: int, epochs: int,
                  warmup_epochs: float = 0.0, step_decay_factor: float = 0.1,
                  step_decay_epochs: float = 30.0, exp_decay_factor: float = 0.97,
                  exp_decay_epochs: float = 2.4) -> Schedule:
    """The schedule ``name`` (step, cosine, exp or constant) after
    ``warmup_epochs`` of linear warmup from 0 (``schedules.py:18``)."""
    warmup_steps = int(round(warmup_epochs * steps_per_epoch))
    total_steps = max(epochs * steps_per_epoch, warmup_steps + 1)
    if name == "step":
        main = _staircase_decay(base_lr, int(round(step_decay_epochs * steps_per_epoch)),
                                step_decay_factor)
    elif name == "cosine":
        main = _cosine_decay(base_lr, max(total_steps - warmup_steps, 1))
    elif name == "exp":
        main = _staircase_decay(base_lr, int(round(exp_decay_epochs * steps_per_epoch)),
                                exp_decay_factor)
    elif name == "constant":
        main = lambda count: base_lr  # noqa: E731
    else:
        raise ValueError(f"unknown schedule {name!r}")
    if warmup_steps == 0:
        return main
    warmup = _linear(0.0, base_lr, warmup_steps)

    def schedule(count: int) -> float:
        return warmup(count) if count < warmup_steps else main(count - warmup_steps)

    return schedule


def scale_lr_for_batch(base_lr: float, batch_size: int, base_batch: int = 256) -> float:
    """Linear large-batch LR scaling (Goyal et al.)."""
    return base_lr * batch_size / base_batch
