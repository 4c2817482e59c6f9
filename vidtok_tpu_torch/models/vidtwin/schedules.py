"""VidTwin's learning-rate schedules (``vidtok_tpu/models/vidtwin/
schedules.py``; reference vidtwin/models/vidtwin_ae.py:1504-1567 and HF's
inverse square root): plain functions from a step, counted from 0, to a
learning rate (Python floats)."""

from __future__ import annotations

import math
from typing import Callable

Schedule = Callable[[int], float]


def lambda_warmup_cosine(lr_min, lr_max, lr_start, warmup_steps, total_steps) -> Schedule:
    """Linear ``lr_start`` -> ``lr_max`` over the warm-up, then cosine
    ``lr_max`` -> ``lr_min`` (``LambdaWarmUpCosineScheduler``)."""

    def sched(step):
        if step < warmup_steps:
            return (lr_max - lr_start) / max(warmup_steps, 1) * step + lr_start
        t = min(max((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0), 1.0)
        return lr_min + 0.5 * (lr_max - lr_min) * (1 + math.cos(t * math.pi))

    return sched


def linear_warmup(target_lr, warmup_steps, total_steps) -> Schedule:
    """Linear warm-up, then linear decay to 0 at ``total_steps``
    (``LinearWarmupScheduler``)."""

    def sched(step):
        if step < warmup_steps:
            return target_lr * step / max(warmup_steps, 1)
        return max(target_lr * (1.0 - step / max(total_steps, 1)), 0.0)

    return sched


def constant_warmup(base_lr, warmup_steps) -> Schedule:
    """Linear warm-up, then constant (``ConstantWarmupScheduler``)."""

    def sched(step):
        return base_lr * step / max(warmup_steps, 1) if step < warmup_steps else base_lr

    return sched


def inverse_sqrt(base_lr, num_warmup_steps) -> Schedule:
    """HF ``get_inverse_sqrt_schedule``: linear warm-up, then
    ``base_lr * sqrt(warmup / step)``."""

    def sched(step):
        if step < num_warmup_steps:
            return base_lr * step / max(num_warmup_steps, 1)
        return base_lr * math.sqrt(num_warmup_steps / max(step, 1.0))

    return sched


def from_config(cfg, base_lr: float, total_steps: int) -> Schedule:
    """The schedule of a reference ``lr_scheduler_config`` (None: constant
    after 500 warm-up steps)."""
    if cfg is None:
        return constant_warmup(base_lr, 500)
    target = cfg.get("target", "")
    p = cfg.get("params", {}) or {}
    if "inverse_sqrt" in target:
        return inverse_sqrt(base_lr, p.get("num_warmup_steps", 2000))
    if "LambdaWarmUpCosineScheduler" in target:
        return lambda_warmup_cosine(p.get("lr_min", 0.0), p.get("lr_max", base_lr),
                                    p.get("lr_start", 0.0), p.get("warmup_steps", 0),
                                    total_steps)
    if "LinearWarmupScheduler" in target:
        return linear_warmup(p.get("target_lr", base_lr), p.get("warmup_steps", 0),
                             total_steps)
    return constant_warmup(base_lr, 500)
