# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""Learning-rate schedules: plain Python `step -> lr` functions.

Counterpart of `tiny_deepspeed_tpu/optim/schedule.py`, same four
schedules with the same formulas.  The JAX versions are traceable jnp
code because the step counter is a traced scalar there; the port's step
is a host int, so these are ordinary functions of it.
"""

from __future__ import annotations

import math


def constant(lr: float):
    """A fixed lr, as a schedule."""
    def sched(step):
        del step
        return float(lr)
    return sched


def _clip(x, lo, hi):
    return min(max(x, lo), hi)


def warmup_linear(peak_lr: float, total_steps: int, warmup_steps: int = 0,
                  min_lr: float = 0.0):
    """Linear ramp 0 -> peak over `warmup_steps`, then linear decay to
    `min_lr` at `total_steps` (held there after)."""
    if peak_lr <= 0.0:
        raise ValueError(f"warmup_linear: peak_lr must be > 0, got {peak_lr}")

    def sched(step):
        t = float(step)
        if t < warmup_steps:
            return peak_lr * _clip(t / max(1.0, float(warmup_steps)),
                                   0.0, 1.0)
        frac = (t - warmup_steps) / max(1.0, float(total_steps
                                                   - warmup_steps))
        return peak_lr * (1.0 - _clip(frac, 0.0, 1.0)
                          * (1.0 - min_lr / peak_lr))
    return sched


def warmup_cosine(peak_lr: float, total_steps: int, warmup_steps: int = 0,
                  min_lr: float = 0.0):
    """Linear warmup then cosine decay to `min_lr` (the GPT-2/nanoGPT
    recipe)."""
    def sched(step):
        t = float(step)
        if t < warmup_steps:
            return peak_lr * _clip(t / max(1.0, float(warmup_steps)),
                                   0.0, 1.0)
        frac = _clip((t - warmup_steps)
                     / max(1.0, float(total_steps - warmup_steps)), 0.0, 1.0)
        return min_lr + (peak_lr - min_lr) * 0.5 * (1.0 + math.cos(
            math.pi * frac))
    return sched


def inverse_sqrt(peak_lr: float, warmup_steps: int = 1):
    """Noam/transformer schedule: linear warmup, then lr ~ 1/sqrt(step)."""
    def sched(step):
        t = max(float(step), 1.0)
        w = float(max(1, warmup_steps))
        return peak_lr * min(t / w, math.sqrt(w / t))
    return sched


SCHEDULES = {
    "constant": constant,
    "warmup_linear": warmup_linear,
    "warmup_cosine": warmup_cosine,
    "inverse_sqrt": inverse_sqrt,
}
