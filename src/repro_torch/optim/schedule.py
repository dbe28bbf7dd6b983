"""LR schedules: pure functions of the step counter, returning a float."""

from __future__ import annotations

import math

__all__ = ["warmup_cosine", "warmup_linear", "constant"]


def constant(lr: float):
    return lambda step: float(lr)


def _clip(x: float, lo: float, hi: float) -> float:
    return min(max(x, lo), hi)


def warmup_cosine(peak_lr: float, warmup: int, total: int, floor: float = 0.1):
    def sched(step) -> float:
        step = float(step)
        if step < warmup:
            return peak_lr * min(1.0, (step + 1) / max(warmup, 1))
        frac = _clip((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        return peak_lr * (floor + (1 - floor) * 0.5 * (1 + math.cos(math.pi * frac)))

    return sched


def warmup_linear(peak_lr: float, warmup: int, total: int):
    def sched(step) -> float:
        step = float(step)
        if step < warmup:
            return peak_lr * min(1.0, (step + 1) / max(warmup, 1))
        frac = _clip((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        return peak_lr * (1 - frac)

    return sched
