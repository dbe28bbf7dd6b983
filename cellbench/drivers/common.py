"""What the drivers share: synchronising, the timed window of a training
loop, the dispatch counter of a traced window, and freeing the program's
state before the reference runs."""

from __future__ import annotations

import collections
import contextlib
import gc
import time
from typing import Callable, Counter, Dict, Tuple

import torch

from cellbench import weights

__all__ = ["sync", "memory_peak", "free_device", "train_window", "dispatch_counter",
           "first_grad_norms", "change_norms"]

B1 = 0.9  # the port's AdamW first-moment decay


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def memory_peak(device) -> int:
    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def free_device(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


@contextlib.contextmanager
def dispatch_counter(enabled: bool):
    """Counts every outermost dispatch by its OpKey fields
    ``(op, m, n, k, dsize, g)`` through the port's
    ``core.engine.account_dispatches`` hook; off, yields None and
    leaves the dispatch path as it is."""
    if not enabled:
        yield None
        return
    from repro_torch.core.engine import account_dispatches

    counts: Counter = collections.Counter()

    def hook(key, operands, out):
        counts[(key.op, key.m, key.n, key.k, key.dsize, key.g)] += 1

    with account_dispatches(hook):
        yield counts


def train_window(ctx, step: Callable[[int], None], first: int) -> Tuple[int, float]:
    """Steps ``first, first + 1, ...`` until ``ctx.seconds`` have passed on
    the host's clock, then until the device has finished them: returns the
    number of steps and the seconds from the first step's start to the
    device's end of the last one."""
    sync(ctx.device)
    i = first
    with ctx.tracer.window(ctx.device):
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < ctx.seconds:
            with ctx.tracer.span("train_step"):
                step(i)
            i += 1
        sync(ctx.device)
        elapsed = time.perf_counter() - t0
    return i - first, elapsed


def first_grad_norms(first_moment) -> Dict[str, float]:
    """Each leaf's norm of the first gradient as the port's AdamW took it,
    from its first moment after one step (``(1 - b1) g``)."""
    return {k: float(torch.linalg.vector_norm(v.float())) / (1 - B1)
            for k, v in weights.named(first_moment).items()}


def change_norms(params, start) -> Dict[str, float]:
    """Each leaf's norm of ``params - start``."""
    start = weights.named(start)
    return {k: float(torch.linalg.vector_norm(p.float() - start[k].float()))
            for k, p in weights.named(params).items()}
