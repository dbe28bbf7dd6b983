"""The traced window (``--trace 1``): ``torch.profiler`` over the whole
measured window, CPU and CUDA activity, and the reduction of its events
to what the per-layer readers take.

* ``busy_s``: the union of the device's kernel intervals (a time in
  which any kernel ran counts once, however many overlapped) -- the
  arithmetic of the port's ``chip_smoke.py`` busy share, taken over the
  whole window;
* ``kernels``: every kernel's name and device seconds, for readers that
  classify them by name;
* the breakdown: the ten kernels that took most device time, and the
  idle gaps between kernels summed by what the host was doing (the
  benchmark's own span, and the innermost CPU operation running when
  the gap began).

Spans: ``span(name)`` marks a phase of the benchmark's loop in the trace
(``cellbench.<name>``); outside a traced window it costs nothing.
"""

from __future__ import annotations

import bisect
import contextlib
import re
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

__all__ = ["TraceData", "Tracer", "short_name"]

SPAN_PREFIX = "cellbench."


def short_name(name: str, width: int = 96) -> str:
    """A kernel's name without its template and argument lists."""
    base = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return (re.split(r"[<(]", base, maxsplit=1)[0].strip() or base)[:width]


@dataclass
class TraceData:
    window_s: float
    busy_s: float
    kernels: List[Tuple[str, float]] = field(default_factory=list)  # (name, device s)
    device_ops: List[list] = field(default_factory=list)
    idle_gaps: List[list] = field(default_factory=list)

    def kernel_seconds(self, pattern: str) -> float:
        """Device seconds of the kernels whose name matches ``pattern``."""
        rx = re.compile(pattern)
        return sum(s for n, s in self.kernels if rx.search(n))


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


class Tracer:
    """``with tracer.window(device):`` around the measured window; after it,
    ``tracer.data`` holds the reduction (None when not tracing)."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.data: Optional[TraceData] = None
        self._active = False

    def span(self, name: str):
        if not self._active:
            return contextlib.nullcontext()
        return torch.profiler.record_function(SPAN_PREFIX + name)

    @contextlib.contextmanager
    def window(self, device):
        if not self.enabled:
            yield
            return
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()
        self._active = True
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize()
            window_s = time.perf_counter() - t0
            self._active = False
            prof.stop()
        self.data = _reduce(prof, window_s)


def _reduce(prof, window_s: float) -> TraceData:
    """Reads the profiler's raw events (no per-event Python objects: a
    window of serving holds millions)."""
    from torch.autograd import DeviceType

    kern: List[Tuple[float, float]] = []
    by_name: Dict[str, float] = {}
    names: List[Tuple[str, float]] = []
    spans: List[Tuple[float, float, str]] = []
    ops: List[Tuple[float, float, str]] = []
    for e in prof.profiler.kineto_results.events():
        name, dev = e.name(), e.device_type()
        start = e.start_ns() / 1e3
        end = start + e.duration_ns() / 1e3
        if e.is_user_annotation() or name.startswith(SPAN_PREFIX):
            if dev == DeviceType.CPU:  # its mirror on the device timeline is no kernel
                spans.append((start, end, name.removeprefix(SPAN_PREFIX)))
        elif dev == DeviceType.CUDA:
            if end <= start:
                continue
            kern.append((start, end))
            dur = (end - start) / 1e6
            names.append((name, dur))
            key = short_name(name)
            by_name[key] = by_name.get(key, 0.0) + dur
        else:
            ops.append((start, end, name))
    merged = _union(kern)
    busy_s = sum(b - a for a, b in merged) / 1e6
    gaps: Dict[str, List[float]] = {}
    spans.sort()
    ops.sort()
    span_starts = [s[0] for s in spans]
    op_starts = [o[0] for o in ops]
    for (_, end), (start, _) in zip(merged, merged[1:]):
        label = _label(end, spans, span_starts, ops, op_starts)
        g = gaps.setdefault(label, [0.0, 0])
        g[0] += (start - end) / 1e6
        g[1] += 1
    device_ops = sorted(([n, s] for n, s in by_name.items()), key=lambda x: -x[1])[:10]
    idle = sorted(([f"{k} x{v[1]}", v[0]] for k, v in gaps.items()), key=lambda x: -x[1])[:10]
    return TraceData(window_s=window_s, busy_s=busy_s, kernels=names,
                     device_ops=device_ops, idle_gaps=idle)


def _covering(t: float, items, starts) -> Optional[str]:
    """The latest-starting item that covers time ``t`` (the innermost of
    nested ones)."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - 64, -1), -1):  # the spans nest; look a little way back
        a, b, name = items[j]
        if b >= t:
            return name
    return None


def _label(t: float, spans, span_starts, ops, op_starts) -> str:
    span = _covering(t, spans, span_starts) or "outside spans"
    op = _covering(t, ops, op_starts)
    return f"{span}: {op}" if op else span
