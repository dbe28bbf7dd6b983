"""The device time of the kernels launched under the port's spans, from
the traced window's profiler.

The profiler links every kernel to the host operation that launched it
(its ``linked_correlation_id`` is that operation's ``correlation_id``,
as ``torch.autograd.profiler`` attaches kernels to operations; a CUDA
call made outside any operation carries an id of another count, and is
left out).  A kernel lies under a span when that operation started
inside the span; its time is its own interval on the device, so the
device's idle time inside a span never counts.  For each name of span, ``Under`` holds the
union of those intervals (a time in which any of them ran counts once:
at most the window's busy time) and their device seconds by kernel.

``SpanTracer`` is ``trace.Tracer`` whose data carries this as ``under``
({span name: Under}); readers take it with ``under`` and ``busy_share``,
which return None where the program has no such span.
"""

from __future__ import annotations

import contextlib
import re
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from cellbench.trace import Tracer, _reduce, short_name

__all__ = ["PREFIX", "Under", "SpanTracer", "kernels_under", "under", "busy_share"]

PREFIX = "repro_torch."
_API = re.compile(r"cu(da)?[A-Z]")  # the CUDA runtime's and driver's calls


@dataclass
class Under:
    busy_s: float
    kernels: Dict[str, float]  # short kernel name -> device s


def _union_ns(a: np.ndarray, b: np.ndarray) -> int:
    """The length of the union of the intervals [a, b)."""
    order = np.argsort(a, kind="stable")
    a, b = a[order], b[order]
    new = np.ones(len(a), dtype=bool)
    new[1:] = a[1:] > np.maximum.accumulate(b)[:-1]
    first = np.flatnonzero(new)
    return int((np.maximum.reduceat(b, first) - a[first]).sum())


def kernels_under(events, prefix: str = PREFIX) -> Dict[str, Under]:
    """For each span named ``prefix...`` among the profiler's ``events``
    (Kineto's), the kernels launched under it."""
    from torch.autograd import DeviceType

    started: Dict[int, int] = {}  # a host operation's correlation id -> its start, ns
    spans: Dict[str, List[Tuple[int, int]]] = {}
    links: List[int] = []
    starts: List[int] = []
    ends: List[int] = []
    kinds: List[int] = []
    index: Dict[str, int] = {}
    for e in events:
        dev = e.device_type()
        if dev == DeviceType.CUDA:
            d = e.duration_ns()
            if e.is_user_annotation() or d <= 0:  # a span's mirror on the device is no kernel
                continue
            s = e.start_ns()
            links.append(e.linked_correlation_id())
            starts.append(s)
            ends.append(s + d)
            kinds.append(index.setdefault(short_name(e.name()), len(index)))
        elif dev == DeviceType.CPU and e.linked_correlation_id() == 0:
            name = e.name()
            if _API.match(name):  # a CUDA call outside any operation: its id is CUPTI's
                continue
            s = e.start_ns()
            started[e.correlation_id()] = s
            if name.startswith(prefix):
                spans.setdefault(name, []).append((s, s + e.duration_ns()))
    if not starts:
        return {}
    launch = np.array([started.get(c, -1) for c in links], dtype=np.int64)
    ks, ke = np.array(starts, dtype=np.int64), np.array(ends, dtype=np.int64)
    kind = np.array(kinds, dtype=np.int64)
    names = list(index)
    out = {}
    for name, iv in spans.items():
        iv.sort()
        lo = np.array([a for a, _ in iv], dtype=np.int64)
        reach = np.maximum.accumulate(np.array([b for _, b in iv], dtype=np.int64))
        i = np.searchsorted(lo, launch, side="right") - 1
        inside = (launch >= 0) & (i >= 0) & (reach[np.maximum(i, 0)] >= launch)
        if not inside.any():
            out[name] = Under(0.0, {})
            continue
        per = np.bincount(kind[inside], weights=(ke - ks)[inside], minlength=len(names))
        out[name] = Under(busy_s=_union_ns(ks[inside], ke[inside]) / 1e9,
                          kernels={names[j]: float(per[j]) / 1e9 for j in np.flatnonzero(per)})
    return out


class SpanTracer(Tracer):
    """``trace.Tracer``, its data also carrying ``under``."""

    @contextlib.contextmanager
    def window(self, device):
        if not self.enabled:
            yield
            return
        from torch.profiler import ProfilerActivity, profile

        cuda = torch.device(device).type == "cuda"
        prof = profile(activities=[ProfilerActivity.CPU]
                       + ([ProfilerActivity.CUDA] if cuda else []))
        prof.start()
        self._active = True
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if cuda:
                torch.cuda.synchronize()
            window_s = time.perf_counter() - t0
            self._active = False
            prof.stop()
        self.data = _reduce(prof, window_s)
        self.data.under = kernels_under(prof.profiler.kineto_results.events())


def under(r, name: str) -> Optional[Under]:
    """The kernels under the ``repro_torch.<name>`` spans of ``r``'s traced
    window, or None."""
    found = getattr(r.trace, "under", None)
    return found.get(PREFIX + name) if found else None


def busy_share(r, name: str) -> Optional[float]:
    """The device time under the ``name`` spans over the window's busy
    time, in %."""
    u = under(r, name)
    if u is None or r.trace.busy_s <= 0:
        return None
    return 100.0 * u.busy_s / r.trace.busy_s
