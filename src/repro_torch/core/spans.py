"""Spans and counters inside the port, on the profiler's clock.

``span(name, device=None, **ids)`` marks a piece of work where it
happens (the optimizer update, the attention backward, the engine's
step, prefill and decode); ``add(name, ns)`` accumulates a counter (the
dispatch path's host time).  Both record only while recording is on:

* while a ``torch.profiler`` session runs -- each span then also opens a
  ``torch.profiler.record_function(name)``, so it lies in the Kineto
  trace on the same clock as the CUDA kernels, and a trace's idle gaps
  can be labelled by the port's layers;
* inside ``recording()`` (tests, an operator's own reading).

A new session (a profiler's start, or ``recording()``'s entry) drops the
last one's records; they stay readable after it ends.  Off, ``span``
returns one shared null context and ``add``/``stamp`` return at once:
one boolean check, no allocation, no clock read.

On, a span keeps a record: its name, its parent (the span open around
it in the same context: a context variable, so the autograd engine's
device thread, which does not see the caller's context, records none),
its ids, and its host start and end on ``time.perf_counter_ns()``.  A
span opened with a CUDA ``device`` also records a ``torch.cuda.Event``
pair on the current stream at its edges, resolved to device time only
when the records are read; elsewhere its device time is its host time.

Readers take aggregates by name (``summary``): the count, host and
device seconds, each span's durations, and its self time -- its host
duration less the part its child spans cover.  ``counter`` gives a
counter's nanoseconds and count.

An id or a counted amount may be a device tensor (one element): it is
kept as it is and read only when the records or the counter are read,
so that recording does not wait for the device.
"""

from __future__ import annotations

import contextlib
import contextvars
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
import torch.autograd.profiler as _profiler

__all__ = ["Span", "Summary", "span", "record", "add", "stamp", "enabled", "recording",
           "records", "summary", "counter"]

_NULL = contextlib.nullcontext()
_COUNTER_LOCK = threading.Lock()  # the autograd engine's threads count too


class _State:
    forced = False  # inside recording()
    spans: List["Span"] = []
    counters: Dict[str, List[int]] = {}  # name -> [ns, n]
    deferred: Dict[str, List[torch.Tensor]] = {}  # name -> amounts not read yet


_PARENT: contextvars.ContextVar[Optional["Span"]] = contextvars.ContextVar(
    "repro_torch_span", default=None)


def enabled() -> bool:
    """Whether spans and counters record now."""
    return _profiler._is_profiler_enabled or _State.forced


def _new_session() -> None:
    _State.spans = []
    _State.counters = {}
    _State.deferred = {}


def _hook_profiler_start() -> None:
    """Drop the records at every profiler session's start: torch calls
    ``_run_on_profiler_start`` from each profiler's start, and exposes no
    other notice of one (``tests/test_torch_spans.py`` pins both)."""
    start = _profiler._run_on_profiler_start
    if getattr(start, "_drops_span_records", False):
        return

    def on_start():
        _new_session()
        start()

    on_start._drops_span_records = True
    _profiler._run_on_profiler_start = on_start


_hook_profiler_start()


class Span:
    """One finished span (or one still open, ``end_ns`` 0)."""

    __slots__ = ("name", "parent", "ids", "start_ns", "end_ns", "child_ns", "events")

    def __init__(self, name: str, parent: Optional["Span"], ids: Dict, start_ns: int = 0,
                 end_ns: int = 0, events=None):
        self.name, self.parent, self.ids = name, parent, ids
        self.start_ns, self.end_ns, self.child_ns = start_ns, end_ns, 0
        self.events = events

    @property
    def host_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    @property
    def self_s(self) -> float:
        return (self.end_ns - self.start_ns - self.child_ns) / 1e9

    @property
    def device_s(self) -> float:
        if self.events is None:
            return self.host_s
        first, last = self.events
        last.synchronize()
        return first.elapsed_time(last) / 1e3


def _cuda_stream(device):
    """The current stream of ``device`` if it is a CUDA device, else None."""
    if device is None or torch.device(device).type != "cuda":
        return None
    return torch.cuda.current_stream(device)


@contextlib.contextmanager
def _open(name: str, device, ids: Dict):
    rec = Span(name, _PARENT.get(), ids)
    token = _PARENT.set(rec)
    annotation = None
    if _profiler._is_profiler_enabled:
        annotation = torch.profiler.record_function(name)
        annotation.__enter__()
    stream = _cuda_stream(device)
    if stream is not None:
        rec.events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        rec.events[0].record(stream)
    rec.start_ns = time.perf_counter_ns()
    try:
        yield rec
    finally:
        rec.end_ns = time.perf_counter_ns()
        if stream is not None:
            rec.events[1].record(stream)
        if annotation is not None:
            annotation.__exit__(None, None, None)
        _PARENT.reset(token)
        if rec.parent is not None:
            rec.parent.child_ns += rec.end_ns - rec.start_ns
        _State.spans.append(rec)


def span(name: str, device=None, **ids):
    """A context manager around one piece of work (the module docstring);
    yields its ``Span`` while recording, else None."""
    if not enabled():
        return _NULL
    return _open(name, device, ids)


def record(name: str, start_ns: int, end_ns: int, **ids) -> None:
    """A span that has already ended (a wait measured after the fact):
    kept in memory only, with no parent and no profiler annotation."""
    if enabled():
        _State.spans.append(Span(name, None, ids, start_ns, end_ns))


def add(name: str, ns, n: int = 1) -> None:
    """Add ``ns`` nanoseconds (or another amount; a device tensor is read
    when the counter is) and ``n`` to the counter ``name``."""
    if enabled():
        with _COUNTER_LOCK:
            c = _State.counters.setdefault(name, [0, 0])
            if isinstance(ns, torch.Tensor):
                _State.deferred.setdefault(name, []).append(ns)
            else:
                c[0] += ns
            c[1] += n


def stamp() -> int:
    """``time.perf_counter_ns()`` while recording, else 0: the start of an
    interval a caller counts with ``add``."""
    return time.perf_counter_ns() if enabled() else 0


@contextlib.contextmanager
def recording():
    """Record inside the block, with or without a profiler; a new session."""
    _new_session()
    prev, _State.forced = _State.forced, True
    try:
        yield
    finally:
        _State.forced = prev


def _read(values: List[torch.Tensor]) -> List:
    """The numbers of one-element tensors, read in one transfer."""
    return torch.stack([v.reshape(()) for v in values]).tolist()


def records(name: Optional[str] = None) -> List[Span]:
    """The finished spans of the last session (of ``name``), in the order
    they ended, their tensor ids read."""
    found = [s for s in _State.spans if name is None or s.name == name]
    pending = [(s, k) for s in found for k, v in s.ids.items() if isinstance(v, torch.Tensor)]
    if pending:
        for (s, k), x in zip(pending, _read([s.ids[k] for s, k in pending])):
            s.ids[k] = x
    return found


@dataclass
class Summary:
    """The spans of one name: their count, summed host and device
    seconds, and each one's host, device and self seconds."""

    count: int
    host_s: float
    device_s: float
    host: List[float]
    device: List[float]
    self_s: List[float]


def summary(name: str) -> Optional[Summary]:
    """The aggregate of the last session's ``name`` spans; None if none."""
    found = records(name)
    if not found:
        return None
    host = [s.host_s for s in found]
    device = [s.device_s for s in found]
    return Summary(count=len(found), host_s=sum(host), device_s=sum(device), host=host,
                   device=device, self_s=[s.self_s for s in found])


def counter(name: str) -> Optional[Tuple[int, int]]:
    """(nanoseconds, count) of the counter ``name`` in the last session;
    None if it never counted."""
    with _COUNTER_LOCK:
        c = _State.counters.get(name)
        if not c:
            return None
        pending = _State.deferred.pop(name, None)
        if pending:
            c[0] += sum(_read(pending))
        return (c[0], c[1])
