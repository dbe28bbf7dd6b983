"""Arithmetic shared by the readers of the port's own spans and counters
(``repro_torch.core.spans``), which record while the traced window's
profiler runs.  Each returns None in an untraced run and on a program
that has no such recorder, span or counter, so the metric is left out."""

from __future__ import annotations

import statistics
from typing import Optional

import numpy as np

__all__ = ["summary", "median_ms", "p90_ms", "counter_us"]

PREFIX = "repro_torch."


def _recorder(r):
    if r.trace is None:
        return None
    try:
        from repro_torch.core import spans
    except ImportError:
        return None
    return spans


def summary(r, name: str):
    """The aggregate of the window's ``repro_torch.<name>`` spans, or None."""
    spans = _recorder(r)
    return spans.summary(PREFIX + name) if spans is not None else None


def median_ms(r, name: str, field: str = "host") -> Optional[float]:
    """The median of one duration (``host``, ``device`` or ``self_s``) of
    the ``name`` spans, in ms."""
    s = summary(r, name)
    return 1e3 * statistics.median(getattr(s, field)) if s is not None else None


def p90_ms(r, name: str) -> Optional[float]:
    """The 90th percentile of the host durations of the ``name`` spans, in
    ms (numpy's, as `drivers/lm_serve.py` takes the first-token tail)."""
    s = summary(r, name)
    return 1e3 * float(np.percentile(s.host, 90)) if s is not None else None


def counter_us(r, name: str) -> Optional[float]:
    """The counter ``name``'s nanoseconds over its count, in us."""
    spans = _recorder(r)
    c = spans.counter(name) if spans is not None else None
    return c[0] / c[1] / 1e3 if c else None
