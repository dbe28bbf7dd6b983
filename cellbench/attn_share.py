"""The share of the window's attention dispatches that ran the port's
fused kernel, from the port's counters ``attn.fused`` and ``attn.unfused``
(``repro_torch.core.engine``: one count a dispatch, under the arm that
ran it).  None in an untraced run and on a program without those
counters, so the metric is left out."""

from __future__ import annotations

from typing import Optional

from cellbench.spans import _recorder

__all__ = ["fused_share"]


def fused_share(r) -> Optional[float]:
    """``attn.fused`` dispatches over ``attn.fused`` and ``attn.unfused``,
    in %."""
    spans = _recorder(r)
    if spans is None:
        return None
    fused, unfused = (spans.counter(name) for name in ("attn.fused", "attn.unfused"))
    if fused is None and unfused is None:
        return None
    n_fused, n_unfused = (c[1] if c else 0 for c in (fused, unfused))
    return 100.0 * n_fused / (n_fused + n_unfused)
