"""Arithmetic shared by the per-layer metric readers in ``metrics/``.
Each reader takes ``r``: the cell's name, configuration and traffic,
the driver's ``counters`` and, in a traced run, the ``trace``
(``trace.TraceData``), and returns a number or None when it finds
nothing to read.  A share of a roofline or a peak is never clipped."""

from __future__ import annotations

import statistics
from typing import Optional

from cellbench import flops

__all__ = ["GEMM_OPS", "GEMM_KERNELS", "mfu", "gemm_roofline", "device_idle",
           "kernel_share", "calls_per_step", "median_ms", "occupancy"]

GEMM_OPS = ("NT", "NN", "TN", "BNT", "BNN")

# The kernels a GEMM dispatch launches, by name: the port's (csrc/*.cu: the
# NT/NN/TN/batched GEMMs, TNN's transpose, the split-k reduction) and
# cuBLAS's (sgemm/xmma/nvjet/cutlass GEMM and GEMV kernels, its split-k
# reduction).  Attention, elementwise and copy kernels are not GEMMs.
GEMM_KERNELS = (r"matmul_kernel|nt_bf16|nn_wgmma|nn_skinny|tnn_fused|gemm_f32|bmm_f32|"
                r"bmm_bf16|batched_kernel|transpose_kernel|splitk_reduce|"
                r"gemm|gemv|xmma|nvjet|cutlass|splitKreduce")


def mfu(r) -> Optional[float]:
    """Model FLOPs of the window over its seconds and the peak, in %."""
    c = r.counters
    if not c.get("window_s") or not c.get("model_flops"):
        return None
    return 100.0 * c["model_flops"] / c["window_s"] / c["peak_flops"]


def gemm_roofline(r) -> Optional[float]:
    """The bounds of every GEMM dispatch of the window over the device
    time of the GEMM kernels, in %."""
    if r.trace is None or not r.counters.get("gemms"):
        return None
    bound = sum(n * flops.gemm_bound_s(m, nn, k, dsize, g)
                for (op, m, nn, k, dsize, g), n in r.counters["gemms"].items() if op in GEMM_OPS)
    device = r.trace.kernel_seconds(GEMM_KERNELS)
    if bound <= 0 or device <= 0:
        return None
    return 100.0 * bound / device


def device_idle(r) -> Optional[float]:
    """The share of the traced window with no kernel running, in %."""
    t = r.trace
    if t is None or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def kernel_share(r, op: str) -> Optional[float]:
    """The share of ``op`` decisions that went to one of the port's kernel
    arms (``PALLAS_*``) rather than the library's, in %."""
    decisions = r.counters.get(f"{op.lower()}_decisions") or {}
    total = sum(decisions.values())
    if not total:
        return None
    return 100.0 * sum(v for k, v in decisions.items() if k.startswith("PALLAS")) / total


def calls_per_step(r) -> Optional[float]:
    c = r.counters
    if not c.get("gemms") or not c.get("steps"):
        return None
    return sum(c["gemms"].values()) / c["steps"]


def median_ms(r, key: str) -> Optional[float]:
    values = r.counters.get(key) or []
    return 1e3 * statistics.median(values) if values else None


def occupancy(r) -> Optional[float]:
    c = r.counters
    rows = c.get("decode_rows") or []
    if not rows:
        return None
    return 100.0 * statistics.fmean(rows) / c["slots"]
