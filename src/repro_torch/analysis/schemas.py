"""Torch-free mirror of the port's persistence-layer schemas.

The artifact validator must run without importing torch (a checkout
validates its committed JSON without pulling in the accelerator stack),
but the authoritative schema constants live in modules that import torch
at module scope (``core.measure``, ``core.selector``, ``kernels.common``).
This module mirrors exactly the constants and key grammars the validator
needs; ``tests/test_torch_analysis_kernels.py`` asserts each mirror
equals its authoritative source in the port, so the two cannot drift
silently.

The measurement-cache and selector grammars are the JAX package's (both
packages share the v5 formats).  The committed kernel sweep is the
port's own: ``benchmarks/kernel_sweep.py`` writes ``rows`` of device
times against their bounds, not the JAX package's ``results`` grid, so
its top-level and row keys mirror the port's ``benchmarks/bench_drift.py``.
"""

from __future__ import annotations

from typing import Optional, Tuple

__all__ = [
    "OPS",
    "BATCHED_OPS",
    "GROUPED_OPS",
    "MEASURE_SCHEMA_VERSION",
    "SELECTOR_SCHEMA_VERSION",
    "SERVE_SCHEMA_VERSION",
    "BENCH_KERNELS_TOP_KEYS",
    "BENCH_KERNELS_ROW_KEYS",
    "BENCH_SERVE_TOP_KEYS",
    "BENCH_SERVE_CLASS_KEYS",
    "DEFAULT_CONFIG_KEY",
    "parse_config_key",
    "parse_cache_key",
]

# mirrors repro_torch.core.opkey.OPS / BATCHED_OPS / GROUPED_OPS
OPS: Tuple[str, ...] = ("NT", "NN", "TN", "BNT", "BNN", "ATTN")
BATCHED_OPS: Tuple[str, ...] = ("BNT", "BNN")
GROUPED_OPS: Tuple[str, ...] = ("BNT", "BNN", "ATTN")

# mirrors repro_torch.core.measure.MEASURE_SCHEMA_VERSION
MEASURE_SCHEMA_VERSION = 5
# mirrors repro_torch.core.selector.SCHEMA_VERSION
SELECTOR_SCHEMA_VERSION = 5
# mirrors repro_torch.benchmarks.serve_load.SCHEMA_VERSION
SERVE_SCHEMA_VERSION = 1

# mirrors repro_torch.kernels.common.DEFAULT_CONFIG_KEY
DEFAULT_CONFIG_KEY = "default"

# mirrors repro_torch.benchmarks.bench_drift.REQUIRED_TOP_KEYS / REQUIRED_ROW_KEYS
BENCH_KERNELS_TOP_KEYS = frozenset({"rows", "dtypes", "hardware", "timing", "device", "name"})
BENCH_KERNELS_ROW_KEYS = frozenset(
    {
        "dtype", "op", "g", "m", "n", "k", "candidate", "config", "rel_err",
        "median_us", "device_us", "queued_us", "bound_us", "bound_by",
        "library_device_us",
    }
)

# mirrors repro_torch.benchmarks.bench_drift.REQUIRED_SERVE_TOP_KEYS / _CLASS_KEYS
BENCH_SERVE_TOP_KEYS = frozenset(
    {
        "schema_version", "mode", "arch", "backend", "n_slots", "max_seq",
        "buckets", "warmup", "cold_misses_after_warmup", "totals", "classes",
    }
)
BENCH_SERVE_CLASS_KEYS = frozenset(
    {"policy", "requests", "tokens", "p50_ms", "p99_ms", "dispatch"}
)


def parse_config_key(key: str) -> Optional[Tuple[int, ...]]:
    """Tile-config key grammar (``kernels.common.parse_config_key`` at
    either arity): 3-part GEMM ``BMxBNxBK`` keys and 2-part keys -- the
    transpose kernel's ``RxC`` and the attention kernel's ``BQxBK``.
    ``'default'`` maps to None; raises ``ValueError`` on malformed keys."""
    if key == DEFAULT_CONFIG_KEY:
        return None
    try:
        parts = tuple(int(p) for p in key.split("x"))
    except ValueError:
        raise ValueError(f"malformed tile-config key {key!r}") from None
    if len(parts) not in (2, 3) or any(p <= 0 for p in parts):
        raise ValueError(f"malformed tile-config key {key!r}")
    return parts


def parse_cache_key(
    s: str, version: int = MEASURE_SCHEMA_VERSION
) -> Tuple[str, str, str, str, int, int, int, int]:
    """Measurement-cache key grammar, per schema version (mirrors
    ``core.measure._parse_key``).  Raises ``ValueError`` on malformed
    keys, including op/batch-extent violations."""
    try:
        if version >= 4:
            head, op, g, m, n, k = s.rsplit("|", 5)
        elif version == 3:
            head, op, m, n, k = s.rsplit("|", 4)
            g = 1
        else:
            head, m, n, k = s.rsplit("|", 3)
            op, g = "NT", 1
        platform, rest = head.split("|", 1)
        hardware, dtype = rest.rsplit("|", 1)
        g, m, n, k = int(g), int(m), int(n), int(k)
    except ValueError:
        raise ValueError(f"malformed measurement-cache key {s!r}") from None
    if op not in OPS:
        raise ValueError(f"cache key {s!r} names unknown op {op!r}")
    if m < 1 or n < 1 or k < 1 or g < 1:
        raise ValueError(f"cache key {s!r} has non-positive extents")
    if g != 1 and op not in GROUPED_OPS:
        raise ValueError(
            f"cache key {s!r} gives unbatched op {op!r} batch extent g={g}"
        )
    return (platform, hardware, dtype, op, g, m, n, k)
