"""Shared helpers of the port's benchmarks: the measured selection dataset
of a device (measured once per process, or loaded from a measurement
cache a caller already filled), histograms, device timing and output.

Every benchmark prints a human-readable section and returns a JSON-able
dict.  Times come from the device the benchmark runs on (the card unless
the caller asks for the CPU), and every result names that device.  A
result computed from the roofline says ``"source": "analytic"``, one
from timings ``"source": "measured"``.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Sequence, Tuple

from repro_torch import resolve_device
from repro_torch.core import (
    MeasurementCache,
    dataset_from_measurements,
    device_spec,
    measure_candidates,
    paper_grid,
)
from repro_torch.core.candidates import current_platform

# The NT pair the card's selector learns: cuBLAS NT against the paper's own
# TNN, the transpose kernel then the NN kernel.  The other NT candidates
# are timed beside them for the k-way mode.
CARD_PAIR: Tuple[str, str] = ("XLA_NT", "PALLAS_TNN")
MEASURED_OPS: Tuple[str, ...] = ("NT", "NN", "TN")


def measure_grid(
    cache: MeasurementCache,
    dtype: str,
    lo: int = 7,
    hi: int = 12,
    ops: Sequence[str] = MEASURED_OPS,
    device="cuda",
    reps: int = 3,
    tune: bool = False,
    queued: bool = False,
    failures: Optional[Dict] = None,
) -> MeasurementCache:
    """Fill ``cache`` with ``measure_candidates`` of every candidate of each
    op in ``ops`` over the paper grid {2^lo..2^hi}^3 in ``dtype`` on
    ``device`` (the OOM guard skips what does not fit): each candidate's
    own plan, and with ``tune`` its shortlisted tile configs too.  Each
    entry keeps its try counts (``cache.get_attempts``); a pair that kept
    failing is left out of its entry and, with ``failures``, recorded
    there under its ``(op, m, n, k)``."""
    import torch

    dev = resolve_device(device)
    hw = device_spec(dev)
    platform = current_platform(torch.empty(0, device=dev))
    for op in ops:
        for m, n, k in paper_grid(lo, hi):
            attempts, dropped = {}, {}
            times = measure_candidates(m, n, k, dtype=dtype, op=op, hardware=hw,
                                       reps=reps, device=dev, tune=tune, queued=queued,
                                       attempts=attempts, failures=dropped)
            cache.put((platform, hw.name, dtype, op, 1, m, n, k), times, attempts=attempts)
            if dropped and failures is not None:
                failures[(op, m, n, k)] = dropped
    return cache


def measured_dataset(full: bool = False, dtype: str = "float32", device="cuda",
                     pair: Tuple[str, str] = CARD_PAIR, hi: Optional[int] = None):
    """The selection dataset of ``device``: NT, NN and TN records over the
    paper grid -- {2^7..2^16}^3 with ``full``, else {2^7..2^hi}^3 (hi 12 by
    default) -- each labelled against its op's pair (``pair`` for NT), from
    device time on the card (``bench_fn(queued=True)``).  Returns the
    dataset and the filled cache."""
    dev = resolve_device(device)
    cache = measure_grid(MeasurementCache(), dtype, hi=16 if full else (hi or 12), device=dev,
                         queued=True)
    ds = dataset_from_measurements(cache, pair=pair, dtype=dtype)
    return ds, cache


def save_json(name: str, payload, out_dir: str = os.path.join("build", "bench")) -> str:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{name}.json")
    with open(path, "w") as fh:
        json.dump(payload, fh, indent=1, default=float)
    return path


def section(title: str) -> None:
    print("\n" + "=" * 72)
    print(title)
    print("=" * 72)


def device_label(device) -> Dict[str, str]:
    """What a result ran on: the device type and, on the card, its name."""
    import torch

    dev = resolve_device(device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    return {"device": str(dev), "name": name}


# Measured grids of this process, keyed by (cache path, dtype, device, hi):
# the paper benchmarks of one run share one measurement.
_GRIDS: Dict[Tuple, MeasurementCache] = {}


def card_cache(dtype: str = "float32", device="cuda", full: bool = False,
               hi: Optional[int] = None, cache: Optional[str] = None) -> MeasurementCache:
    """The measured NT/NN/TN grid {2^7..2^hi}^3 of ``device`` (hi 16 with
    ``full``, else 12): loaded from ``cache`` when that file exists (as
    ``chip_smoke.py``'s phase 9 leaves ``build/measured_{bf16,f32}.json``),
    else measured in device time on the card, and saved there when a path
    is given."""
    dev = resolve_device(device)
    hi = 16 if full else (hi or 12)
    key = (cache, dtype, str(dev), hi)
    if key not in _GRIDS:
        if cache and os.path.exists(cache):
            _GRIDS[key] = MeasurementCache.load(cache, missing_ok=False)
        else:
            _GRIDS[key] = measure_grid(MeasurementCache(cache), dtype, hi=hi, device=dev,
                                       queued=True)
            if cache:
                _GRIDS[key].save()
    return _GRIDS[key]


def op_dataset(cache: MeasurementCache, op: str = "NT", dtype: str = "float32",
               pair: Tuple[str, str] = CARD_PAIR):
    """The selection dataset of one op's records of ``cache`` (the paper's
    setting: NT, labelled against ``pair``)."""
    sub = MeasurementCache()
    for key, times in cache.records():
        if key[3] == op:
            sub.put(key, times)
    return dataset_from_measurements(sub, pair=pair, dtype=dtype)


def hist(ratios, edges=None) -> Dict[str, float]:
    """The paper's Fig. 1/3/6 frequency buckets (last bucket = 'x+'), as in
    the JAX package's ``benchmarks/common.py``."""
    import numpy as np

    ratios = np.asarray(ratios)
    edges = edges or [0.6, 0.8, 1.0, 1.1, 1.2, 1.4, 1.6, 1.8, 2.0]
    out = {}
    prev = 0.0
    for e in edges:
        out[f"<{e}"] = float(((ratios >= prev) & (ratios < e)).mean())
        prev = e
    out[f"{edges[-1]}+"] = float((ratios >= edges[-1]).mean())
    return out


def print_hist(title: str, h: Dict[str, float]) -> None:
    print(f"  {title}")
    for k, v in h.items():
        print(f"    {k:>6s} {v * 100:5.1f}% {'#' * int(round(v * 50))}")


def device_us(fn, iters: int = 20) -> Optional[float]:
    """Mean device microseconds of the kernels one call of ``fn`` launches,
    from ``torch.profiler`` (the host's launch cost left out); None on the
    CPU, where there is no device time to read."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        return None
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(3):  # the profiler now and then records no device event
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total = sum(getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))
                    for e in prof.key_averages() if e.device_type != DeviceType.CPU)
        if total > 0:
            break
    return total / iters


# Datasheet peaks of one H100 SXM (dense): memory 3.35 TB/s; bf16 989 and
# f32 67 TFLOP/s.  The bound of a call is the larger of its bytes over the
# memory rate and its operations over the peak of its dtype.
H100_BYTES_PER_S = 3.35e12
H100_PEAK_FLOPS = {2: 989e12, 4: 67e12}


def bound_us(nbytes: float, flops: float, dsize: int) -> Tuple[float, str]:
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = flops / H100_PEAK_FLOPS[dsize]
    return max(t_bytes, t_ops) * 1e6, ("bytes" if t_bytes >= t_ops else "operations")
