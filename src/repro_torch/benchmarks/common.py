"""Shared helpers of the port's benchmarks: the measured selection dataset
of a device, and output.

Every benchmark prints a human-readable section and returns a JSON-able
dict.  Times come from the device the benchmark runs on (the card unless
the caller asks for the CPU), and every result names that device.
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
) -> MeasurementCache:
    """Fill ``cache`` with ``measure_candidates`` of every candidate of each
    op in ``ops`` over the paper grid {2^lo..2^hi}^3 in ``dtype`` on
    ``device`` (the OOM guard skips what does not fit).  A candidate that
    raises fails the call."""
    import torch

    dev = resolve_device(device)
    hw = device_spec(dev)
    platform = current_platform(torch.empty(0, device=dev))
    for op in ops:
        for m, n, k in paper_grid(lo, hi):
            times = measure_candidates(m, n, k, dtype=dtype, op=op, hardware=hw,
                                       reps=reps, device=dev)
            cache.put((platform, hw.name, dtype, op, 1, m, n, k), times)
    return cache


def measured_dataset(full: bool = False, dtype: str = "float32", device="cuda",
                     pair: Tuple[str, str] = CARD_PAIR, hi: Optional[int] = None):
    """The selection dataset of ``device``: NT, NN and TN records over the
    paper grid -- {2^7..2^16}^3 with ``full``, else {2^7..2^hi}^3 (hi 12 by
    default) -- each labelled against its op's pair (``pair`` for NT).
    Returns the dataset and the filled cache."""
    dev = resolve_device(device)
    cache = measure_grid(MeasurementCache(), dtype, hi=16 if full else (hi or 12), device=dev)
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
