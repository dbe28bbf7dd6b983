"""Fault-tolerance drill: what a candidate fault costs the dispatcher.

Exercises the chaos plane end to end in dispatch and reports, per case,
the three latencies that matter for graceful degradation (ms of wall
time per dispatch, the device synchronised after each call):

  1. healthy    -- steady-state dispatch with the selected candidate fine;
  2. first hit  -- the faulted call itself: the injected failure fires,
     the engine quarantines the arm and walks the fallback chain to the
     library arm (the one-off recovery cost);
  3. degraded   -- steady state after quarantine: the chain skips the
     quarantined arm before anything launches, so dispatch goes straight
     to the fallback with no exception on the path.

All three must give the same product as the library call (the fallback
computes the same GEMM), and the engine's ``health_report`` is printed,
so the quarantine ledger and the fallback counters show in the log.

Cases: the JAX package's (m, n, k) = (256, 512, 384) in f32, and on the
card smollm-135m's LM head at decode, NT (8, 576) x (49152, 576)^T in
bf16; both under ``fixed:PALLAS_TNN_FUSED``.

  PYTHONPATH=src python -m repro_torch.benchmarks.fault_drill --device cpu
  PYTHONPATH=src python -m repro_torch.benchmarks.fault_drill          # the card
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import engine, faults
from repro_torch.core.policy import FixedPolicy, use_policy

from .common import device_label, save_json, section

__all__ = ["fault_drill", "main", "CASES"]

CANDIDATE = "PALLAS_TNN_FUSED"
# (label, m, n, k, dtype, card only)
CASES = (
    ("reference (256,512,384) f32", 256, 512, 384, "float32", False),
    ("smollm LM head (8,576)x(49152,576)^T bf16", 8, 49152, 576, "bfloat16", True),
)


def _call(a, b, dev) -> torch.Tensor:
    out = engine.dispatch("NT", a, b)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out


def _timed_dispatch(a, b, dev, reps: int) -> float:
    """Median wall ms of one dispatch over ``reps`` calls."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        _call(a, b, dev)
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3


def _drill(label, m, n, k, dtype, dev, reps: int) -> Dict:
    gen = torch.Generator(device=dev).manual_seed(0)
    dt = getattr(torch, dtype)
    a = torch.randn((m, k), generator=gen, device=dev).to(dt)
    b = torch.randn((n, k), generator=gen, device=dev).to(dt)
    expect = torch.matmul(a.float(), b.float().t())
    tol = 1e-5 * k ** 0.5 if dtype == "float32" else 2e-2 * k ** 0.5

    def close(out) -> float:
        err = float((out.float() - expect).abs().max() / expect.abs().max().clamp_min(1.0))
        if not err <= tol:
            raise AssertionError(f"{label}: relative error {err:.2e} beyond {tol:.2e}")
        return err

    faults.clear_quarantine()
    row = {"case": label, "m": m, "n": n, "k": k, "dtype": dtype, "candidate": CANDIDATE,
           "reps": reps}
    with use_policy(FixedPolicy(CANDIDATE)):
        # 1. healthy steady state (the first call builds and warms)
        row["healthy_err"] = close(_call(a, b, dev))
        row["healthy_ms"] = _timed_dispatch(a, b, dev, reps)
        # 2. the faulted call: the injection fires, the engine quarantines
        #    the arm and falls back down the chain to the library arm
        with faults.inject_faults(f"raise:{CANDIDATE}.NT"):
            t0 = time.perf_counter()
            hit = _call(a, b, dev)
            row["first_fault_ms"] = (time.perf_counter() - t0) * 1e3
            row["first_fault_err"] = close(hit)
            # 3. degraded steady state: the quarantined arm is skipped
            if not faults.is_quarantined(CANDIDATE, "NT"):
                raise AssertionError(f"{label}: {CANDIDATE} was not quarantined")
            row["degraded_err"] = close(_call(a, b, dev))
            row["degraded_ms"] = _timed_dispatch(a, b, dev, reps)
    row["quarantined_arms"] = [f"{e.op}:{e.label()}" for e in faults.quarantine_entries()]
    row["fallbacks"] = {f"{op}:{sel}->{ex}": cnt
                        for (op, sel, ex), cnt in sorted(faults.fallback_counts().items())}
    print(f"  {label}")
    print(f"    {'healthy':<12s} {row['healthy_ms']:8.3f} ms/dispatch")
    print(f"    {'first fault':<12s} {row['first_fault_ms']:8.3f} ms "
          "(fallback walk + quarantine, one-off)")
    print(f"    {'degraded':<12s} {row['degraded_ms']:8.3f} ms/dispatch "
          "(quarantine routes around the arm)")
    print(engine.health_report())
    faults.clear_quarantine()
    return row


def fault_drill(device="cuda", quick: bool = True) -> Dict:
    section("Fault drill -- dispatch latency healthy / faulted / quarantined")
    dev = resolve_device(device)
    reps = 10 if quick else 50
    rows: List[Dict] = [
        _drill(label, m, n, k, dtype, dev, reps)
        for label, m, n, k, dtype, card_only in CASES
        if dev.type == "cuda" or not card_only
    ]
    out = {"cases": rows, "timing": "wall ms per dispatch, device synchronised",
           **device_label(dev)}
    save_json("fault_drill", out)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda")
    grp = ap.add_mutually_exclusive_group()
    grp.add_argument("--quick", action="store_true", help="10 reps a phase (the default)")
    grp.add_argument("--full", action="store_true", help="50 reps a phase")
    args = ap.parse_args(argv)
    fault_drill(device=args.device, quick=not args.full)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
