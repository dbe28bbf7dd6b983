"""Serving-engine load benchmark: seeded synthetic traffic, no wall-clock
randomness in the trace.

Builds a ``ServeEngine`` (two request classes with their own dispatch
policies), runs the bucket warmup, then replays a deterministic arrival
trace: request arrival steps, prompt lengths, generation lengths and
classes are all drawn from one ``np.random.RandomState(seed)`` against
the engine's *virtual* clock (``engine.clock``), so two runs with the
same seed submit identical traffic (the JAX package's ``build_trace``,
draw for draw).  Wall-clock only enters as the thing being measured
(tokens/s, per-token latency) -- never as an input.

Reports, per class and total: tokens/s, p50/p99 per-token decode
latency, and the structured dispatch rows (op -> candidate -> count), so
a caller can assert that the attention plan (ATTN) routes through each
class's own policy.  ``cold_misses_after_warmup`` must be zero: the
bucketed serve loop may only hit OpKeys the warmup pass already
measured; the run exits non-zero otherwise, and on any dispatch that
fell back or arm that was quarantined (the run injects no fault, so
either means a kernel failed).  The report's schema is the
JAX package's (``SCHEMA_VERSION``), with the device, the engine's health
and each class's measurement record (the most tries a measured pair
took, the pairs left out) beside it.

The architecture's smoke config by default, its full config with
``--full``; weights are random from ``--seed``.  On the card (the
default ``--device cuda``) or on the CPU:

  PYTHONPATH=src python -m repro_torch.benchmarks.serve_load --quick --device cpu
  PYTHONPATH=src python -m repro_torch.benchmarks.serve_load --full     # smollm-135m, card
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, smoke_config
from repro_torch.core import faults
from repro_torch.core.engine import policy_from_spec
from repro_torch.models import lm
from repro_torch.serving import ServeEngine

from .common import device_label

__all__ = ["SCHEMA_VERSION", "build_trace", "run_load", "main"]

SCHEMA_VERSION = 1


def _percentile_ms(xs, q):
    if not xs:
        return None
    return float(np.percentile(np.asarray(xs, np.float64), q)) * 1e3


def build_trace(rng, n_requests, max_prompt, max_gen, classes):
    """Deterministic arrival trace: (arrival_step, prompt, max_new, cls)."""
    trace = []
    step = 0
    for _ in range(n_requests):
        step += int(rng.randint(0, 3))  # 0-2 virtual steps between arrivals
        p_len = int(rng.randint(1, max_prompt + 1))
        prompt = rng.randint(0, 256, (p_len,)).astype(np.int32)
        max_new = int(rng.randint(2, max_gen + 1))
        cls = classes[int(rng.randint(0, len(classes)))]
        trace.append((step, prompt, max_new, cls))
    return trace


def _measurement(policy) -> dict:
    """What an autotune class's measurements took: the most tries any
    (candidate, config) pair needed, and the pairs left out after every
    try failed (both empty for the other policies)."""
    cache = getattr(policy, "cache", None)
    tries = [n for key, _ in (cache.records() if cache is not None else ())
             for per_cfg in (cache.get_attempts(key) or {}).values() for n in per_cfg.values()]
    return {"max_attempts": max(tries, default=None),
            "failures": dict(getattr(policy, "failures", {}))}


def run_load(args) -> dict:
    device = resolve_device(args.device)
    cfg = get_config(args.arch) if args.full else smoke_config(args.arch)
    policies = {
        "interactive": policy_from_spec(args.interactive_policy, device=args.device),
        "bulk": policy_from_spec(args.bulk_policy, device=args.device),
    }
    params = lm.init_lm(args.seed, cfg, device=device)
    engine = ServeEngine(
        cfg, params, n_slots=args.slots, max_seq=args.max_seq, policies=policies,
        cache_dtype=getattr(torch, cfg.param_dtype), device=device,
    )

    t0 = time.perf_counter()
    warm = engine.warmup()
    warm_s = time.perf_counter() - t0

    rng = np.random.RandomState(args.seed)
    classes = sorted(policies)
    trace = build_trace(rng, args.requests, args.max_prompt, args.gen, classes)

    # replay against the virtual clock: submit everything due, then step
    t0 = time.perf_counter()
    pending = list(trace)
    n_steps = 0
    while pending or engine.queue or engine.kv.owner:
        while pending and pending[0][0] <= engine.clock:
            _, prompt, max_new, cls = pending.pop(0)
            # the trace draws ids below 256; a smaller (smoke) vocab takes
            # the ids past its end as its last id, as XLA's gather clamps them
            engine.submit(np.minimum(prompt, cfg.vocab - 1), max_new=max_new, cls=cls)
        engine.step()
        n_steps += 1
        if n_steps > 100_000:
            raise RuntimeError("load run did not drain")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall_s = time.perf_counter() - t0

    reqs = list(engine.requests.values())
    misses = engine.cold_misses()
    rows = engine.class_dispatch_rows()
    per_class = {}
    for cls in classes:
        cls_reqs = [r for r in reqs if r.cls == cls]
        # token_lat[0] is the prefill (first token); the rest are decode steps
        lats = [t for r in cls_reqs for t in r.token_lat[1:]]
        per_class[cls] = {
            "policy": repr(policies[cls]),
            "requests": len(cls_reqs),
            "tokens": sum(len(r.generated) for r in cls_reqs),
            "p50_ms": _percentile_ms(lats, 50),
            "p99_ms": _percentile_ms(lats, 99),
            "mean_ms": (statistics.fmean(lats) * 1e3) if lats else None,
            "dispatch": rows[cls],
        }

    n_tok = sum(len(r.generated) for r in reqs)
    return {
        "schema_version": SCHEMA_VERSION,
        "mode": "quick" if args.quick else "full",
        "arch": cfg.name,
        "backend": "gpu" if device.type == "cuda" else device.type,
        **device_label(device),
        "dtype": cfg.param_dtype,
        "seed": args.seed,
        "n_slots": args.slots,
        "max_seq": args.max_seq,
        "buckets": {
            "decode_batches": list(engine.buckets.decode_batches),
            "len_step": engine.buckets.len_step,
            "prefill_lens": list(engine.buckets.prefill_lens),
        },
        "trace": {
            "requests": args.requests,
            "max_prompt": args.max_prompt,
            "max_gen": args.gen,
            "classes": classes,
        },
        "warmup": {"shapes_traced": warm["shapes_run"], "wall_s": round(warm_s, 3)},
        "cold_misses_after_warmup": misses,
        "health": engine.health(),
        "measurement": {cls: _measurement(policies[cls]) for cls in classes},
        "totals": {
            "tokens": n_tok,
            "engine_steps": n_steps,
            "wall_s": round(wall_s, 3),
            "tokens_per_s": round(n_tok / max(wall_s, 1e-9), 2),
        },
        "classes": per_class,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--full", action="store_true",
                    help="the architecture's full config (default: its smoke config)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--quick", action="store_true",
                    help="small trace for CI (fewer requests, shorter gens)")
    ap.add_argument("--requests", type=int, default=None)
    ap.add_argument("--max-prompt", type=int, default=None)
    ap.add_argument("--gen", type=int, default=None)
    ap.add_argument("--slots", type=int, default=None)
    ap.add_argument("--max-seq", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--interactive-policy", default="autotune")
    ap.add_argument("--bulk-policy", default="analytic")
    ap.add_argument("--out", default=None, help="write the report as json")
    args = ap.parse_args(argv)

    defaults = (
        dict(requests=8, max_prompt=24, gen=8, slots=4, max_seq=48)
        if args.quick
        else dict(requests=32, max_prompt=48, gen=24, slots=8, max_seq=96)
    )
    for k, v in defaults.items():
        if getattr(args, k) is None:
            setattr(args, k, v)

    report = run_load(args)
    print(json.dumps(report, indent=2))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(report, fh, indent=2)
            fh.write("\n")
        print(f"[serve_load] wrote {args.out}")

    misses = report["cold_misses_after_warmup"]
    if any(misses.values()):
        print(f"[serve_load] FAIL: post-warmup cold misses {misses}")
        return 1
    quarantined = [f"{e.label()}/{e.op}" for e in faults.quarantine_entries()]
    if quarantined or faults.fallback_counts():
        print(f"[serve_load] FAIL: dispatch fell back {faults.fallback_counts()}, "
              f"quarantined {quarantined}")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
