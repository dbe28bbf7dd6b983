"""Beyond-paper -- the dispatch policy's cost per call, on the card.

The paper reports 0.005 ms of predictor overhead *per matmul call*
(its selector runs in the hot loop).  The JAX package selects once per
shape at trace time; the port dispatches eagerly, so its policy runs on
every call (memoised per ``OpKey``) with no trace to hide it behind --
the paper's own question.  This benchmark measures:

  1. ``policy.select`` latency per call, cold (first sight of each shape)
     and warm, for the port's policy zoo, per op for the analytic policy,
     and the autotune policy measuring on the device and from its file;
  2. a dense layer, ``dispatch("NT", x, W)`` with x (256, 1024) and W
     (1024, 1024) in f32, under the learned policy against a fixed policy
     naming the same candidate: host wall ms per call (synchronised) and
     device ms (calls queued back to back behind a sleep kernel).

  PYTHONPATH=src python -m repro_torch.benchmarks.run --only policy_overhead
"""

from __future__ import annotations

import os
import tempfile
import time
from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.core import (
    AnalyticPolicy,
    AutotunePolicy,
    CascadePolicy,
    FixedPolicy,
    ModelPolicy,
    MTNNSelector,
    OpKey,
    collect_analytic,
    dispatch,
    train_paper_model,
    use_policy,
)
from repro_torch.core.measure import bench_fn
from repro_torch.core.opkey import BATCHED_OPS, OPS

from .common import device_label, save_json, section

__all__ = ["policy_overhead", "PAPER_MS_PER_CALL"]

PAPER_MS_PER_CALL = 0.005  # the paper's in-loop predictor, every call


def _select_latency(policy, shapes, reps: int) -> dict:
    """Per-call ``select`` latency in ms: cold (first sight of each shape)
    then warm.  The OpKey is built inside the timed loop, as the dispatch
    engine builds it."""
    t0 = time.perf_counter()
    for m, n, k in shapes:
        policy.select(OpKey("NT", m, n, k))
    cold = (time.perf_counter() - t0) / len(shapes)
    t0 = time.perf_counter()
    for _ in range(reps):
        for m, n, k in shapes:
            policy.select(OpKey("NT", m, n, k))
    warm = (time.perf_counter() - t0) / (reps * len(shapes))
    return {"cold_ms": cold * 1e3, "warm_ms": warm * 1e3}


def _dense_step(policy, x, w, iters: int) -> dict:
    """Host wall ms per synchronised call of one dispatched dense layer,
    and its device ms (calls queued back to back, ``bench_fn(queued=True)``;
    none on the CPU)."""
    def call():
        with use_policy(policy):
            return dispatch("NT", x, w)

    call()
    sync = torch.cuda.synchronize if x.device.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        call()
    sync()
    wall = (time.perf_counter() - t0) / iters * 1e3
    dev = (bench_fn(lambda _: call(), x, reps=iters, queued=True) * 1e3
           if x.device.type == "cuda" else None)
    return {"wall_ms": wall, "device_ms": dev}


def policy_overhead(full: bool = False, device="cuda", dtype: str = "float32",
                    cache: Optional[str] = None, hi: Optional[int] = None):
    section("Beyond-paper -- dispatch-time selection cost per policy (eager)")
    dev = resolve_device(device)
    clf, _ = train_paper_model(collect_analytic(lo=7, hi=12))
    zoo = {
        "FixedPolicy": FixedPolicy("XLA_NT"),
        "ModelPolicy(binary)": ModelPolicy(MTNNSelector(clf)),
        "AnalyticPolicy": AnalyticPolicy(),
        "CascadePolicy": CascadePolicy(["PALLAS_TNN_FUSED", "XLA_TNN", "XLA_NT"]),
    }
    sizes = [2**i for i in (7, 9, 11, 13)]
    shapes = [(m, n, k) for m in sizes for n in sizes for k in sizes]
    reps = 100 if full else 20
    out = {}
    print(f"  {'policy':<26s} {'cold ms/call':>13s} {'warm ms/call':>13s}")
    for name, pol in zoo.items():
        out[name] = _select_latency(pol, shapes, reps)
        print(f"  {name:<26s} {out[name]['cold_ms']:13.4f} {out[name]['warm_ms']:13.4f}")
    print(f"  (the paper's in-loop predictor: {PAPER_MS_PER_CALL} ms/call, every call)")

    pol = AnalyticPolicy()
    for op in OPS:
        keys = [OpKey(op, m, n, k, 4, 4 if op in BATCHED_OPS else 1) for m, n, k in shapes]
        for key in keys:
            pol.select(key)
        t0 = time.perf_counter()
        for _ in range(reps):
            for key in keys:
                pol.select(key)
        out[f"AnalyticPolicy[{op}]"] = {
            "warm_ms": (time.perf_counter() - t0) / (reps * len(keys)) * 1e3}
        print(f"  {'Analytic op=' + op:<26s} {'':>13s} {out[f'AnalyticPolicy[{op}]']['warm_ms']:13.4f}")
    r_entry = _select_latency(AnalyticPolicy(), shapes, reps)
    out["_key_construction_overhead_ratio"] = (
        r_entry["warm_ms"] / max(out["AnalyticPolicy[NT]"]["warm_ms"], 1e-9))
    print(f"  (OpKey construction + select) vs pre-built-key select: "
          f"{out['_key_construction_overhead_ratio']:.2f}x")

    # autotune: a cold select measures every candidate (and tile) on the
    # device; a fresh policy over the saved file measures nothing
    at_sizes = [2**i for i in (7, 8, 9)]
    at_shapes = [(m, n, k) for m in at_sizes for n in at_sizes for k in at_sizes]
    at_path = os.path.join(tempfile.mkdtemp(prefix="repro_torch_autotune_bench_"), "cache.json")
    cold_pol = AutotunePolicy(cache_path=at_path, reps=2, device=dev)
    r = _select_latency(cold_pol, at_shapes, reps)
    r["measured_shapes"] = cold_pol.n_measured
    out["AutotunePolicy(cold=measure)"] = r
    warm_pol = AutotunePolicy(cache_path=at_path, device=dev)
    r = _select_latency(warm_pol, at_shapes, reps)
    r["measured_shapes"] = warm_pol.n_measured
    if warm_pol.n_measured:
        raise RuntimeError("a policy over a warm cache file measured again")
    out["AutotunePolicy(warm-cache)"] = r
    for name in ("AutotunePolicy(cold=measure)", "AutotunePolicy(warm-cache)"):
        print(f"  {name:<26s} {out[name]['cold_ms']:13.4f} {out[name]['warm_ms']:13.4f}  "
              f"({out[name]['measured_shapes']} shapes measured)")

    gen = torch.Generator(device=dev).manual_seed(0)
    w = torch.randn((1024, 1024), generator=gen, device=dev)
    x = torch.randn((256, 1024), generator=gen, device=dev)
    model = ModelPolicy(MTNNSelector(clf))
    chosen = model.select(OpKey("NT", 256, 1024, 1024, 4))
    step = {"ModelPolicy(binary)": _dense_step(model, x, w, 200 if full else 50),
            f"FixedPolicy({chosen.label()})": _dense_step(FixedPolicy(chosen.name, chosen.config),
                                                          x, w, 200 if full else 50)}
    for name, row in step.items():
        dev_ms = "not measured" if row["device_ms"] is None else f"{row['device_ms']:.4f} ms"
        print(f"  dense layer under {name:<30s}: wall {row['wall_ms']:.4f} ms, device {dev_ms}")
    walls = [row["wall_ms"] for row in step.values()]
    out["_dense_step_ms"] = step
    out["_dense_ratio"] = walls[0] / max(walls[1], 1e-12)
    out["_paper_ms_per_call"] = PAPER_MS_PER_CALL
    out["_device"] = device_label(dev)
    print(f"  wall ratio learned/fixed: {out['_dense_ratio']:.3f}x "
          f"(1.00x: the learned policy costs nothing per call)")
    save_json("policy_overhead", out)
    return out
