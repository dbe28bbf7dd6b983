"""Tile-config sweep over the port's kernel family, checked against f64.

The grid spans the op space: the forward NT family (the direct NT kernel,
the paper's TNN of the transpose and NN kernels, the fused TNN kernel),
the backward NN and TN, the batched BNT/BNN attention contractions, and
the attention plan cells (the fused kernel against the unfused
BNT + softmax + BNN pair) under a causal, optionally windowed mask.  For
every (op, g, shape, candidate, config) cell -- each candidate's own plan
and its shortlisted tile configs (``Candidate.config_space``) -- this
benchmark:

  * checks the output against an f64 reference of the same inputs (a
    mismatch fails the run: a tile config must never change the function);
  * records the median microseconds of the call (CUDA events on the card,
    the host clock on the CPU), the profiler's device microseconds (the
    card only), the H100 datasheet bound of the shape's bytes and
    operations, and the library call's device microseconds (torch.matmul,
    torch.bmm or scaled_dot_product_attention); and, beside the profiler's,
    the device time of calls queued back to back behind a sleep kernel
    (``bench_fn(queued=True)``), which needs no profiler.

  PYTHONPATH=src python -m repro_torch.benchmarks.kernel_sweep --quick
  PYTHONPATH=src python -m repro_torch.benchmarks.kernel_sweep --quick --device cpu

``--json PATH`` writes the results (default ``build/bench/kernel_sweep.json``).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import get_candidate
from repro_torch.core.engine import dispatch_attention, policy_from_spec
from repro_torch.core.hardware import device_spec
from repro_torch.core.measure import bench_fn, operand_shapes
from repro_torch.kernels.tiling import config_key

from .common import bound_us, device_label, device_us

__all__ = ["sweep", "main", "FAMILY_BY_OP", "QUICK_SHAPES", "FULL_SHAPES"]

FAMILY_BY_OP = {
    "NT": ("PALLAS_NT", "PALLAS_TNN", "PALLAS_TNN_FUSED"),
    "NN": ("PALLAS_NN",),
    "TN": ("PALLAS_TN",),
    "BNT": ("PALLAS_BNT",),
    "BNN": ("PALLAS_BNN",),
    "ATTN": ("FUSED_ATTN", "UNFUSED_ATTN"),
}

# The JAX package's cells (benchmarks/kernel_sweep.py): ragged and aligned
# shapes, the full grid a superset of the quick one.
QUICK_SHAPES = ((128, 128, 128), (1, 256, 200), (129, 257, 384))
FULL_SHAPES = QUICK_SHAPES + ((256, 256, 256), (512, 512, 512), (1, 1000, 1000),
                              (129, 1000, 1000), (127, 129, 1000), (1000, 127, 129),
                              (1000, 1000, 1000))
QUICK_BATCHED = ((2, 64, 65, 32), (3, 1, 128, 64))
FULL_BATCHED = QUICK_BATCHED + ((3, 128, 128, 64), (8, 1, 256, 64), (4, 129, 127, 64))
# (g, m, n, head dim, window): a causal chunk at the end of its kv slab
QUICK_ATTN = ((1, 256, 8192, 64, 256), (2, 64, 65, 32, 0), (4, 1, 256, 64, 0))
FULL_ATTN = QUICK_ATTN + ((1, 512, 8192, 128, 512), (1, 512, 4096, 64, 512),
                          (2, 129, 257, 64, 0))

DEFAULT_JSON = os.path.join("build", "bench", "kernel_sweep.json")


def _cells(shapes, batched, attn):
    cells = [(op, 1, m, n, k, 0) for m, n, k in shapes for op in ("NT", "NN", "TN")]
    cells += [(op, g, m, n, k, 0) for g, m, n, k in batched for op in ("BNT", "BNN")]
    cells += [("ATTN", g, m, n, k, w) for g, m, n, k, w in attn]
    return cells


def _visible(m, n, window):
    q_pos = (n - m) + np.arange(m)[:, None]
    k_pos = np.arange(n)[None, :]
    vis = k_pos <= q_pos
    if window:
        vis &= k_pos > q_pos - window
    return vis


def _reference(op, operands, window=0):
    """The f64 result of one cell, from its operands."""
    x = [t.detach().double().cpu().numpy() for t in operands]
    if op == "NT":
        return x[0] @ x[1].T
    if op == "NN":
        return x[0] @ x[1]
    if op == "TN":
        return x[0].T @ x[1]
    if op == "BNT":
        return x[0] @ np.swapaxes(x[1], 1, 2)
    if op == "BNN":
        return x[0] @ x[1]
    s = np.einsum("gmd,gnd->gmn", x[0], x[1])
    s = np.where(_visible(s.shape[1], s.shape[2], window)[None], s, -1e30)
    p = np.exp(s - s.max(axis=-1, keepdims=True))
    p /= p.sum(axis=-1, keepdims=True)
    return np.einsum("gmn,gnd->gmd", p, x[2])


def _library(op, operands, window=0):
    """One PyTorch call computing the cell's function (cuBLAS, or SDPA)."""
    a = operands
    if op == "NT":
        return lambda: torch.matmul(a[0], a[1].t())
    if op == "NN":
        return lambda: torch.matmul(a[0], a[1])
    if op == "TN":
        return lambda: torch.matmul(a[0].t(), a[1])
    if op == "BNT":
        return lambda: torch.bmm(a[0], a[1].transpose(1, 2))
    if op == "BNN":
        return lambda: torch.bmm(a[0], a[1])
    g, m, _ = a[0].shape
    vis = torch.from_numpy(_visible(m, a[1].shape[1], window)).to(a[0].device)
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        a[0], a[1], a[2], attn_mask=vis, scale=1.0)


def _fn(op, name, cfg, window, n, m):
    if op != "ATTN":
        cand = get_candidate(name)
        return lambda *x: cand.run(*x, config=cfg)
    arm = "fused" if name == "FUSED_ATTN" else "unfused"
    sfx = "" if cfg is None else f"@{config_key(cfg)}"
    pol = policy_from_spec(f"fixed:attn={arm}{sfx},bnt=XLA_BNT,bnn=XLA_BNN")
    return lambda q, k, v: dispatch_attention(q, k, v, causal=True, window=window,
                                              q_start=n - m, policy=pol)


def _median_us(fn, operands, reps, on_card):
    fn(*operands)
    ts = []
    for _ in range(reps):
        if on_card:
            torch.cuda.synchronize()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            fn(*operands)
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end) * 1e3)
        else:
            t0 = time.perf_counter()
            fn(*operands)
            ts.append((time.perf_counter() - t0) * 1e6)
    return statistics.median(ts)


def sweep(shapes=FULL_SHAPES, batched=FULL_BATCHED, attn=FULL_ATTN,
          dtypes: Sequence[str] = ("float32", "bfloat16"), max_tile_configs: int = 6,
          reps: int = 5, device="cuda", verbose: bool = True) -> Dict:
    """Check and time the (dtype x op x g x shape x candidate x config)
    grid; raises ``AssertionError`` on the first mismatch against f64."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    hw = device_spec(dev)
    rows: List[Dict] = []
    for dtype in dtypes:
        dt = getattr(torch, dtype)
        dsize = torch.finfo(dt).bits // 8
        tol = 1e-4 if dsize == 4 else 1e-2
        gen = torch.Generator(device=dev).manual_seed(0)
        for op, g, m, n, k, w in _cells(shapes, batched, attn):
            operands = tuple(
                (torch.randn(s, generator=gen, device=dev) * (0.3 if op == "ATTN" else 1.0)).to(dt)
                for s in operand_shapes(op, m, n, k, g))
            want = _reference(op, operands, w)
            scale = max(1.0, float(np.abs(want).max()))
            if op == "ATTN":
                vis = int(_visible(m, n, w).sum())
                b_us, b_by = bound_us(g * (2 * m * k + 2 * n * k) * dsize, 4.0 * g * k * vis, dsize)
            else:
                b_us, b_by = bound_us(g * (m * k + n * k + m * n) * dsize, 2.0 * g * m * n * k,
                                      dsize)
            lib_us = device_us(_library(op, operands, w)) if on_card else None
            for name in FAMILY_BY_OP[op]:
                cand = get_candidate(name)
                configs = [None] + list(cand.config_space(m, n, k, dsize,
                                                          max_configs=max_tile_configs,
                                                          hardware=hw, g=g))
                for cfg in configs:
                    fn = _fn(op, name, cfg, w, n, m)
                    got = fn(*operands).double().cpu().numpy()
                    err = float(np.max(np.abs(got - want))) / scale if got.size else 0.0
                    assert err < tol, (f"mismatch: {dtype} {op}:{name}@{config_key(cfg)} on "
                                       f"(g={g}, {m}, {n}, {k}): rel-err {err:.2e} >= {tol}")
                    dev_us = device_us(lambda: fn(*operands)) if on_card else None
                    q_us = (bench_fn(fn, *operands, reps=reps, queued=True) * 1e6
                            if on_card else None)
                    rows.append({
                        "dtype": dtype, "op": op, "g": g, "m": m, "n": n, "k": k,
                        **({"window": w} if op == "ATTN" else {}),
                        "candidate": name, "config": config_key(cfg), "rel_err": err,
                        "median_us": _median_us(fn, operands, reps, on_card),
                        "device_us": dev_us, "queued_us": q_us, "bound_us": b_us,
                        "bound_by": b_by,
                        "library_device_us": lib_us,
                    })
            if verbose:
                cell = [r for r in rows if (r["dtype"], r["op"], r["g"], r["m"], r["n"], r["k"])
                        == (dtype, op, g, m, n, k)]
                best = min(cell, key=lambda r: r["device_us"] if on_card else r["median_us"])
                t = best["device_us"] if on_card else best["median_us"]
                print(f"  {dtype:<8s} {op:<4s} g={g} ({m:>4d},{n:>5d},{k:>4d})  {len(cell):2d} "
                      f"cells ok, best {best['candidate']}@{best['config']} {t:.1f} us "
                      f"({'device' if on_card else 'host'}; bound {b_us:.2f} us)")
    return {"rows": rows, "dtypes": list(dtypes), "hardware": hw.name,
            "timing": "CUDA events and profiler device time" if on_card else
            "host clock (no device time on the CPU)", **device_label(dev)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--quick", action="store_true", help="the small grid")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="float32,bfloat16", help="comma-separated dtypes")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--max-configs", type=int, default=6)
    ap.add_argument("--json", nargs="?", const=DEFAULT_JSON, default=None, metavar="PATH",
                    help=f"write the results (default path {DEFAULT_JSON})")
    args = ap.parse_args(argv)
    quick = args.quick
    payload = sweep(shapes=QUICK_SHAPES if quick else FULL_SHAPES,
                    batched=QUICK_BATCHED if quick else FULL_BATCHED,
                    attn=QUICK_ATTN if quick else FULL_ATTN,
                    dtypes=tuple(args.dtype.split(",")), max_tile_configs=args.max_configs,
                    reps=args.reps, device=args.device)
    print(f"  {len(payload['rows'])} (dtype, op, shape, candidate, config) cells, no mismatch "
          f"against f64 on {payload['name']}")
    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w") as fh:
            json.dump(payload, fh, indent=1)
        print(f"  wrote {args.json}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
