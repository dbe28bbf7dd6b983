"""Paper §VI-C / Table X / Figs. 7-8 -- FCN training with MTNN, on the card.

CaffeNT   = every layer forced through cuBLAS NT (``fixed:XLA_NT``).
CaffeMTNN = every layer dispatched by a ``ModelPolicy`` over a GBDT
            trained on this device's own measurements (NT, NN and TN
            records over the paper grid, the NT pair cuBLAS NT against
            the paper's TNN: the transpose kernel then the NN kernel).

Forward and backward ms per FCN and batch, at the paper's published
widths (no width cut), in f32 (the paper's and Caffe's dtype) by default:

  PYTHONPATH=src python -m repro_torch.benchmarks.table10_fcn
  PYTHONPATH=src python -m repro_torch.benchmarks.table10_fcn --full

``--full`` measures the paper's whole grid {2^7..2^16}^3 (the OOM guard
skips what does not fit) and the paper's six batch sizes; the default
grid is {2^7..2^12}^3 with batches 256 and 1024.  Results go to
``build/bench/table10.json``.
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.fcn_paper import MNIST_BATCHES, MNIST_FCNS, SYNTHETIC_FCNS
from repro_torch.core import (
    FixedPolicy,
    ModelPolicy,
    MTNNSelector,
    bench_fn,
    device_spec,
    train_paper_model,
    use_policy,
)
from repro_torch.models.fcn import FCNConfig, fcn_forward, fcn_loss_and_grads, init_fcn

from .common import CARD_PAIR, device_label, measured_dataset, save_json, section

__all__ = ["bench_phase", "table10", "main"]

NETS = {c.name: c for c in (MNIST_FCNS[2], MNIST_FCNS[3], SYNTHETIC_FCNS[2], SYNTHETIC_FCNS[3])}


def bench_phase(cfg: FCNConfig, batch_size: int, policy, device, dtype=torch.float32,
                reps: int = 5, seed: int = 0):
    """(forward, backward) seconds of one minibatch of ``cfg`` under
    ``policy``: the best of ``reps`` timed forwards, and the best of
    ``reps`` forward+backward runs less the forward."""
    dev = resolve_device(device)
    params = init_fcn(seed, cfg, dtype, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((batch_size, cfg.input_dim), generator=gen, device=dev, dtype=dtype)
    labels = torch.randint(0, cfg.output_dim, (batch_size,), generator=gen, device=dev)
    batch = {"x": x, "labels": labels}

    def fwd(x):
        with torch.no_grad(), use_policy(policy):
            return fcn_forward(params, x)

    t_f = bench_fn(fwd, x, reps=reps, warmup=1, stat="min")
    t_fb = bench_fn(lambda x: fcn_loss_and_grads(params, batch, policy), x,
                    reps=reps, warmup=1, stat="min")
    return t_f, max(t_fb - t_f, 0.0)


def table10(full: bool = False, device="cuda", dtype: str = "float32",
            nets: Optional[Dict[str, FCNConfig]] = None,
            batches: Optional[Sequence[int]] = None, grid_hi: Optional[int] = None):
    dev = resolve_device(device)
    section("Table X / Figs.7-8 -- FCN training: CaffeNT vs CaffeMTNN (measured)")
    hw = device_spec(dev)
    ds, _ = measured_dataset(full, dtype, dev, hi=grid_hi)
    clf, rep = train_paper_model(ds)
    mtnn = ModelPolicy(MTNNSelector(clf, hardware=hw, binary_pair=CARD_PAIR))
    nt = FixedPolicy("XLA_NT")  # the CaffeNT arm
    print(f"  selector: {len(ds)} records on {hw.name}, classes {ds.class_counts()}, "
          f"in-sample accuracy {rep['full_data_accuracy']['total']:.3f}")

    dt = getattr(torch, dtype)
    out: Dict[str, Dict] = {"_device": device_label(dev)}
    batches = batches or (MNIST_BATCHES if full else (256, 1024))
    print(f"  {'net':<13s} {'batch':>6s} {'fwd NT':>9s} {'fwd MTNN':>9s} "
          f"{'bwd NT':>9s} {'bwd MTNN':>9s} {'fwd speedup':>11s}")
    for name, cfg in (nets or NETS).items():
        for bs in batches:
            fn, bn = bench_phase(cfg, bs, nt, dev, dt)
            fm, bm = bench_phase(cfg, bs, mtnn, dev, dt)
            sp = fn / max(fm, 1e-12)
            out[f"{name}@{bs}"] = {
                "fwd_nt_ms": fn * 1e3, "fwd_mtnn_ms": fm * 1e3,
                "bwd_nt_ms": bn * 1e3, "bwd_mtnn_ms": bm * 1e3,
                "fwd_speedup": sp,
            }
            print(f"  {name:<13s} {bs:6d} {fn*1e3:9.3f} {fm*1e3:9.3f} "
                  f"{bn*1e3:9.3f} {bm*1e3:9.3f} {sp:10.3f}x")
    rows = [v for k, v in out.items() if not k.startswith("_")]
    tot_nt = sum(v["fwd_nt_ms"] + v["bwd_nt_ms"] for v in rows)
    tot_mt = sum(v["fwd_mtnn_ms"] + v["bwd_mtnn_ms"] for v in rows)
    out["_summary"] = {
        "mean_fwd_speedup": float(np.mean([v["fwd_speedup"] for v in rows])),
        "total_ratio": tot_nt / max(tot_mt, 1e-12),
        "selector_decisions": {op: dict(v) for op, v in mtnn.stats.by_op.items()},
        "class_counts": ds.class_counts(),
        "dtype": dtype,
    }
    print(f"  mean fwd speedup {out['_summary']['mean_fwd_speedup']:.3f}x; total time "
          f"ratio NT/MTNN {out['_summary']['total_ratio']:.3f}x")
    save_json("table10", out)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--full", action="store_true",
                    help="the paper's whole grid {2^7..2^16}^3 and six batch sizes")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32")
    args = ap.parse_args(argv)
    return table10(full=args.full, device=args.device, dtype=args.dtype)


if __name__ == "__main__":
    main()
