"""Beyond-paper benchmarks on the card.

1. k-way regression selector over the port's five NT candidates (cuBLAS
   NT, torch's materialised TNN, the direct NT kernel, the paper's TNN of
   the transpose and NN kernels, the fused TNN kernel) against the paper's
   binary classifier and the oracle, on the measured dataset.
2. The kernels' tile sweep: per config of the NN and fused-TNN kernels'
   spaces (``kernels/tiling.py``) at three shapes, the instance's shared
   memory, its arithmetic intensity, the roofline's time
   (``simulate.gemm_plan_time``) and the measured time -- device time on
   the card, the plain version's host time on the CPU (labelled).

  PYTHONPATH=src python -m repro_torch.benchmarks.run --only kway,blocksweep
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.hardware import H100
from repro_torch.core.measure import bench_fn
from repro_torch.core.simulate import gemm_plan_time
from repro_torch.core.train_model import train_kway_model, train_paper_model
from repro_torch.kernels import ops, tiling

from .common import card_cache, device_label, op_dataset, save_json, section

__all__ = ["kway_selector", "kernel_block_sweep", "NT_CANDIDATES", "SWEEP_SHAPES"]

NT_CANDIDATES = ("XLA_NT", "XLA_TNN", "PALLAS_NT", "PALLAS_TNN", "PALLAS_TNN_FUSED")


def kway_selector(full: bool = False, device="cuda", dtype: str = "float32",
                  cache: Optional[str] = None, hi: Optional[int] = None):
    section("Beyond-paper -- k-way selector over the 5 NT candidates vs binary vs oracle")
    dev = resolve_device(device)
    ds = op_dataset(card_cache(dtype, dev, full, hi, cache), "NT", dtype)
    algos = [c for c in NT_CANDIDATES if c in ds.times]
    kway, krep = train_kway_model(ds, candidates=algos)
    clf, _ = train_paper_model(ds)
    t_all = np.stack([ds.times[c] for c in algos], axis=1)
    t_oracle = t_all.min(axis=1)
    pred = clf.predict(ds.X)
    t_binary = np.where(pred == 1, ds.times["NT"], ds.times["TNN"])
    t_kway = t_all[np.arange(len(ds)), kway.select(ds.X)]
    t_lib = ds.times["XLA_NT"]
    rows = {
        "always_xla_nt": float((t_lib / t_oracle).mean()),  # cuBLAS, the library arm
        "paper_binary_mtnn": float((t_binary / t_oracle).mean()),
        "kway_regressor": float((t_kway / t_oracle).mean()),
        "oracle": 1.0,
    }
    print(f"  {'policy':<20s} {'mean slowdown vs oracle':>24s}")
    for k, v in rows.items():
        print(f"  {k:<20s} {v:24.3f}x")
    fastest = {c: float((t_all.argmin(axis=1) == i).mean()) for i, c in enumerate(algos)}
    print(f"  k-way oracle-match {krep['oracle_match'] * 100:.1f}%; mean speedup vs "
          f"always-cuBLAS {float((t_lib / t_kway).mean()):.3f}x; fastest share {fastest}")
    out = {"rows": rows, "kway_report": krep, "speedup_vs_xla": float((t_lib / t_kway).mean()),
           "fastest_share": fastest, "source": "measured", "dtype": dtype, **device_label(dev)}
    save_json(f"beyond_kway_{dtype}", out)
    return out


# (kernel, (m, n, k)) cells of the sweep: the JAX package's three shapes, on
# the two kernels whose spaces have the most plans.
SWEEP_SHAPES: Tuple[Tuple[int, int, int], ...] = ((4096, 4096, 4096), (8192, 1024, 8192),
                                                   (1024, 65536, 512))


def kernel_block_sweep(full: bool = False, device="cuda", dtype: str = "bfloat16",
                       cache: Optional[str] = None, hi: Optional[int] = None,
                       shapes: Sequence[Tuple[int, int, int]] = SWEEP_SHAPES, reps: int = 5):
    section("Beyond-paper -- the kernels' tile sweep (shared memory + roofline + measured)")
    dev = resolve_device(device)
    dt = getattr(torch, dtype)
    dsize = torch.finfo(dt).bits // 8
    on_card = dev.type == "cuda"
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    print(f"  {'kernel':<17s} {'(m,n,k)':<20s} {'config':<14s} {'smem KiB':>8s} "
          f"{'AI':>7s} {'model ms':>9s} {'meas. ms':>9s}")
    for kernel in ("matmul_nn", "matmul_tnn_fused"):
        for m, n, k in shapes:
            a = torch.randn((m, k), generator=gen, device=dev).to(dt)
            b = torch.randn((k, n) if kernel == "matmul_nn" else (n, k), generator=gen,
                            device=dev).to(dt)
            fn = ops.matmul_nn if kernel == "matmul_nn" else ops.matmul_tnn_fused
            dflt = tiling.default_config(kernel, m, n, k, dsize)
            best = None
            for cfg, plan in sorted(tiling.tile_plans(kernel, m, n, k, dsize)):
                splits = plan[2]
                nbytes = dsize * (m * k * -(-n // cfg[1]) + n * k * -(-m // cfg[0]) + m * n)
                t_model = gemm_plan_time(H100, m, n, k, dsize, cfg[:2], splits=splits) * 1e3
                t_meas = bench_fn(lambda x, y, _c=cfg: fn(x, y, block=_c), a, b, reps=reps,
                                  queued=on_card) * 1e3
                row = {"kernel": kernel, "shape": (m, n, k), "block": cfg,
                       "smem_kib": tiling.wgmma_smem_bytes(cfg[1]) / 1024,
                       "ai": 2.0 * m * n * k / nbytes, "t_model_ms": t_model,
                       "t_measured_ms": t_meas, "default": cfg == dflt}
                rows.append(row)
                if best is None or t_meas < best["t_measured_ms"]:
                    best = row
                print(f"  {kernel:<17s} {str((m, n, k)):<20s} {tiling.config_key(cfg):<14s} "
                      f"{row['smem_kib']:8.1f} {row['ai']:7.1f} {t_model:9.3f} {t_meas:9.3f}"
                      f"{'  <- default' if row['default'] else ''}")
            print(f"    -> fastest measured for {(m, n, k)}: {tiling.config_key(best['block'])}"
                  f" ({best['t_measured_ms']:.3f} ms; default {tiling.config_key(dflt)})")
    out = {"rows": rows, "dtype": dtype, "source": "measured and analytic",
           "measured": "device time (queued CUDA events)" if on_card
           else "the plain version's host time on the CPU", **device_label(dev)}
    save_json("kernel_block_sweep", out)
    return out
