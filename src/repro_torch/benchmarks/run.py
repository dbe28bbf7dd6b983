"""Benchmark harness of the port -- one benchmark per paper table and
figure, and the beyond-paper ones, on the card unless told otherwise:

  PYTHONPATH=src python -m repro_torch.benchmarks.run                 # default grids
  PYTHONPATH=src python -m repro_torch.benchmarks.run --full          # paper-scale grids
  PYTHONPATH=src python -m repro_torch.benchmarks.run --only fig2,table4 \\
      --cache build/measured_f32.json                                # reuse a measured grid
  PYTHONPATH=src python -m repro_torch.benchmarks.run --device cpu --only fig2,table4 --grid-hi 8

The paper benchmarks share one measured grid per run (``--cache`` reads it
from a file when the file exists, and saves it there otherwise).  Results
are printed and written under ``build/bench/``.  The kernel sweep has its
own entry point, ``python -m repro_torch.benchmarks.kernel_sweep``.
"""

from __future__ import annotations

import argparse
import time
import traceback

from . import beyond_paper, paper_figures, paper_tables, policy_overhead, table10_fcn

BENCHES = {
    "fig1": paper_figures.fig1_nn_vs_nt,
    "fig2": paper_figures.fig2_winner_map,
    "fig3": paper_figures.fig3_tnn_vs_nt,
    "table4": paper_tables.table4_cv,
    "table6": paper_tables.table6_classifiers,
    "fig4": paper_tables.fig4_train_size,
    "table8": paper_tables.table8_selection,
    "table10": lambda full, device, dtype, cache, hi: table10_fcn.table10(
        full=full, device=device, dtype=dtype, grid_hi=hi),
    "kway": beyond_paper.kway_selector,
    "policy_overhead": policy_overhead.policy_overhead,
    "blocksweep": lambda full, device, dtype, cache, hi: beyond_paper.kernel_block_sweep(
        full=full, device=device),
}


def run_benches(names, **kw):
    """Run the named benchmarks with the keyword arguments every one takes
    (``full``, ``device``, ``dtype``, ``cache``, ``hi``); returns their
    results and the names that failed (each failure printed)."""
    failures, results = [], {}
    t_start = time.time()
    for name in names:
        t0 = time.time()
        try:
            results[name] = BENCHES[name](**kw)
            print(f"[{name}] done in {time.time() - t0:.1f}s")
        except Exception as e:  # report every benchmark, then fail the run
            failures.append(name)
            print(f"[{name}] FAILED: {type(e).__name__}: {e}")
            traceback.print_exc()
    print(f"\n== benchmarks: {len(names) - len(failures)}/{len(names)} ok "
          f"in {time.time() - t_start:.0f}s ==")
    return results, failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--full", action="store_true", help="paper-scale grids")
    ap.add_argument("--only", default=None, help=f"comma-separated subset of {list(BENCHES)}")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"),
                    help="dtype of the measured grid (the paper's is f32)")
    ap.add_argument("--cache", default=None,
                    help="measurement cache of the grid: read if it exists, else filled")
    ap.add_argument("--grid-hi", type=int, default=None,
                    help="measure {2^7..2^HI}^3 (default 12; 16 with --full)")
    args = ap.parse_args(argv)

    names = list(BENCHES) if not args.only else args.only.split(",")
    unknown = [n for n in names if n not in BENCHES]
    if unknown:
        ap.error(f"unknown benchmarks {unknown}; have {list(BENCHES)}")
    _, failures = run_benches(names, full=args.full, device=args.device, dtype=args.dtype,
                              cache=args.cache, hi=args.grid_hi)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
