"""gemma2-27b ``train_4k`` on the 16x16 mesh at three microbatch counts.

Hypothesis (the JAX package's experiment): the data-parallel gradient
collectives scale with the number of microbatches if every microbatch
reduces the whole gradient.  The port reduces once per step (each rank
accumulates its microbatches' gradients, then one reduce-scatter and one
all-gather per leaf under ZeRO-1), so its collective bytes should move
only with the tensor-parallel activations, which do not depend on the
count, while fewer, larger microbatches raise the peak memory.

For accum 16 (the dry run's one sample per microbatch), 8 and 4 this runs
rank 0's step on meta tensors (``launch/dryrun.py::lower_cell``) and
prints the fit and the three roofline terms beside the baseline record
of ``build/dryrun/`` where one is there; results go to
``build/bench/gemma2_accum_iter.json``.  Meta-tensor accounting with the
H100's datasheet peaks, not a chip measurement.

  PYTHONPATH=src python -m repro_torch.benchmarks.gemma2_accum_iter
"""

from __future__ import annotations

import argparse
import json
import os

from repro_torch.launch.dryrun import OUT_DIR, lower_cell

from .common import save_json, section

__all__ = ["main"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--accums", default="16,8,4")
    args = ap.parse_args(argv)
    section("gemma2-27b train_4k on 16x16: microbatch count (meta-tensor accounting)")
    baseline = os.path.join(OUT_DIR, "gemma2-27b_train_4k_16x16.json")
    results = {}
    if os.path.exists(baseline):
        with open(baseline) as fh:
            rec = json.load(fh)
        if rec.get("status") == "ok":
            results["baseline_record"] = {"accum": rec["accum"], "fit_gb": rec["memory"]["fit_gb"],
                                          **rec["roofline"]}
    for accum in (int(a) for a in args.accums.split(",")):
        rec = lower_cell("gemma2-27b", "train_4k", accum=accum)
        r, m = rec["roofline"], rec["memory"]
        results[accum] = {"fit_gb": m["fit_gb"], **r}
        print(f"  accum={accum:2d} fit={m['fit_gb']:6.2f} GB compute={r['t_compute_s']:.3f}s "
              f"memory={r['t_memory_s']:.3f}s collective={r['t_collective_s']:.3f}s "
              f"useful={r['useful_ratio'] * 100:.1f}%")
    save_json("gemma2_accum_iter", results)
    return results


if __name__ == "__main__":
    main()
