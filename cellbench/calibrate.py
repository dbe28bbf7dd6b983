"""The readings the limits of ``correct`` are set from, on the card:

  python3 -m cellbench.calibrate --workload <cell> --seeds 1,2,... \
      [--control-seeds 1,2,3] [--seconds S]

For each seed, one run of the cell's driver in this process (set-up, a
window of ``--seconds``, 0 for a training cell, whose readings need
none, and the reference), printing the program's numbers; on a control
seed also the control's: the reference computed in the precision below
the configuration's (``tf32`` for float32, ``fp8`` for bfloat16), put
in the program's place.  One JSON line per seed, then the largest
program reading and the smallest control reading of each number.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from cellbench import harness

CONTROL = {"float32": "tf32", "bfloat16": "fp8"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--control", default=None,
                    help="the control: a precision (tf32, fp8) or a planted fault (half_batch); "
                         "default the precision below the configuration's")
    args = ap.parse_args(argv)
    harness.prepare_environment()
    import torch

    from cellbench.trace import Tracer

    found = harness.load_cell(args.workload)
    control = args.control or CONTROL[found["cfg"]["torch_dtype"]]
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    driver = harness.driver_module(found["mix"])
    high, low = {}, {}
    for seed in sorted(set(seeds) | controls):
        ctx = harness.Context(seed=seed, seconds=args.seconds, trace=False,
                              device=torch.device("cuda", 0), t_start=time.perf_counter(),
                              tracer=Tracer(False), control=control if seed in controls else None,
                              **found)
        out = driver.run(ctx)
        line = {"seed": seed, "numbers": out.numbers, "failed": out.failed,
                "e2e": out.e2e}
        if seed in seeds:
            for k, v in out.numbers.items():
                high[k] = max(high.get(k, v), v)
        if ctx.control:
            line["control"] = {control: out.control_numbers}
            for k, v in out.control_numbers.items():
                low[k] = min(low.get(k, v), v)
        print(json.dumps(line), flush=True)
    print(json.dumps({"program_max": high, "control_min": low, "control": control}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
