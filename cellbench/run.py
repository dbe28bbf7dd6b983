"""Run one cell of ``BENCHMARK.json`` on this machine's card(s):

  python3 -m cellbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1`` a
``breakdown``, and last ``checks``: each number ``correct`` was decided
from beside its limit, which also end standard error.  Exits non-zero,
printing no result, without a CUDA card, with fewer cards than the cell
asks for, or when JAX or the JAX package was loaded into the process.
"""

from __future__ import annotations

import argparse
import json
import math
import sys

from cellbench import harness

T_START = harness.process_start()


def _args(argv):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _fail(msg: str, code: int) -> int:
    print(f"cellbench: {msg}", file=sys.stderr, flush=True)
    return code


def main(argv=None) -> int:
    args = _args(argv)
    harness.prepare_environment()
    try:
        found = harness.load_cell(args.workload)
    except (OSError, KeyError, ValueError) as e:
        return _fail(f"cannot load the cell: {e}", 2)
    import torch

    chips = int(found["cell"]["chips"])
    if not torch.cuda.is_available():
        return _fail("no CUDA card: this benchmark measures the card", 3)
    if torch.cuda.device_count() < chips:
        return _fail(f"the cell needs {chips} card(s); {torch.cuda.device_count()} present", 3)
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        return _fail(f"the system under test is not in this checkout: {e}", 3)

    from cellbench.trace import Tracer

    tracer = Tracer(bool(args.trace))
    ctx = harness.Context(seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                          device=torch.device("cuda", 0), t_start=T_START, tracer=tracer,
                          **found)
    ctx.note("imports")
    outcome = harness.driver_module(ctx.mix).run(ctx)
    bad = harness.forbidden_loaded()
    if bad:
        return _fail(f"JAX or the JAX package was loaded: {', '.join(bad)}", 4)
    print(json.dumps(result(ctx, outcome, torch.cuda.get_device_name(0))), flush=True)
    return 0


def _finite(x: float):
    return x if math.isfinite(x) else None


def result(ctx, outcome, kind: str, root=harness.ROOT) -> dict:
    """The result line of a finished run on a card named ``kind``."""
    from cellbench.checks import judge

    ok, checks = judge(outcome.numbers, ctx.limits)
    ok = ok and outcome.failed == 0
    device = {"platform": "gpu", "kind": kind,
              "count": int(ctx.cell["chips"]), "memory_peak_bytes": int(outcome.memory_peak_bytes)}
    out = {"correct": bool(ok), "attempted": int(outcome.attempted),
           "failed": int(outcome.failed)}
    if ctx.trace:
        data = ctx.tracer.data
        out["metrics"] = harness.read_per_layer(ctx, outcome, data, root)
        device["busy_s"] = data.busy_s
        device["window_s"] = data.window_s
        out["device"] = device
        out["breakdown"] = {"device_ops": data.device_ops, "idle_gaps": data.idle_gaps}
    else:
        values = dict(outcome.e2e, setup_s=ctx.setup_s)
        out["metrics"] = {m["name"]: {"value": float(values[m["name"]]), "unit": m["unit"]}
                          for m in harness.cell_metrics(ctx.spec, ctx.cell["name"], "end_to_end")}
        out["device"] = device
    out["checks"] = {name: {"value": _finite(value), "limit": _finite(limit)}
                     for name, value, limit in checks}
    for name, value, limit in checks:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    return out


if __name__ == "__main__":
    sys.exit(main())
