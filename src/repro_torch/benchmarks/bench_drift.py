"""Schema-drift guard between fresh benchmark reports and the committed pair.

``src/repro_torch/benchmarks/BENCH_kernels.json`` (``kernel_sweep --quick
--device cpu --json``) and ``BENCH_serve.json`` (``serve_load --quick
--device cpu --out``) are committed beside the benchmarks that make them,
made on the CPU so that a CPU test can hold a fresh run against them.
The two are produced by the same code at different times, so they can
silently diverge: a sweep refactor that drops a row field, an op family
or a candidate would leave the committed grid describing cells the sweep
no longer produces.  The rules are the JAX package's:

  * every row of both kernel files carries the required keys (schema);
  * every op family and every candidate in the committed grid is still
    covered by the fresh sweep (coverage cannot silently shrink);
  * for (dtype, op, g, m, n, k) cells present in *both* files, the fresh
    sweep produced at least as many rows as the committed grid (a shared
    cell cannot silently lose tile-config coverage).

  PYTHONPATH=src python -m repro_torch.benchmarks.bench_drift \\
      --fresh /tmp/BENCH_kernels.json

and for the serving-load report:

  * top-level and per-class schema keys hold in both files;
  * every request class, decode-batch bucket and prefill-length bucket
    in the committed report is still produced by the fresh run;
  * every class's fresh dispatch table routes the attention plan op
    (``ATTN`` rows) -- per-class policy scoping still reaches the
    fused-vs-unfused decision (the unfused arm's BNT/BNN sub-ops appear
    only when that arm wins, so they are not required);
  * the fresh run made zero post-warmup cold-miss measurements.

  PYTHONPATH=src python -m repro_torch.benchmarks.bench_drift \\
      --serve-fresh /tmp/BENCH_serve.json

Exits 1 on any finding, printing each.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List, Tuple

__all__ = ["check_drift", "check_serve_drift", "main", "COMMITTED_KERNELS",
           "COMMITTED_SERVE"]

HERE = os.path.dirname(os.path.abspath(__file__))
COMMITTED_KERNELS = os.path.join(HERE, "BENCH_kernels.json")
COMMITTED_SERVE = os.path.join(HERE, "BENCH_serve.json")

# the rows and the top level of kernel_sweep.sweep()'s payload
REQUIRED_ROW_KEYS = frozenset(
    {
        "dtype", "op", "g", "m", "n", "k", "candidate", "config", "rel_err",
        "median_us", "device_us", "queued_us", "bound_us", "bound_by",
        "library_device_us",
    }
)
REQUIRED_TOP_KEYS = frozenset({"rows", "dtypes", "hardware", "timing", "device", "name"})

REQUIRED_SERVE_TOP_KEYS = frozenset(
    {
        "schema_version", "mode", "arch", "backend", "n_slots", "max_seq",
        "buckets", "warmup", "cold_misses_after_warmup", "totals", "classes",
    }
)
REQUIRED_SERVE_CLASS_KEYS = frozenset(
    {"policy", "requests", "tokens", "p50_ms", "p99_ms", "dispatch"}
)
REQUIRED_SERVE_DISPATCH_OPS = ("ATTN",)  # the paired attention plan key

CellKey = Tuple[str, str, int, int, int, int]  # (dtype, op, g, m, n, k)


def _load(path: str) -> Dict:
    with open(path) as fh:
        return json.load(fh)


def _check_schema(name: str, payload: Dict, errors: List[str]) -> None:
    missing_top = REQUIRED_TOP_KEYS - set(payload)
    if missing_top:
        errors.append(f"{name}: missing top-level keys {sorted(missing_top)}")
        return
    for i, row in enumerate(payload["rows"]):
        missing = REQUIRED_ROW_KEYS - set(row)
        if missing:
            errors.append(
                f"{name}: row {i} ({row.get('op')}:{row.get('candidate')}) "
                f"missing keys {sorted(missing)}"
            )
            return  # one schema error per file is enough signal


def _by_cell(payload: Dict) -> Dict[CellKey, int]:
    counts: Dict[CellKey, int] = {}
    for row in payload["rows"]:
        ck = (row["dtype"], row["op"], row["g"], row["m"], row["n"], row["k"])
        counts[ck] = counts.get(ck, 0) + 1
    return counts


def check_drift(fresh: Dict, committed: Dict) -> List[str]:
    """All drift findings between two kernel-sweep payloads (empty ==
    clean)."""
    errors: List[str] = []
    _check_schema("fresh", fresh, errors)
    _check_schema("committed", committed, errors)
    if errors:
        return errors  # row-level checks below assume the schema holds

    fresh_ops = {r["op"] for r in fresh["rows"]}
    committed_ops = {r["op"] for r in committed["rows"]}
    if not committed_ops <= fresh_ops:
        errors.append(
            f"op families {sorted(committed_ops - fresh_ops)} are in the "
            "committed grid but missing from the fresh sweep -- the sweep "
            "code no longer covers them"
        )
    fresh_cands = {r["candidate"] for r in fresh["rows"]}
    committed_cands = {r["candidate"] for r in committed["rows"]}
    if not committed_cands <= fresh_cands:
        errors.append(
            f"candidates {sorted(committed_cands - fresh_cands)} are in the "
            "committed grid but missing from the fresh sweep"
        )

    fresh_counts = _by_cell(fresh)
    for ck, committed_count in sorted(_by_cell(committed).items()):
        fresh_count = fresh_counts.get(ck)
        if fresh_count is not None and fresh_count < committed_count:
            dtype, op, g, m, n, k = ck
            errors.append(
                f"shared cell {dtype} {op} g={g} ({m},{n},{k}): fresh sweep has "
                f"{fresh_count} rows < committed {committed_count} -- "
                "tile-config coverage shrank"
            )
    return errors


def _check_serve_schema(name: str, payload: Dict, errors: List[str]) -> None:
    missing = REQUIRED_SERVE_TOP_KEYS - set(payload)
    if missing:
        errors.append(f"{name}: missing top-level keys {sorted(missing)}")
        return
    for cls, row in payload["classes"].items():
        missing = REQUIRED_SERVE_CLASS_KEYS - set(row)
        if missing:
            errors.append(f"{name}: class {cls!r} missing keys {sorted(missing)}")
            return


def check_serve_drift(fresh: Dict, committed: Dict) -> List[str]:
    """Drift findings for the serving-load report (empty == clean)."""
    errors: List[str] = []
    _check_serve_schema("fresh", fresh, errors)
    _check_serve_schema("committed", committed, errors)
    if errors:
        return errors

    for key in ("decode_batches", "prefill_lens"):
        committed_b = set(committed["buckets"].get(key, ()))
        fresh_b = set(fresh["buckets"].get(key, ()))
        if not committed_b <= fresh_b:
            errors.append(
                f"{key} {sorted(committed_b - fresh_b)} are in the committed "
                "report but missing from the fresh run -- bucket coverage shrank"
            )

    missing_cls = set(committed["classes"]) - set(fresh["classes"])
    if missing_cls:
        errors.append(
            f"request classes {sorted(missing_cls)} are in the committed "
            "report but missing from the fresh run"
        )
    for cls, row in fresh["classes"].items():
        for op in REQUIRED_SERVE_DISPATCH_OPS:
            if not row["dispatch"].get(op):
                errors.append(
                    f"fresh class {cls!r} has no {op} dispatch rows -- the "
                    "attention plan no longer routes through its policy"
                )

    misses = fresh["cold_misses_after_warmup"]
    if any(misses.values()):
        errors.append(
            f"fresh run made post-warmup cold-miss measurements: {misses} -- "
            "the bucket warmup no longer covers the serve loop's OpKeys"
        )
    return errors


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--fresh", default=None, help="freshly swept kernels json")
    ap.add_argument("--committed", default=COMMITTED_KERNELS, help="committed kernel grid")
    ap.add_argument("--serve-fresh", default=None, help="fresh serve_load report json")
    ap.add_argument("--serve-committed", default=COMMITTED_SERVE,
                    help="committed serve_load report")
    args = ap.parse_args(argv)
    if not args.fresh and not args.serve_fresh:
        ap.error("need --fresh and/or --serve-fresh")

    rc = 0
    if args.fresh:
        fresh, committed = _load(args.fresh), _load(args.committed)
        errors = check_drift(fresh, committed)
        if errors:
            print("bench-drift: committed grid and sweep code diverged:")
            for e in errors:
                print(f"  - {e}")
            rc = 1
        else:
            print(
                f"bench-drift: OK ({len(fresh['rows'])} fresh rows vs "
                f"{len(committed['rows'])} committed; ops "
                f"{sorted({r['op'] for r in committed['rows']})} all covered)"
            )
    if args.serve_fresh:
        fresh, committed = _load(args.serve_fresh), _load(args.serve_committed)
        errors = check_serve_drift(fresh, committed)
        if errors:
            print("bench-drift: committed serve report and engine diverged:")
            for e in errors:
                print(f"  - {e}")
            rc = 1
        else:
            print(
                f"bench-drift: serve OK (classes {sorted(fresh['classes'])}, buckets "
                f"{fresh['buckets']['decode_batches']}, "
                f"cold misses {fresh['cold_misses_after_warmup']})"
            )
    return rc


if __name__ == "__main__":
    sys.exit(main())
