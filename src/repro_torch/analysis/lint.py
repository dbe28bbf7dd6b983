"""``python -m repro_torch.analysis.lint`` -- the port's own static analyzer.

Runs the seven passes and exits non-zero when any *unsuppressed*
error-severity finding remains:

  dispatch     AST: GEMM-shaped calls bypassing core.dispatch (DL0xx)
  registry     candidate-registry consistency (RC1xx)
  artifacts    torch-free schema validation of persisted JSON (AR2xx)
  contracts    meta-route output shape/dtype against the plain route's,
               and every enumerated plan's split and shared memory (KC30x)
  coverage     every CUDA launch's declared grid evaluated over the whole
               grid for every (candidate, op, plan): coverage, no overlap,
               blocks inside their operands, CUDA's limits (KC31x)
  numerics     f32 accumulation in the CUDA sources' mma instructions,
               accumulators and downcasts, and in the kernel arms' plain
               routes (NM401-NM403)
  concurrency  AST: guarded-by lock discipline, ContextVar set/reset
               pairing, thread/acquire hygiene (CC50x)

``--sanitize`` additionally runs the poison sanitizer (NM404, the plain
routes on the CPU -- see ``sanitize.py``; on the card it runs from
``chip_smoke.py`` and a ``gpu``-marked test).  Findings print as
``path:line: severity RULE message`` -- the gcc format editors and CI
annotators already parse; ``--format json`` emits one machine-readable
object instead.

Suppression goes through the committed baseline
(``src/repro_torch/analysis/baseline.json``): a JSON map from finding
fingerprint to a human-written justification.  Empty justifications do
not suppress (``BL901``), stale entries warn (``BL902``), duplicate
fingerprints warn (``BL903``).  Seed new entries with
``--write-baseline`` (sorted and deduplicated for reviewable diffs) and
then fill in each justification by hand.

``dispatch``, ``artifacts`` and ``concurrency`` import nothing beyond
the standard library; the other passes import ``repro_torch.core`` (and
so ``torch``) lazily, only when selected.  The torch-free passes run on
worker threads beside the others on the main thread (``--jobs 1``
serialises) and every pass that reads sources shares one source cache
(``--stats`` shows the timings and the cache counters).  The rule
catalogue, ``--list-rules --format md``, is committed as
``lint-rules.md`` beside this module.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

from .findings import RULES, Baseline, Finding, apply_baseline

__all__ = ["PASSES", "RULE_SECTIONS", "main", "run_passes"]

PASSES = ("dispatch", "registry", "artifacts", "contracts", "coverage", "numerics",
          "concurrency")
# modules are imported lazily so the torch-free passes stay torch-free
# under --passes
_IMPORTS_TORCH = {
    "dispatch": False,
    "artifacts": False,
    "concurrency": False,
    "registry": True,
    "contracts": True,
    "coverage": True,
    "numerics": True,
}
_PASS_MODULES = {
    "dispatch": "dispatch_lint",
    "registry": "registry_lint",
    "artifacts": "artifacts_lint",
    "contracts": "contracts",
    "coverage": "coverage",
    "numerics": "numerics",
    "concurrency": "concurrency",
}
# which pass entry points accept the shared SourceCache
_TAKES_CACHE = {"dispatch", "numerics", "concurrency"}

# rule catalogue sections for --list-rules --format md; a test asserts
# every registered rule appears in exactly one section
RULE_SECTIONS: Tuple[Tuple[str, str, Tuple[str, ...]], ...] = (
    ("Dispatch bypass", "dispatch", ("DL001", "DL002")),
    ("Registry consistency", "registry",
     ("RC101", "RC102", "RC103", "RC104", "RC105", "RC106")),
    ("Artifact schemas", "artifacts", ("AR201", "AR202", "AR203", "AR204")),
    ("Kernel contracts", "contracts", ("KC301", "KC302")),
    ("Index-map coverage", "coverage",
     ("KC310", "KC311", "KC312", "KC313", "KC314", "KC315")),
    ("Numerics accumulation", "numerics + --sanitize",
     ("NM401", "NM402", "NM403", "NM404")),
    ("Concurrency discipline", "concurrency",
     ("CC501", "CC502", "CC503", "CC504", "CC505")),
    ("Baseline hygiene", "(any)", ("BL901", "BL902", "BL903")),
)

RULES_MD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "lint-rules.md")


def _default_baseline_path() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "baseline.json")


def _repo_root() -> str:
    # src/repro_torch/analysis/lint.py -> the checkout root, three parents up
    return os.path.abspath(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                        os.pardir, os.pardir, os.pardir))


def _run_one(name: str, repo_root: str, cache) -> List[Finding]:
    import importlib

    module = importlib.import_module(f".{_PASS_MODULES[name]}", package=__package__)
    if name in _TAKES_CACHE:
        return module.run(repo_root, cache=cache)
    return module.run(repo_root)


def run_passes(
    passes: Sequence[str],
    repo_root: Optional[str] = None,
    jobs: int = 0,
    stats: Optional[Dict[str, float]] = None,
) -> List[Finding]:
    """All findings from the selected passes, in pass order.

    ``jobs != 1`` runs the torch-free passes on worker threads beside
    the others on the main thread.  ``stats``, when given, is filled
    with per-pass wall times (and the parse cache under ``_cache``)."""
    from .cache import SourceCache

    repo_root = repo_root or _repo_root()
    unknown = [p for p in passes if p not in PASSES]
    if unknown:
        raise ValueError(f"unknown pass(es) {', '.join(unknown)}; have {', '.join(PASSES)}")
    cache = SourceCache()
    results: Dict[str, List[Finding]] = {}

    def timed(name: str) -> List[Finding]:
        t0 = time.perf_counter()
        try:
            return _run_one(name, repo_root, cache)
        finally:
            if stats is not None:
                stats[name] = time.perf_counter() - t0

    ast_passes = [p for p in passes if not _IMPORTS_TORCH[p]]
    torch_passes = [p for p in passes if _IMPORTS_TORCH[p]]
    if jobs == 1 or not ast_passes or not torch_passes:
        for name in passes:
            results[name] = timed(name)
    else:
        workers = jobs if jobs > 0 else len(ast_passes)
        with ThreadPoolExecutor(max_workers=workers) as pool:
            futures = {p: pool.submit(timed, p) for p in ast_passes}
            for name in torch_passes:
                results[name] = timed(name)
            for name, fut in futures.items():
                results[name] = fut.result()

    if stats is not None:
        stats["_cache"] = cache  # type: ignore[assignment]
    findings: List[Finding] = []
    for name in passes:
        findings.extend(results[name])
    return findings


def _finding_payload(f: Finding) -> Dict:
    return {
        "rule": f.rule,
        "path": f.path,
        "line": f.line,
        "severity": f.severity,
        "message": f.message,
        "context": f.context,
        "fingerprint": f.fingerprint,
        "suppressed": f.suppressed,
        "justification": f.justification,
    }


def render_rules_md() -> str:
    lines = [
        "# repro_torch.analysis lint rules",
        "",
        "Generated by `python -m repro_torch.analysis.lint --list-rules "
        "--format md`.  Do not edit by hand: a test diffs this file against "
        "a fresh render.",
        "",
    ]
    for title, pass_name, rules in RULE_SECTIONS:
        lines.append(f"## {title} (`{pass_name}`)")
        lines.append("")
        lines.append("| rule | description |")
        lines.append("| --- | --- |")
        for rule in rules:
            lines.append(f"| {rule} | {RULES[rule]} |")
        lines.append("")
    return "\n".join(lines)


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="Dispatch/registry/artifact/contract/numerics/concurrency static "
                    "analysis of the port.",
    )
    parser.add_argument("--passes", default=",".join(PASSES),
                        help="comma-separated subset of: " + ", ".join(PASSES))
    parser.add_argument("--baseline", default=_default_baseline_path(),
                        help="baseline JSON path (default: the committed package baseline)")
    parser.add_argument("--no-baseline", action="store_true",
                        help="ignore the baseline: every finding is active")
    parser.add_argument("--write-baseline", action="store_true",
                        help="write current unsuppressed findings into the baseline with "
                             "empty justifications (fill them in by hand), then exit 0")
    parser.add_argument("--root", default=None,
                        help="repo root (default: derived from the package location)")
    parser.add_argument("--list-rules", action="store_true", help="print the rule catalogue")
    parser.add_argument("--format", choices=("text", "json", "md"), default="text",
                        help="output format; 'md' is only valid with --list-rules")
    parser.add_argument("--sanitize", action="store_true",
                        help="also run the poison sanitizer (NM404) over every plan of "
                             "every candidate on the CPU's plain routes")
    parser.add_argument("--sanitize-full", action="store_true",
                        help="run the sanitizer over the full grid (the JAX package's "
                             "second ragged shape too; implies --sanitize)")
    parser.add_argument("--stats", action="store_true",
                        help="print per-pass wall time and parse-cache counters")
    parser.add_argument("--jobs", type=int, default=0,
                        help="worker threads for the AST passes (0 = auto, 1 = fully serial)")
    args = parser.parse_args(argv)

    if args.list_rules:
        if args.format == "md":
            print(render_rules_md())
        elif args.format == "json":
            print(json.dumps({"rules": RULES, "passes": list(PASSES)}, indent=2))
        else:
            for rule in sorted(RULES):
                print(f"{rule}  {RULES[rule]}")
        return 0
    if args.format == "md":
        parser.error("--format md is only valid with --list-rules")

    passes = [p.strip() for p in args.passes.split(",") if p.strip()]
    unknown = [p for p in passes if p not in PASSES]
    if unknown:
        parser.error(f"unknown pass(es) {', '.join(unknown)}; have {', '.join(PASSES)}")

    repo_root = os.path.abspath(args.root) if args.root else _repo_root()
    stats: Dict[str, float] = {}
    findings = run_passes(passes, repo_root, jobs=args.jobs, stats=stats)
    if args.sanitize_full:
        args.sanitize = True
    if args.sanitize:
        from . import sanitize

        t0 = time.perf_counter()
        findings.extend(sanitize.run(repo_root, full=args.sanitize_full))
        stats["sanitize"] = time.perf_counter() - t0

    baseline: Optional[Baseline] = None
    if not args.no_baseline and not args.write_baseline:
        if os.path.exists(args.baseline):
            baseline = Baseline.load(args.baseline)

    if args.write_baseline:
        existing = (Baseline.load(args.baseline) if os.path.exists(args.baseline)
                    else Baseline(path=args.baseline))
        added = 0
        for f in findings:
            if f.fingerprint not in existing.entries:
                existing.entries[f.fingerprint] = ""
                added += 1
        existing.save(args.baseline)
        print(f"baseline: {args.baseline} ({added} new entries, {len(existing.entries)} "
              "total) -- add a justification to each new entry or the lint will fail "
              "with BL901")
        return 0

    active, suppressed = apply_baseline(findings, baseline)
    active.sort(key=lambda f: (f.path, f.line, f.rule))
    errors = [f for f in active if f.severity == "error"]
    warnings = [f for f in active if f.severity == "warning"]
    cache = stats.pop("_cache", None)
    stage_names = passes + (["sanitize"] if args.sanitize else [])

    if args.format == "json":
        payload = {
            "passes": stage_names,
            "findings": [_finding_payload(f) for f in active],
            "suppressed": [_finding_payload(f) for f in suppressed],
            "summary": {"errors": len(errors), "warnings": len(warnings),
                        "baselined": len(suppressed)},
            "stats": {name: round(seconds, 3) for name, seconds in sorted(stats.items())},
        }
        if cache is not None:
            payload["stats"]["files_parsed"] = cache.misses
            payload["stats"]["reparses_avoided"] = cache.hits
        print(json.dumps(payload, indent=2))
        return 1 if errors else 0

    for f in active:
        print(f.render())
    if args.stats:
        for name in stage_names:
            if name in stats:
                print(f"repro_torch-lint: pass {name}: {stats[name]:.2f}s")
        if cache is not None:
            print(f"repro_torch-lint: parse cache: {cache.stats()}")
    print(f"repro_torch-lint: {len(stage_names)} pass(es) [{', '.join(stage_names)}]: "
          f"{len(errors)} error(s), {len(warnings)} warning(s), {len(suppressed)} baselined")
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
