"""Artifact/schema validator: the port's persisted JSON as machine-checked
contracts.

Statically validates the persistence layer's on-disk artifacts against
the current schema versions and their declared migration paths -- pure
standard library, no torch import, so a checkout can gate its committed
files without the accelerator stack:

  * measurement caches (``core.measure`` v5 key grammar -- the v4 layout
    with ``ATTN`` admitted in the op slot for the paired
    fused-vs-unfused rows; older versions validated against *their*
    grammar since they migrate on load, newer rejected);
  * selector artifacts (``core.selector`` v5 payload layout -- the ATTN
    binary pair plus 2-part ``BQxBK`` tile-config keys -- same
    older-migrates/newer-rejects rule);
  * ``benchmarks/BENCH_kernels.json`` kernel sweeps (``kernel_sweep``'s
    rows: op/config grammar, positive times and bounds, and exactly one
    ``best`` row per cell wherever the sweep marks one);
  * ``benchmarks/BENCH_serve.json`` serve-load reports (top-level +
    per-class schema, dispatch-table op grammar).

The measurement-cache and selector rules are the JAX package's, finding
for finding: both packages write the same v5 formats.  The kernel sweep
is the port's own (``schemas.BENCH_KERNELS_*``).  File kind is sniffed
from the payload shape, not the filename, so a selector artifact passed
by path validates the same as a committed one.
"""

from __future__ import annotations

import glob
import json
import math
import os
from typing import Dict, List, Optional, Sequence

from .findings import Finding
from .schemas import (
    BENCH_KERNELS_ROW_KEYS,
    BENCH_KERNELS_TOP_KEYS,
    BENCH_SERVE_CLASS_KEYS,
    BENCH_SERVE_TOP_KEYS,
    GROUPED_OPS,
    MEASURE_SCHEMA_VERSION,
    OPS,
    SELECTOR_SCHEMA_VERSION,
    SERVE_SCHEMA_VERSION,
    parse_cache_key,
    parse_config_key,
)

__all__ = [
    "DEFAULT_TARGETS",
    "sniff_kind",
    "validate_file",
    "validate_payload",
    "run",
]

# committed artifacts validated by default (checkout-root-relative; globs
# ok).  The port commits no selector artifact: the card's are measured by
# chip_smoke.py into build/, which git ignores.
DEFAULT_TARGETS: Sequence[str] = (
    os.path.join("src", "repro_torch", "benchmarks", "BENCH_kernels.json"),
    os.path.join("src", "repro_torch", "benchmarks", "BENCH_serve.json"),
)

# the dtypes a sweep row may name (kernels.common.KERNEL_DTYPES)
_SWEEP_DTYPES = ("float32", "bfloat16")
# what bounds a row's least time (benchmarks/common.py's roofline)
_BOUND_BY = ("bytes", "operations")


def sniff_kind(payload: Dict) -> Optional[str]:
    """Classify a JSON payload by shape: 'cache' | 'selector' |
    'bench_kernels' | 'bench_serve' | None (unrecognised)."""
    if not isinstance(payload, dict):
        return None
    if "entries" in payload and "model" not in payload:
        return "cache"
    if "model" in payload and "mode" in payload:
        return "selector"
    if "rows" in payload and "timing" in payload:
        return "bench_kernels"
    if "classes" in payload and "buckets" in payload:
        return "bench_serve"
    return None


def _positive(x, optional: bool = False) -> bool:
    """A positive finite number (None too, with ``optional``)."""
    if x is None:
        return optional
    return (isinstance(x, (int, float)) and not isinstance(x, bool)
            and math.isfinite(x) and x > 0)


def _version(
    payload: Dict, path: str, supported: int, add, required: bool = True
) -> Optional[int]:
    """Common schema_version gate: present (when required), integer,
    not newer than ``supported``.  Returns the effective version, or
    None when validation cannot proceed."""
    version = payload.get("schema_version")
    if version is None:
        if not required:
            return 0
        add(
            "AR202",
            f"missing schema_version (current is v{supported})",
            "schema_version:missing",
        )
        return None
    if not isinstance(version, int) or isinstance(version, bool):
        add(
            "AR202",
            f"schema_version {version!r} is not an integer",
            "schema_version:type",
        )
        return None
    if version > supported:
        add(
            "AR202",
            f"schema_version {version} is newer than supported "
            f"v{supported}; the loader would reject this file",
            "schema_version:newer",
        )
        return None
    return version


def _validate_times(times, keyctx: str, add) -> None:
    """One cache entry: {candidate: {config_key: seconds}} (v1 flat
    {candidate: seconds} accepted — it migrates on load)."""
    if not isinstance(times, dict):
        add("AR203", f"entry {keyctx} is not an object", f"{keyctx}:times")
        return
    for name, cfgs in times.items():
        if isinstance(cfgs, (int, float)) and not isinstance(cfgs, bool):
            if cfgs <= 0:
                add(
                    "AR203",
                    f"entry {keyctx} candidate {name!r} has non-positive "
                    f"timing {cfgs!r}",
                    f"{keyctx}:{name}",
                )
            continue
        if not isinstance(cfgs, dict):
            add(
                "AR203",
                f"entry {keyctx} candidate {name!r} timings are neither a "
                "number nor a config map",
                f"{keyctx}:{name}",
            )
            continue
        for ck, t in cfgs.items():
            try:
                parse_config_key(str(ck))
            except ValueError as e:
                add("AR203", f"entry {keyctx} candidate {name!r}: {e}",
                    f"{keyctx}:{name}:{ck}")
            if (
                not isinstance(t, (int, float))
                or isinstance(t, bool)
                or t <= 0
            ):
                add(
                    "AR203",
                    f"entry {keyctx} candidate {name!r} config {ck!r} has "
                    f"non-positive timing {t!r}",
                    f"{keyctx}:{name}:{ck}",
                )


def _validate_cache(payload: Dict, path: str, add) -> None:
    version = _version(payload, path, MEASURE_SCHEMA_VERSION, add,
                       required=False)
    if version is None:
        return
    entries = payload.get("entries")
    if not isinstance(entries, dict):
        add("AR204", "cache has no 'entries' object", "entries")
        return
    for ks, times in entries.items():
        try:
            parse_cache_key(str(ks), version if version >= 1 else 1)
        except ValueError as e:
            add("AR203", str(e), f"key:{ks}")
            continue
        _validate_times(times, f"{ks!r}", add)


def _validate_selector(payload: Dict, path: str, add) -> None:
    version = _version(payload, path, SELECTOR_SCHEMA_VERSION, add,
                       required=False)
    if version is None:
        return
    if payload.get("mode") not in ("binary", "kway"):
        add(
            "AR204",
            f"selector mode {payload.get('mode')!r} is neither 'binary' "
            "nor 'kway'",
            "mode",
        )
    if not isinstance(payload.get("model"), dict):
        add("AR204", "selector artifact has no 'model' object", "model")
    # pairs: v0-v2 used the single NT 'binary_pair'; v3+ the per-op table
    if version >= 3:
        pairs = payload.get("binary_pairs")
        if not isinstance(pairs, dict):
            add(
                "AR204",
                f"v{version} selector artifact has no 'binary_pairs' table",
                "binary_pairs",
            )
            pairs = {}
        for op, pair in pairs.items():
            if op not in OPS:
                add("AR204", f"binary_pairs names unknown op {op!r}",
                    f"binary_pairs:{op}")
            if (
                not isinstance(pair, (list, tuple))
                or len(pair) != 2
                or not all(isinstance(p, str) and p for p in pair)
            ):
                add(
                    "AR204",
                    f"binary pair for op {op!r} must be two candidate "
                    f"names, got {pair!r}",
                    f"binary_pairs:{op}:shape",
                )
    else:
        pair = payload.get("binary_pair")
        if pair is not None and (
            not isinstance(pair, (list, tuple)) or len(pair) != 2
        ):
            add("AR204", f"binary_pair must be two names, got {pair!r}",
                "binary_pair")
    # tile tables (v3+): {op: {candidate: {modal, by_shape}}}
    for op, table in (payload.get("tile_tables") or {}).items():
        if op not in OPS:
            add("AR204", f"tile_tables names unknown op {op!r}",
                f"tile_tables:{op}")
            continue
        if not isinstance(table, dict):
            add("AR204", f"tile_tables[{op!r}] is not an object",
                f"tile_tables:{op}:shape")
            continue
        for name, entry in table.items():
            if not isinstance(entry, dict):
                add("AR204",
                    f"tile_tables[{op!r}][{name!r}] is not an object",
                    f"tile_tables:{op}:{name}")
                continue
            modal = entry.get("modal")
            if modal:
                try:
                    parse_config_key(str(modal))
                except ValueError as e:
                    add("AR204", f"tile_tables[{op!r}][{name!r}]: {e}",
                        f"tile_tables:{op}:{name}:modal")
            for sk, ck in (entry.get("by_shape") or {}).items():
                parts = str(sk).split("x")
                if len(parts) != 3 or not all(
                    p.isdigit() and int(p) > 0 for p in parts
                ):
                    add(
                        "AR204",
                        f"tile_tables[{op!r}][{name!r}] has malformed "
                        f"shape key {sk!r}",
                        f"tile_tables:{op}:{name}:{sk}",
                    )
                try:
                    parse_config_key(str(ck))
                except ValueError as e:
                    add("AR204",
                        f"tile_tables[{op!r}][{name!r}][{sk!r}]: {e}",
                        f"tile_tables:{op}:{name}:{sk}:config")


def _validate_bench_kernels(payload: Dict, path: str, add) -> None:
    missing = BENCH_KERNELS_TOP_KEYS - set(payload)
    if missing:
        add("AR204", f"missing top-level keys {sorted(missing)}",
            "top:" + ",".join(sorted(missing)))
        return
    rows = payload["rows"]
    if not isinstance(rows, list) or not rows:
        add("AR204", "'rows' must be a non-empty list", "rows")
        return
    seen: Dict[tuple, int] = {}
    best_by_cell: Dict[tuple, int] = {}
    for i, row in enumerate(rows):
        ctx = f"row[{i}]"
        if not isinstance(row, dict):
            add("AR204", f"{ctx} is not an object", ctx)
            continue
        missing = BENCH_KERNELS_ROW_KEYS - set(row)
        if missing:
            add("AR204", f"{ctx} missing keys {sorted(missing)}", f"{ctx}:keys")
            continue
        op = row["op"]
        if op not in OPS:
            add("AR204", f"{ctx} names unknown op {op!r}", f"{ctx}:op")
            continue
        if row["dtype"] not in _SWEEP_DTYPES:
            add("AR204", f"{ctx} names dtype {row['dtype']!r}, not one of {_SWEEP_DTYPES}",
                f"{ctx}:dtype")
        g, m, n, k = row["g"], row["m"], row["n"], row["k"]
        if any(not isinstance(v, int) or isinstance(v, bool) or v < 1 for v in (g, m, n, k)):
            add("AR204", f"{ctx} has non-positive extents (g={g}, m={m}, n={n}, k={k})",
                f"{ctx}:extents")
            continue
        if g != 1 and op not in GROUPED_OPS:
            add("AR204", f"{ctx} gives unbatched op {op!r} batch extent g={g}", f"{ctx}:batch")
        if not isinstance(row["candidate"], str) or not row["candidate"]:
            add("AR204", f"{ctx} names no candidate", f"{ctx}:candidate")
        try:
            parse_config_key(str(row["config"]))
        except ValueError as e:
            add("AR204", f"{ctx}: {e}", f"{ctx}:config")
        rel_err = row["rel_err"]
        if (not isinstance(rel_err, (int, float)) or isinstance(rel_err, bool)
                or not math.isfinite(rel_err) or rel_err < 0):
            add("AR204", f"{ctx} has rel_err {rel_err!r}, not a finite error",
                f"{ctx}:rel_err")
        for key, optional in (("median_us", False), ("bound_us", False), ("device_us", True),
                              ("queued_us", True), ("library_device_us", True)):
            if not _positive(row[key], optional):
                add("AR204", f"{ctx} has {key} {row[key]!r}, not a positive time"
                    + (" or null" if optional else ""), f"{ctx}:{key}")
        if row["bound_by"] not in _BOUND_BY:
            add("AR204", f"{ctx} bound_by {row['bound_by']!r} is neither 'bytes' nor "
                "'operations'", f"{ctx}:bound_by")
        cell = (row["dtype"], op, g, m, n, k)
        key = cell + (row["candidate"], str(row["config"]))
        if key in seen:
            add("AR204", f"{ctx} repeats row[{seen[key]}]'s (cell, candidate, config)",
                f"{ctx}:duplicate")
        seen.setdefault(key, i)
        # where the sweep marks a winner, it marks exactly one row per
        # (dtype, op, g, m, n, k) cell across all (candidate, config) rows
        if "best" in row:
            if not isinstance(row["best"], bool):
                add("AR204", f"{ctx} best must be a bool, got {row['best']!r}", f"{ctx}:best")
            best_by_cell.setdefault(cell, 0)
            if row["best"] is True:
                best_by_cell[cell] += 1
    for cell, count in sorted(best_by_cell.items()):
        if count != 1:
            add("AR204", f"cell {cell} marks {count} rows 'best' (the sweep marks exactly one "
                "winner per cell)", f"best:{':'.join(str(c) for c in cell)}")


def _validate_bench_serve(payload: Dict, path: str, add) -> None:
    version = _version(payload, path, SERVE_SCHEMA_VERSION, add)
    if version is None:
        return
    missing = BENCH_SERVE_TOP_KEYS - set(payload)
    if missing:
        add("AR204", f"missing top-level keys {sorted(missing)}",
            "top:" + ",".join(sorted(missing)))
        return
    classes = payload["classes"]
    if not isinstance(classes, dict) or not classes:
        add("AR204", "'classes' must be a non-empty object", "classes")
        return
    for cls, row in classes.items():
        if not isinstance(row, dict):
            add("AR204", f"class {cls!r} is not an object", f"class:{cls}")
            continue
        missing = BENCH_SERVE_CLASS_KEYS - set(row)
        if missing:
            add("AR204", f"class {cls!r} missing keys {sorted(missing)}",
                f"class:{cls}:keys")
            continue
        dispatch = row["dispatch"]
        if not isinstance(dispatch, dict):
            add("AR204", f"class {cls!r} dispatch is not an object",
                f"class:{cls}:dispatch")
            continue
        for op, decisions in dispatch.items():
            if op not in OPS:
                add("AR204",
                    f"class {cls!r} dispatch names unknown op {op!r}",
                    f"class:{cls}:dispatch:{op}")
                continue
            if not isinstance(decisions, dict):
                add("AR204",
                    f"class {cls!r} dispatch[{op!r}] is not an object",
                    f"class:{cls}:dispatch:{op}:shape")
                continue
            for label, count in decisions.items():
                if (
                    not isinstance(count, int)
                    or isinstance(count, bool)
                    or count < 1
                ):
                    add(
                        "AR204",
                        f"class {cls!r} dispatch[{op!r}][{label!r}] count "
                        f"{count!r} must be a positive int",
                        f"class:{cls}:dispatch:{op}:{label}",
                    )
    for cls, misses in (payload.get("cold_misses_after_warmup") or {}).items():
        if not isinstance(misses, int) or isinstance(misses, bool) or misses < 0:
            add(
                "AR204",
                f"cold_misses_after_warmup[{cls!r}] must be a "
                f"non-negative int, got {misses!r}",
                f"cold:{cls}",
            )


_VALIDATORS = {
    "cache": _validate_cache,
    "selector": _validate_selector,
    "bench_kernels": _validate_bench_kernels,
    "bench_serve": _validate_bench_serve,
}


def validate_payload(
    payload: Dict, relpath: str, kind: Optional[str] = None
) -> List[Finding]:
    """All schema findings for one parsed payload."""
    findings: List[Finding] = []

    def add(rule: str, message: str, context: str) -> None:
        findings.append(
            Finding(
                rule=rule,
                path=relpath,
                line=1,
                message=message,
                context=context,
            )
        )

    kind = kind or sniff_kind(payload)
    if kind is None:
        add(
            "AR201",
            "payload is not a recognised artifact (measurement cache, "
            "selector artifact, BENCH_kernels, or BENCH_serve)",
            "kind",
        )
        return findings
    _VALIDATORS[kind](payload, relpath, add)
    return findings


def validate_file(
    path: str, repo_root: Optional[str] = None, kind: Optional[str] = None
) -> List[Finding]:
    rel = (
        os.path.relpath(path, repo_root) if repo_root else path
    ).replace(os.sep, "/")
    try:
        with open(path) as fh:
            payload = json.load(fh)
    except (OSError, json.JSONDecodeError) as e:
        return [
            Finding(
                rule="AR201",
                path=rel,
                line=1,
                message=f"unreadable artifact: {e}",
                context="read",
            )
        ]
    if not isinstance(payload, dict):
        return [
            Finding(
                rule="AR201",
                path=rel,
                line=1,
                message="artifact is not a JSON object",
                context="shape",
            )
        ]
    return validate_payload(payload, rel, kind=kind)


def run(
    repo_root: str, targets: Sequence[str] = DEFAULT_TARGETS
) -> List[Finding]:
    """The pass entry point: validate every matching target.  Missing
    default targets are skipped (a repo without committed BENCH files has
    nothing to validate); an explicit non-glob target that is missing is
    an AR201 finding."""
    findings: List[Finding] = []
    for target in targets:
        pattern = (
            target
            if os.path.isabs(target)
            else os.path.join(repo_root, target)
        )
        matches = sorted(glob.glob(pattern))
        if not matches:
            if target not in DEFAULT_TARGETS and not glob.has_magic(target):
                findings.append(
                    Finding(
                        rule="AR201",
                        path=target.replace(os.sep, "/"),
                        line=1,
                        message="artifact target does not exist",
                        context="missing",
                    )
                )
            continue
        for path in matches:
            findings.extend(validate_file(path, repo_root=repo_root))
    return findings
