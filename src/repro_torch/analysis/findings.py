"""Finding and baseline primitives shared by every lint pass.

A ``Finding`` is one rule violation at one source location.  Its
``fingerprint`` deliberately excludes the line number: baselining a
finding must survive unrelated edits above it, so the fingerprint is
``rule:path:context`` where ``context`` is a pass-chosen stable detail
(an einsum spec, a candidate name, an artifact key) — the same scheme
clang-tidy and ruff use for their suppression files.

A ``Baseline`` is a committed JSON file mapping fingerprints to
*justifications*.  Suppression without a justification is itself a
finding (``BL901``): the baseline documents accepted debt, it does not
hide it.  Entries that no longer match anything are reported as
warnings (``BL902``) so the file cannot silently rot.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = [
    "Finding",
    "Baseline",
    "RULES",
    "SEVERITIES",
    "apply_baseline",
]

SEVERITIES = ("error", "warning")

# rule id -> one-line description of the passes the port has (the
# --list-rules catalogue; tests assert every emitted finding uses a
# registered rule)
RULES: Dict[str, str] = {
    # dispatch-bypass (AST) pass
    "DL001": "GEMM-shaped torch.einsum bypasses core.dispatch/dispatch_attention",
    "DL002": "matmul-family call (@, torch.matmul/mm/bmm/tensordot, F.linear) "
             "bypasses core.dispatch/dispatch_attention",
    # registry consistency pass
    "RC101": "op has no always-runnable default candidate",
    "RC102": "binary pair references a missing/op-mismatched candidate",
    "RC103": "candidate's analytic arm (sim_algo) is unknown or does not "
             "resolve to a registered candidate",
    "RC104": "tunable candidate enumerates an empty tile-config space",
    "RC105": "no candidate enumerable for an (op, platform) cell",
    "RC106": "candidate's fallback chain does not terminate at the per-op "
             "default (or contains unregistered/repeated members)",
    # artifact/schema pass
    "AR201": "artifact file unreadable or not a JSON object",
    "AR202": "artifact schema_version missing, non-integer, or newer than "
             "supported",
    "AR203": "malformed measurement-cache key or timing entry",
    "AR204": "BENCH/selector payload violates its schema",
    # kernel-contract pass
    "KC301": "candidate produces the wrong output shape/dtype on the meta route "
             "(or one that differs from the plain route's)",
    "KC302": "enumerated tile config fails static validation "
             "(not a plan of its route / split does not cover the extent / "
             "shared memory over one Hopper block's)",
    # numerics-accumulation pass
    "NM401": "low-precision product without f32 accumulation (PTX mma D/C type "
             "or asm outputs, a plain route's matmul, cuBLAS reduced-precision "
             "reduction)",
    "NM402": "accumulator (+=, fmaf or mma D target) is not declared float",
    "NM403": "value downcast below float32 before being accumulated",
    "NM404": "poison sanitizer: memory outside the operands, or an output "
             "allocation, leaked into the logical output (or output deviates "
             "from the f64 oracle)",
    # concurrency/lock-discipline pass
    "CC501": "guarded-by attribute mutated outside a 'with <lock>' block",
    "CC502": "guarded-by annotation names a lock that is never defined",
    "CC503": "ContextVar.set without a matching reset in a finally block",
    "CC504": "thread spawned in a module that never joins any thread",
    "CC505": "bare lock.acquire() call; use the 'with lock:' form",
    # baseline hygiene
    "BL901": "baseline entry carries no justification",
    "BL902": "baseline entry matches no current finding (stale)",
    "BL903": "baseline file contains duplicate fingerprint keys",
}


@dataclass(frozen=True)
class Finding:
    """One rule violation at one source location."""

    rule: str
    path: str  # repo-root-relative, '/'-separated
    line: int
    message: str
    context: str = ""  # stable fingerprint detail (einsum spec, name, ...)
    severity: str = "error"
    suppressed: bool = False
    justification: Optional[str] = None

    def __post_init__(self):
        if self.rule not in RULES:
            raise ValueError(f"unregistered rule id {self.rule!r}")
        if self.severity not in SEVERITIES:
            raise ValueError(f"unknown severity {self.severity!r}")

    @property
    def fingerprint(self) -> str:
        return f"{self.rule}:{self.path}:{self.context}"

    def render(self) -> str:
        sup = " [baselined]" if self.suppressed else ""
        return (
            f"{self.path}:{self.line}: {self.severity} {self.rule} "
            f"{self.message}{sup}"
        )


@dataclass
class Baseline:
    """Committed fingerprint -> justification suppression table."""

    entries: Dict[str, str] = field(default_factory=dict)
    path: Optional[str] = None
    # fingerprints that appeared more than once in the loaded JSON (the
    # parser keeps the last occurrence) — surfaced as BL903 warnings
    duplicates: List[str] = field(default_factory=list)

    @classmethod
    def load(cls, path: str) -> "Baseline":
        duplicates: List[str] = []

        def _record_dups(pairs):
            seen: Dict[str, object] = {}
            for key, value in pairs:
                if key in seen:
                    duplicates.append(key)
                seen[key] = value
            return seen

        with open(path) as fh:
            payload = json.load(fh, object_pairs_hook=_record_dups)
        if not isinstance(payload, dict) or not isinstance(
            payload.get("entries"), dict
        ):
            raise ValueError(
                f"baseline {path!r} must be "
                '{"entries": {fingerprint: justification}}'
            )
        entries = {
            str(fp): str(just) for fp, just in payload["entries"].items()
        }
        return cls(
            entries=entries, path=path, duplicates=sorted(set(duplicates))
        )

    def save(self, path: Optional[str] = None) -> None:
        path = path or self.path
        if path is None:
            raise ValueError("Baseline has no path to save to")
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        payload = {"entries": dict(sorted(self.entries.items()))}
        with open(path, "w") as fh:
            json.dump(payload, fh, indent=2, sort_keys=True)
            fh.write("\n")

    @classmethod
    def from_findings(
        cls, findings: Sequence[Finding], justification: str = ""
    ) -> "Baseline":
        """Seed a baseline from current findings.  The default empty
        justification makes the lint fail with BL901 until a human fills
        each entry in — baselining is an explicit, documented act."""
        return cls(
            entries={f.fingerprint: justification for f in findings}
        )


def apply_baseline(
    findings: Sequence[Finding], baseline: Optional[Baseline]
) -> Tuple[List[Finding], List[Finding]]:
    """Split findings into (active, suppressed) under ``baseline``.

    Appends the baseline's own hygiene findings to the active list:
    ``BL901`` (error) for suppressions without a justification — the
    matched finding stays *active* in that case, an empty string must
    not buy suppression — ``BL902`` (warning) for stale entries, and
    ``BL903`` (warning) for duplicate fingerprint keys in the committed
    file (JSON keeps the last one silently; a reader of the diff must see
    it).
    """
    if baseline is None:
        return list(findings), []
    active: List[Finding] = []
    suppressed: List[Finding] = []
    matched: set = set()
    for f in findings:
        just = baseline.entries.get(f.fingerprint)
        if just is None:
            active.append(f)
            continue
        matched.add(f.fingerprint)
        if not just.strip():
            active.append(f)
        else:
            suppressed.append(
                replace(f, suppressed=True, justification=just)
            )
    bl_path = baseline.path or "<baseline>"
    for fp, just in sorted(baseline.entries.items()):
        if fp in matched and not just.strip():
            active.append(
                Finding(
                    rule="BL901",
                    path=bl_path,
                    line=1,
                    message=f"baseline entry {fp!r} has no justification; "
                    "suppression requires a documented reason",
                    context=fp,
                )
            )
        elif fp not in matched:
            active.append(
                Finding(
                    rule="BL902",
                    path=bl_path,
                    line=1,
                    message=f"stale baseline entry {fp!r} matches no "
                    "current finding; delete it",
                    context=fp,
                    severity="warning",
                )
            )
    for fp in baseline.duplicates:
        active.append(
            Finding(
                rule="BL903",
                path=bl_path,
                line=1,
                message=f"duplicate fingerprint {fp!r} in baseline; JSON "
                "silently keeps the last occurrence — deduplicate "
                "(re-run --write-baseline)",
                context=fp,
                severity="warning",
            )
        )
    return active, suppressed
