"""Registry consistency checker: the candidate registry as a contract.

The dispatch engine assumes a handful of invariants that nothing used to
enforce: every op has an always-runnable default, the per-op binary
pairs reference real candidates of the right op, every candidate's
analytic arm resolves to a cost-model arm the simulator knows, tunable
candidates actually enumerate tile configs, and every (op, platform)
cell has at least one enumerable candidate (an empty cell would make
``candidates_for`` return nothing and selection fall through to a
KeyError at dispatch time).  This pass checks all of them statically at
lint time -- a new op, candidate or platform fails the lint before a
kernel ever runs.  The port has no ``candidates_for``: a cell's
enumeration is the candidates whose ``supports(platform, op=op)`` holds,
the filter every policy applies before its own (quarantine, memory).

Imports ``torch`` (through ``repro_torch.core``); the AST passes import
neither it nor anything of the JAX package.
"""

from __future__ import annotations

import inspect
import os
from typing import List, Optional

from .findings import Finding

__all__ = ["run"]

# a representative aligned shape for config-space enumeration: every
# tunable kernel must offer at least one admissible tile here.  The
# port's attention kernel has a tile space on its split-KV decode route
# (m <= 16 queries) only -- its flash routes run one plan each -- so an
# attention candidate is probed at a decode shape (m queries, n keys,
# head dim)
_PROBE_SHAPE = (256, 256, 256)
_PROBE_SHAPE_BY_OP = {"ATTN": (8, 256, 256)}
_REG_PATH = "src/repro_torch/core/candidates.py"


def _candidate_location(cand, repo_root: Optional[str]) -> tuple:
    """(repo-relative path, line) of a candidate's implementation."""
    try:
        path = inspect.getsourcefile(cand.fn)
        line = cand.fn.__code__.co_firstlineno
    except (TypeError, AttributeError):
        return (_REG_PATH, 1)
    if repo_root and path:
        try:
            path = os.path.relpath(path, repo_root)
        except ValueError:
            pass
    return ((path or _REG_PATH).replace(os.sep, "/"), line)


def run(repo_root: Optional[str] = None) -> List[Finding]:
    from repro_torch.core.candidates import (
        ALL_PLATFORMS,
        BINARY_PAIRS_BY_OP,
        CANDIDATES,
        DEFAULT_BY_OP,
        fallback_chain,
    )
    from repro_torch.core.opkey import OPS
    from repro_torch.core.selector import _sim_to_candidate
    from repro_torch.core.simulate import OP_SIM_ALGOS, SIM_ALGOS

    def candidates_for(platform, op):
        return [c for c in CANDIDATES.values() if c.supports(platform, op=op)]

    findings: List[Finding] = []
    reg_path = _REG_PATH

    def add(rule, message, context, path=reg_path, line=1):
        findings.append(
            Finding(
                rule=rule, path=path, line=line, message=message,
                context=context,
            )
        )

    # RC101: every op has a registered, always-runnable default
    for op in OPS:
        name = DEFAULT_BY_OP.get(op)
        if name is None:
            add("RC101", f"op {op!r} has no DEFAULT_BY_OP entry", f"default:{op}")
            continue
        cand = CANDIDATES.get(name)
        if cand is None:
            add(
                "RC101",
                f"default candidate {name!r} for op {op!r} is not registered",
                f"default:{op}",
            )
            continue
        problems = []
        if op not in cand.ops:
            problems.append(f"does not implement {op!r}")
        if not cand.distributed_safe:
            problems.append("is not distributed_safe")
        if cand.extra_memory:
            problems.append("needs extra memory (OOM guard can refuse it)")
        if set(ALL_PLATFORMS) - set(cand.platforms):
            problems.append(f"is not enumerable on all of {ALL_PLATFORMS}")
        if problems:
            path, line = _candidate_location(cand, repo_root)
            add(
                "RC101",
                f"default candidate {name!r} for op {op!r} must be "
                f"always-runnable but {'; '.join(problems)}",
                f"default:{op}",
                path=path,
                line=line,
            )

    # RC102: binary pairs reference registered candidates of the right op
    for op in OPS:
        pair = BINARY_PAIRS_BY_OP.get(op)
        if pair is None:
            add(
                "RC102",
                f"op {op!r} has no BINARY_PAIRS_BY_OP entry",
                f"pair:{op}",
            )
            continue
        if len(tuple(pair)) != 2:
            add(
                "RC102",
                f"binary pair for op {op!r} must have exactly two members, "
                f"got {pair!r}",
                f"pair:{op}",
            )
            continue
        for member in pair:
            cand = CANDIDATES.get(member)
            if cand is None:
                add(
                    "RC102",
                    f"binary pair for op {op!r} references unregistered "
                    f"candidate {member!r}",
                    f"pair:{op}:{member}",
                )
            elif op not in cand.ops:
                path, line = _candidate_location(cand, repo_root)
                add(
                    "RC102",
                    f"binary pair member {member!r} does not implement op "
                    f"{op!r} (ops={cand.ops})",
                    f"pair:{op}:{member}",
                    path=path,
                    line=line,
                )

    # RC103: analytic arms -- every sim_algo must be a cost-model arm the
    # simulator prices, and must resolve back to a registered candidate
    known_arms = set(SIM_ALGOS) | set(OP_SIM_ALGOS)
    for name, cand in CANDIDATES.items():
        path, line = _candidate_location(cand, repo_root)
        if cand.sim_algo not in known_arms:
            add(
                "RC103",
                f"candidate {name!r} declares sim_algo {cand.sim_algo!r}, "
                f"which the analytic cost model does not price",
                f"sim:{name}",
                path=path,
                line=line,
            )
        mapped = _sim_to_candidate(cand.sim_algo)
        if mapped is not None and mapped not in CANDIDATES:
            add(
                "RC103",
                f"sim arm {cand.sim_algo!r} maps to unregistered candidate "
                f"{mapped!r}",
                f"sim:{name}:{mapped}",
                path=path,
                line=line,
            )

    # RC104: tunable candidates must enumerate a non-empty config space
    for name, cand in CANDIDATES.items():
        if not cand.tunable:
            continue
        probe = _PROBE_SHAPE_BY_OP.get(cand.ops[0], _PROBE_SHAPE)
        space = cand.config_space(*probe, dsize=4)
        if not space:
            path, line = _candidate_location(cand, repo_root)
            add(
                "RC104",
                f"tunable candidate {name!r} enumerates no tile configs at "
                f"shape {probe} -- autotune would have nothing to sweep",
                f"space:{name}",
                path=path,
                line=line,
            )

    # RC105: every (op, platform) cell has at least one candidate
    for op in OPS:
        for platform in ALL_PLATFORMS:
            if not candidates_for(platform, op=op):
                add(
                    "RC105",
                    f"no candidate is enumerable for op {op!r} on platform "
                    f"{platform!r} -- dispatch there would have no "
                    "implementation",
                    f"enum:{op}:{platform}",
                )

    # RC106: graceful degradation -- every (candidate, op) pair must resolve
    # a fallback chain whose members are registered implementors of the op,
    # with no repeats, terminating at the per-op always-runnable default
    for name, cand in CANDIDATES.items():
        path, line = _candidate_location(cand, repo_root)
        for op in cand.ops:
            default = DEFAULT_BY_OP.get(op)
            if default is None:
                continue  # already an RC101 finding
            try:
                chain = fallback_chain(op, name)
            except Exception as e:  # noqa: BLE001 -- any failure is the finding
                add(
                    "RC106",
                    f"fallback_chain({op!r}, {name!r}) raised {e!r} -- "
                    "dispatch could not degrade after a candidate fault",
                    f"chain:{op}:{name}",
                    path=path,
                    line=line,
                )
                continue
            problems = []
            if not chain or chain[-1] != default:
                problems.append(
                    f"does not terminate at the default {default!r}"
                )
            if len(set(chain)) != len(chain):
                problems.append("repeats a member (retry loop)")
            for member in chain:
                mc = CANDIDATES.get(member)
                if mc is None:
                    problems.append(f"member {member!r} is not registered")
                elif op not in mc.ops:
                    problems.append(
                        f"member {member!r} does not implement {op!r}"
                    )
            if problems:
                add(
                    "RC106",
                    f"fallback chain for ({name!r}, {op!r}) = {chain!r} "
                    f"{'; '.join(problems)}",
                    f"chain:{op}:{name}",
                    path=path,
                    line=line,
                )
    return findings
