"""Kernel-contract checker: every candidate's shape/dtype contract, on the
meta route.

Every registered candidate promises ``f(*operands) -> c`` in its op's
storage layout (``core.measure.operand_shapes`` -- two GEMM operands, or
q/k/v for the fused-attention plan op) with the output in the input
dtype.  The port's counterpart of ``jax.eval_shape`` is the meta route
(``kernels.common.route`` gives ``"meta"``): a wrapper handed meta
tensors picks its plan, returns a meta result of the right shape and
dtype, and builds and launches nothing.  So the promise is checked
abstractly -- no FLOP executed, no card needed -- over a deliberately
*ragged* shape grid (extents off every tile edge), because padding and
clamping bugs hide at aligned shapes.  Coverage is total by
construction: the checker walks ``CANDIDATES`` x ``Candidate.ops`` on
the card's platform, so registering a candidate or adding an op to one
enrols it; tests assert the report covers every registered pair.

Two rules:

  * ``KC301`` -- the meta route produced the wrong output shape/dtype (or
    raised) for a (candidate, op, config) cell, or its result disagrees
    in shape or dtype with the plain CPU route's on the same cell.  The
    meta route returns before any launch, so a drift between the two is
    otherwise invisible.
  * ``KC302`` -- an enumerated tile config is not a plan its route
    accepts at that shape (``pick_plan`` raises), its split does not
    cover the k (or key) extent as the plan promises (no empty split, no
    extent left over), or its instance's shared memory, where
    ``kernels/tiling.py`` states it, exceeds the 227 KB one Hopper block
    may hold.  These stand in for the JAX package's MXU-edge and VMEM
    rules, which have no meaning on the card.

Imports torch; use the artifact pass for torch-free contexts.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from .findings import Finding

__all__ = ["ContractReport", "SHAPE_GRID", "PLATFORM", "check_contracts", "plan_problems",
           "run"]

# Ragged (m, n, k, g) probes: one aligned anchor, the rest deliberately
# off the tile edges (sub-tile dims, prime-ish extents, padding-heavy
# remainders).  g > 1 applies only to the grouped ops.
SHAPE_GRID: Tuple[Tuple[int, int, int, int], ...] = (
    (256, 256, 256, 2),  # aligned anchor
    (96, 160, 224, 3),   # everything sub-/off-tile
    (257, 129, 65, 2),   # remainder-of-1 padding on every axis
    (48, 512, 100, 5),   # mixed: one aligned axis, two ragged
)

_DTYPES = ("float32", "bfloat16")

# the platform the contracts are checked for: the card's
PLATFORM = "gpu"


@dataclass
class ContractReport:
    """Findings plus the (candidate, op) pairs actually checked."""

    findings: List[Finding] = field(default_factory=list)
    pairs: Tuple[Tuple[str, str], ...] = ()
    cells: int = 0  # (candidate, op, shape, dtype, config) cells run on both routes


def _expected_out(op: str, m: int, n: int, k: int, g: int):
    if op == "ATTN":  # q:(g, m, k) k/v:(g, n, k) -> (g, m, k); k is d_head
        return (g, m, k)
    return (g, m, n) if op in ("BNT", "BNN") else (m, n)


def _candidate_location(cand, repo_root: Optional[str]) -> Tuple[str, int]:
    return _fn_location(cand.fn, repo_root)


def _fn_location(fn, repo_root: Optional[str]) -> Tuple[str, int]:
    import inspect
    import os

    try:
        path = inspect.getsourcefile(fn) or ""
        line = fn.__code__.co_firstlineno
        if repo_root:
            try:
                path = os.path.relpath(path, repo_root)
            except ValueError:
                pass
        return (path.replace(os.sep, "/"), line)
    except (TypeError, AttributeError):
        return ("src/repro_torch/core/candidates.py", 1)


def plan_problems(kernel: str, m: int, n: int, k: int, dsize: int, g: int,
                  configs) -> List[Tuple[tuple, str]]:
    """(config, detail) for each of ``configs`` that breaks KC302 at this
    shape: not a plan of the route, a split that does not cover the k (or,
    for the attention kernel, the key) extent without an empty split, or a
    shared-memory footprint over one Hopper block's."""
    from repro_torch.kernels import tiling
    from repro_torch.kernels.common import cdiv, pick_plan

    plans = tiling.tile_plans(kernel, m, n, k, dsize, g)
    problems: List[Tuple[tuple, str]] = []
    for cfg in configs:
        cfg = tuple(cfg)
        try:
            plan = pick_plan(plans, cfg, f"{kernel} at g={g} ({m}, {n}, {k}) dsize {dsize}")
        except ValueError as exc:
            problems.append((cfg, f"not a plan of its route: {exc}"))
            continue
        if kernel == "attention_fused":
            variant, splits, per = plan
            if variant == "decode_split" and (per != cfg[1] or splits != cdiv(n, per)):
                problems.append((cfg, f"decode split of {splits} x {per} keys (config "
                                      f"{cfg[1]} keys) does not cover n={n} without an "
                                      "empty split"))
            elif variant == "flash_f32" and not 1 <= splits <= cdiv(n, cfg[1]):
                problems.append((cfg, f"{splits} runs of {cdiv(n, cfg[1])} key tiles of "
                                      f"{cfg[1]} leave a run empty"))
            continue
        variant, tile, splits, per = plan
        if (splits, per) != (1, 1):
            unit, rem = divmod(cfg[2], per)
            if rem or unit < 1 or splits != cdiv(cdiv(k, unit), per):
                problems.append((cfg, f"split of {splits} x {per} steps (config k {cfg[2]} "
                                      f"per split) does not cover k={k} without an empty "
                                      "split"))
        if variant == "wgmma":
            smem = tiling.wgmma_smem_bytes(tile)
            if smem > tiling.SMEM_PER_BLOCK:
                problems.append((cfg, f"wgmma instance BN={tile} holds {smem} bytes of shared "
                                      f"memory, over one block's {tiling.SMEM_PER_BLOCK}"))
    return problems


def check_contracts(
    shapes: Tuple[Tuple[int, int, int, int], ...] = SHAPE_GRID,
    dtypes: Tuple[str, ...] = _DTYPES,
    repo_root: Optional[str] = None,
    platform: str = PLATFORM,
) -> ContractReport:
    import torch

    from repro_torch.core.candidates import CANDIDATES
    from repro_torch.core.measure import operand_shapes
    from repro_torch.core.opkey import GROUPED_OPS
    from repro_torch.kernels import tiling

    report = ContractReport()
    pairs = []
    for name, cand in CANDIDATES.items():
        path, line = _candidate_location(cand, repo_root)

        def add(rule, message, context):
            report.findings.append(
                Finding(rule=rule, path=path, line=line, message=message, context=context))

        for op in cand.ops:
            if not cand.supports(platform, op=op):
                continue
            pairs.append((name, op))
            for (m, n, k, g) in shapes:
                g = g if op in GROUPED_OPS else 1
                op_shapes = operand_shapes(op, m, n, k, g)
                want = _expected_out(op, m, n, k, g)
                for dtype in dtypes:
                    dt = getattr(torch, dtype)
                    dsize = torch.finfo(dt).bits // 8
                    # the default plan, plus (for tunables) the top of the
                    # autotune list -- the two paths Candidate.run takes
                    space = cand.config_space(m, n, k, dsize, max_configs=0, g=g)
                    configs = [None] + ([space[0]] if space else [])
                    if cand.tunable and cand.kernel is not None:
                        # KC302: every enumerated config, not just the ones run
                        enumerated = [tiling.default_config(cand.kernel, m, n, k, dsize, g),
                                      *space]
                        for cfg, detail in plan_problems(cand.kernel, m, n, k, dsize, g,
                                                         enumerated):
                            add("KC302", f"candidate {name!r} enumerates tile {cfg} at {op} "
                                f"g={g} {m}x{n}x{k} {dtype}: {detail}",
                                f"tile:{name}:{op}:{m}x{n}x{k}x{g}:{dtype}:"
                                f"{tiling.config_key(cfg)}")
                    for cfg in configs:
                        report.cells += 1
                        cell = (f"contract:{name}:{op}:{m}x{n}x{k}x{g}:{dtype}"
                                f":{'default' if cfg is None else 'tiled'}")
                        where = f"candidate {name!r} op {op} at {m}x{n}x{k} (g={g}, {dtype}, " \
                                f"config={cfg})"
                        outs = {}
                        for device in ("meta", "cpu"):
                            xs = tuple(torch.zeros(s, dtype=dt, device=device)
                                       for s in op_shapes)
                            try:
                                outs[device] = cand.run(*xs, config=cfg)
                            except Exception as exc:  # a raise IS a finding
                                add("KC301", f"{where} raised on the {device} route: "
                                    f"{type(exc).__name__}: {exc}", f"{cell}:{device}")
                        meta, plain = outs.get("meta"), outs.get("cpu")
                        if meta is not None and (tuple(meta.shape) != want
                                                 or meta.dtype != dt
                                                 or meta.device.type != "meta"):
                            add("KC301", f"{where} returned {tuple(meta.shape)}/{meta.dtype} "
                                f"on {meta.device}, contract requires {want}/{dtype} on meta",
                                cell)
                        elif meta is not None and plain is not None and (
                                plain.shape != meta.shape or plain.dtype != meta.dtype):
                            add("KC301", f"{where}: the meta route gives "
                                f"{tuple(meta.shape)}/{meta.dtype}, the plain route "
                                f"{tuple(plain.shape)}/{plain.dtype}", f"{cell}:plain")
    report.pairs = tuple(pairs)
    return report


def run(repo_root: Optional[str] = None) -> List[Finding]:
    """The pass entry point the lint CLI calls."""
    return check_contracts(repo_root=repo_root).findings
