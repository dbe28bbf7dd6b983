"""Index-map/coverage pass: a proof of every CUDA launch's grid.

Every CUDA launch of the port takes its grid from a declared
``KernelGridSpec`` (``kernels/gridspec.py``): the wrapper builds the spec
and passes its ``launch`` to the C entry point, which computes no grid
of its own.  For every registered (candidate, op) pair and every plan of
``kernels/tiling.py::tile_plans`` (both dtypes, aligned and offset
operands, the card's SM count), this pass fetches the candidate's
specs and evaluates their index maps over the whole grid, proving per
launch:

  KC310  every output block is written (no gaps); for a persistent grid,
         every unit is visited by the programs' strided walk
  KC311  no two grid points that differ on a parallel axis write the same
         output block (a race); for a persistent grid, no unit is visited
         twice
  KC312  every block starts inside its operand: ``0 <= start < extent``
         (the kernels take no padding and mask their tails; on a padded
         extent this is the JAX package's ``start + block <= extent``)
  KC313  the parallel grid has as many points as the output has blocks
         (the unit grid, for a persistent launch), and the launch is the
         grid (or ``(programs, 1, 1)``) within CUDA's limits
  KC314  index maps have the right arity and result rank
  KC315  every tunable candidate has a registered grid spec at all

This is the static complement of the sanitizer (``sanitize.py``): the
sanitizer runs sampled shapes on poisoned memory, this pass proves the
schedule of every enumerated cell without running a kernel.  The maps are
evaluated on numpy index arrays, a whole grid at once (a map that does not
take arrays is evaluated point by point); each rule reports the first
offending point in row-major grid order, as the JAX package's pass does.

Non-tunable (library) candidates launch no kernel of the port; they are
counted as trivially covered so the report can assert every pair.

On the card, ``launch_routes`` shows that a kernel runs the grid it is
given: each route launched from its spec on the sanitizer's poisoned
output allocation writes every output element and matches the plain
version; and with the route's spec function replaced for the call by one
whose grid is a block short on the output's slowest axis
(``short_grid``), exactly the blocks the proof names (KC313, KC310) come
back poisoned and every other block is bit-equal to the full grid's.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

from .findings import Finding

__all__ = [
    "CoverageReport",
    "MAIN_PATH_SHAPES",
    "LAUNCH_ROUTES",
    "verify_spec",
    "unwritten_blocks",
    "short_grid",
    "coverage_shapes",
    "check_coverage",
    "launch_routes",
    "run",
]

# keep the evaluation bounded; the largest launch proven here (a
# split-k reduce of the LM head's 2048 x 49152 output) has 393216 units
MAX_GRID_POINTS = 1_000_000

# The main paths' shapes of PERF.md's kernel table, (m, n, k, g); for the
# attention op (queries, keys, head dim, slices).
MAIN_PATH_SHAPES: Tuple[Tuple[int, int, int, int], ...] = (
    (8, 49152, 576, 1),      # smollm's LM head at decode: NN, NT, the TNN transpose
    (2048, 49152, 576, 1),   # its training forward: the fused TNN
    (4, 8, 6144, 1),         # grok-1's router at decode: f32 skinny
    (1024, 8, 6144, 1),      # its router in training
    (2048, 2048, 2048, 1),   # f32 tiled NN
    (768, 256, 64, 24),      # BNT; training attention, causal
    (256, 64, 768, 24),      # BNN
    (3, 512, 64, 12),        # decode attention (split-KV)
    (2048, 1024, 256, 4),    # gemma3's prefill attention at d_head 256
    (1000, 1000, 112, 32),   # zamba2's attention at 112
    (2048, 512, 120, 16),    # h2o's attention at 120
)


@dataclass
class CoverageReport:
    findings: List[Finding] = field(default_factory=list)
    # every registered (candidate, op) pair seen
    pairs: List[Tuple[str, str]] = field(default_factory=list)
    # (candidate, op) pairs whose schedules were verified
    proven_pairs: List[Tuple[str, str]] = field(default_factory=list)
    # (candidate, op, shape, dtype, alignment, config[, transpose / mask]) cells
    cells: int = 0
    specs: int = 0  # launches verified


def _check_map_shape(
    bm, n_grid_axes: int, what: str
) -> Tuple[Optional[Tuple[int, ...]], Optional[str]]:
    """Probe an index map at the grid origin; KC314 detail on failure."""
    try:
        idx = bm.index_map(*([0] * n_grid_axes))
    except TypeError as exc:
        return None, f"{what} index map rejects {n_grid_axes} grid axes: {exc}"
    if not isinstance(idx, (tuple, list)):
        return None, f"{what} index map returned {type(idx).__name__}, not a tuple"
    if len(idx) != len(bm.block):
        return None, (
            f"{what} index map returned rank {len(idx)} for a "
            f"rank-{len(bm.block)} block"
        )
    if len(bm.block) != len(bm.extent):
        return None, (
            f"{what} block rank {len(bm.block)} != extent rank {len(bm.extent)}"
        )
    return tuple(idx), None


def _evaluate(bm, coords: np.ndarray) -> np.ndarray:
    """The map at every grid point: (rank, points) int64.  ``coords`` is
    (axes, points), the points in row-major order."""
    total = coords.shape[1]
    try:
        idx = bm.index_map(*coords)
        out = np.stack([np.broadcast_to(np.asarray(v, dtype=np.int64), (total,))
                        for v in idx])
        if out.shape == (len(bm.block), total):
            return out
    except Exception:  # a map over ints only: evaluate it point by point
        pass
    rows = [tuple(bm.index_map(*(int(c) for c in coords[:, p]))) for p in range(total)]
    return np.asarray(rows, dtype=np.int64).reshape(total, len(bm.block)).T


def _linear(idx: np.ndarray) -> np.ndarray:
    """One int64 id per column of ``idx`` (any ints), equal iff the columns
    are."""
    lo = idx.min(axis=1, keepdims=True)
    dims = tuple(int(d) for d in (idx.max(axis=1) - lo[:, 0] + 1))
    return np.ravel_multi_index(tuple(idx - lo), dims)


def _pt(coords: np.ndarray, p: int) -> Tuple[int, ...]:
    return tuple(int(c) for c in coords[:, p])


def _launch_problem(spec) -> Optional[str]:
    from repro_torch.kernels.gridspec import launch_error

    launch = tuple(spec.launch)
    programs = getattr(spec, "programs", None)
    if programs is not None:
        want = (int(programs), 1, 1)
        what = f"persistent launch of {programs} programs"
    else:
        want = tuple(spec.grid) + (1,) * (3 - len(spec.grid))
        what = f"grid {tuple(spec.grid)}"
    if len(launch) != 3 or launch != want:
        return f"launch {launch} is not the {what}: {want}"
    if programs is not None and programs < 1:
        return f"persistent launch of {programs} programs"
    err = launch_error(spec)
    return None if err is None else f"launch {launch}: {err}"


def _units_problems(spec, total: int) -> List[Tuple[str, str]]:
    """KC310/KC311 for the strided walk of a persistent grid's programs:
    program p visits the units p, p + programs, ... below ``total``."""
    programs = int(spec.launch[0])
    if programs < 1:
        return []
    pids = np.arange(programs, dtype=np.int64)
    steps = np.maximum(0, -(-(total - pids) // programs))  # units each program visits
    starts = np.repeat(pids, steps)
    j = np.arange(len(starts), dtype=np.int64) - np.repeat(np.cumsum(steps) - steps, steps)
    visits = np.bincount(starts + programs * j, minlength=total)
    problems = []
    if (visits == 0).any():
        u = int(np.argmax(visits == 0))
        problems.append(("KC310", f"unit {u} of {total} is never visited by the strided walk "
                                  f"of {programs} programs"))
    if (visits > 1).any():
        u = int(np.argmax(visits > 1))
        problems.append(("KC311", f"unit {u} of {total} is visited {int(visits[u])} times by "
                                  f"the strided walk of {programs} programs"))
    return problems


def verify_spec(spec) -> List[Tuple[str, str]]:
    """Verify one ``KernelGridSpec`` (the port's, or the JAX package's).

    Returns ``(rule, detail)`` tuples -- at most one per rule (one per
    operand for KC312), each with a concrete witness (the first offending
    grid point or block in row-major order) so a failure is reproducible
    by hand.
    """
    problems: List[Tuple[str, str]] = []
    n_axes = len(spec.grid)

    # KC314: arity/rank probes first -- the other checks evaluate the maps
    operands = [(f"operand[{i}]", s) for i, s in enumerate(spec.in_specs)]
    operands.append(("output", spec.out_spec))
    bad_maps = set()
    for what, bm in operands:
        _, err = _check_map_shape(bm, n_axes, what)
        if err is not None:
            problems.append(("KC314", err))
            bad_maps.add(what)
    if any(a < 0 or a >= n_axes for a in spec.sequential):
        problems.append(
            ("KC314", f"sequential axes {spec.sequential} outside grid rank {n_axes}")
        )
        return problems

    total = 1
    for e in spec.grid:
        total *= max(int(e), 0)
    if total == 0 or total > MAX_GRID_POINTS:
        problems.append(
            ("KC314", f"grid {spec.grid} has {total} points; cannot verify")
        )
        return problems

    out = spec.out_spec
    parallel_axes = [a for a in range(n_axes) if a not in spec.sequential]
    launch = getattr(spec, "launch", None)
    persistent = getattr(spec, "programs", None) is not None

    # KC313: parallel grid extent vs cdiv(extent, block) over the output
    # axes, and the launch against the grid and CUDA's limits
    if "output" not in bad_maps:
        expected_blocks = 1
        for blk, ext in zip(out.block, out.extent):
            expected_blocks *= -(-ext // blk)  # cdiv
        n_parallel = 1
        for a in parallel_axes:
            n_parallel *= spec.grid[a]
        if n_parallel != expected_blocks:
            problems.append(
                (
                    "KC313",
                    f"parallel grid extent {n_parallel} != "
                    f"cdiv(out extent {out.extent}, block {out.block}) "
                    f"= {expected_blocks} output blocks",
                )
            )
    if launch is not None:
        err = _launch_problem(spec)
        if err is not None:
            problems.append(("KC313", err))
    if persistent and launch is not None:
        problems.extend(_units_problems(spec, total))

    coords = np.indices(tuple(int(e) for e in spec.grid)).reshape(n_axes, total)
    for what, bm in operands:
        if what in bad_maps:
            continue
        idx = _evaluate(bm, coords)
        blk = np.asarray(bm.block, dtype=np.int64)[:, None]
        ext = np.asarray(bm.extent, dtype=np.int64)[:, None]
        start = idx * blk
        outside = (start < 0) | (start >= ext)
        if outside.any():
            p = int(np.argmax(outside.any(axis=0)))
            axis = int(np.argmax(outside[:, p]))
            problems.append(
                (
                    "KC312",
                    f"{what} map at grid point {_pt(coords, p)} addresses block "
                    f"{_pt(idx, p)} -> axis {axis} start {int(start[axis, p])} outside "
                    f"[0, {int(ext[axis, 0])})",
                )
            )
        if what != "output":
            continue
        # KC311: the first point whose block a point differing on a
        # parallel axis wrote first; the writes up to it count for KC310
        out_id = _linear(idx)
        if parallel_axes:
            pshape = tuple(int(spec.grid[a]) for a in parallel_axes)
            p_id = np.ravel_multi_index(tuple(coords[parallel_axes]), pshape)
        else:
            p_id = np.zeros(total, dtype=np.int64)
        upto = total
        if not spec.sequential:  # every point parallel: a clash is a repeated block
            srt = np.sort(out_id)
            if (srt[1:] != srt[:-1]).all():
                out_id = None
        if out_id is not None:
            _, first, inverse = np.unique(out_id, return_index=True, return_inverse=True)
            first_of = first[inverse.reshape(-1)]
            clash = p_id != p_id[first_of]
        if out_id is not None and clash.any():
            p = int(np.argmax(clash))
            prev = tuple(int(coords[a, first_of[p]]) for a in parallel_axes)
            cur = tuple(int(coords[a, p]) for a in parallel_axes)
            problems.append(
                (
                    "KC311",
                    f"output block {_pt(idx, p)} written by parallel grid "
                    f"points {prev} and {cur}: racy double-write",
                )
            )
            upto = p
        missing = _missing(out, idx[:, :upto])
        if missing is not None:
            counts = tuple(-(-e // b) for b, e in zip(out.block, out.extent))
            problems.append(
                (
                    "KC310",
                    f"output block {missing} (of {counts}) is never written: coverage gap",
                )
            )
    return problems


def _missing(out, idx: np.ndarray, first: bool = True):
    """The first output block (row-major) no column of ``idx`` writes, or
    None; ``first=False``: all of them."""
    counts = tuple(-(-e // b) for b, e in zip(out.block, out.extent))
    n_blocks = 1
    for c in counts:
        n_blocks *= c
    if n_blocks == 0:
        return None if first else []
    inside = np.all((idx >= 0) & (idx < np.asarray(counts, dtype=np.int64)[:, None]), axis=0)
    written = np.zeros(n_blocks, dtype=bool)
    if inside.any():
        written[np.ravel_multi_index(tuple(idx[:, inside]), counts)] = True
    if first:
        if written.all():
            return None
        return tuple(int(i) for i in np.unravel_index(int(np.argmin(written)), counts))
    return [tuple(int(i) for i in np.unravel_index(int(b), counts))
            for b in np.flatnonzero(~written)]


def unwritten_blocks(spec) -> List[Tuple[int, ...]]:
    """Every output block of ``spec`` that no grid point writes, in
    row-major order (a spec whose output map is well formed)."""
    n_axes = len(spec.grid)
    total = 1
    for e in spec.grid:
        total *= int(e)
    coords = np.indices(tuple(int(e) for e in spec.grid)).reshape(n_axes, total)
    return _missing(spec.out_spec, _evaluate(spec.out_spec, coords), first=False)


def coverage_shapes() -> Tuple[Tuple[int, int, int, int], ...]:
    """The (m, n, k, g) cells: the contract pass's ragged grid, the
    sanitizer's route shapes (which reach the fast routes the ragged grid
    does not) and the main paths' shapes."""
    from .contracts import SHAPE_GRID
    from .sanitize import ROUTE_SHAPES

    return tuple(SHAPE_GRID) + tuple(ROUTE_SHAPES) + MAIN_PATH_SHAPES


def _extras(name: str, m: int, n: int, k: int, g: int, dsize: int, aligned: bool,
            first: bool):
    """The spec functions' arguments beyond the plan a cell also proves: at the
    route's first plan, every transpose instance of the two-kernel arms;
    on the flash routes, the attention kernel's row orders (in order;
    causal over one segment; causal over segments of 64 and 128 rows,
    which whole flash blocks tile where they divide m, and of m / 3)."""
    from repro_torch.kernels.attention_fused import MaskParams, attention_variant
    from repro_torch.kernels.gridspec import _dtype
    from repro_torch.kernels.transpose import TRANSPOSE_INSTANCES

    if name in ("PALLAS_TNN", "PALLAS_TN") and first:
        return [{"tblock": t} for t in TRANSPOSE_INSTANCES]
    if (name == "FUSED_ATTN"
            and attention_variant(_dtype(dsize), g, m, n, k, aligned).startswith("flash")):
        return [{"mask": MaskParams()}, {"mask": MaskParams(causal=True)},
                {"mask": MaskParams(causal=True, q_seg=64)},
                {"mask": MaskParams(causal=True, q_seg=128)},
                {"mask": MaskParams(causal=True, q_seg=max(1, m // 3))}]
    return [{}]


def check_coverage(
    shapes: Optional[Sequence[Tuple[int, int, int, int]]] = None,
    repo_root: Optional[str] = None,
    dsizes: Iterable[int] = (4, 2),
    sms: Optional[int] = None,
    alignments: Iterable[bool] = (True, False),
) -> CoverageReport:
    """Verify every launch of every tunable (candidate, op) pair at every
    plan of its route, on ``sms`` SMs (None: an H100's 132)."""
    from repro_torch.core.candidates import CANDIDATES
    from repro_torch.core.opkey import GROUPED_OPS
    from repro_torch.kernels.common import H100_SMS, config_key
    from repro_torch.kernels.gridspec import GRID_SPEC_BUILDERS, candidate_grid_specs
    from repro_torch.kernels.tiling import tile_plans

    from .contracts import _candidate_location

    if shapes is None:
        shapes = coverage_shapes()
    if sms is None:
        sms = H100_SMS
    dsizes, alignments = tuple(dsizes), tuple(alignments)

    report = CoverageReport()
    for name, cand in sorted(CANDIDATES.items()):
        path, line = _candidate_location(cand, repo_root)
        for op in cand.ops:
            report.pairs.append((name, op))
            if not cand.tunable:
                continue  # a library call: no launch of the port's to verify
            if name not in GRID_SPEC_BUILDERS:
                report.findings.append(
                    Finding(
                        rule="KC315",
                        path=path,
                        line=line,
                        message=(
                            f"tunable candidate {name} has no grid-spec "
                            "function in kernels/gridspec.py; its schedule "
                            "cannot be verified"
                        ),
                        context=f"gridspec:{name}:{op}",
                    )
                )
                continue
            pair_clean = True
            for m, n, k, g in shapes:
                gg = g if op in GROUPED_OPS else 1
                for dsize in dsizes:
                    for aligned in alignments:
                        try:
                            configs = ([c for c, _ in tile_plans(cand.kernel, m, n, k, dsize, gg,
                                                                 aligned, sms)]
                                       if cand.kernel is not None else [None])
                        except Exception:
                            configs = [None]  # the spec function's failure below names it
                        for c, cfg in enumerate(configs):
                            extras = _extras(name, m, n, k, gg, dsize, aligned, c == 0)
                            for i, extra in enumerate(extras):
                                cell = (f"{op}:{m}x{n}x{k}x{gg}:{dsize}:"
                                        f"{'aligned' if aligned else 'offset'}:"
                                        f"{config_key(cfg)}" + (f":{i}" if i else ""))
                                report.cells += 1
                                try:
                                    specs = candidate_grid_specs(
                                        name, op, m, n, k, g=gg, block=cfg, dsize=dsize,
                                        aligned=aligned, sms=sms, **extra)
                                except Exception as exc:
                                    pair_clean = False
                                    report.findings.append(
                                        Finding(
                                            rule="KC314",
                                            path=path,
                                            line=line,
                                            message=(f"{name} grid-spec function failed at "
                                                     f"{cell}: {exc}"),
                                            context=f"coverage:{name}:{cell}:spec",
                                        )
                                    )
                                    continue
                                for spec in specs:
                                    report.specs += 1
                                    for rule, detail in verify_spec(spec):
                                        pair_clean = False
                                        report.findings.append(
                                            Finding(
                                                rule=rule,
                                                path=path,
                                                line=line,
                                                message=(f"{name} schedule {spec.name} at "
                                                         f"{cell}: {detail}"),
                                                context=(f"coverage:{name}:{cell}:"
                                                         f"{spec.name}:{rule}"),
                                            )
                                        )
            if pair_clean:
                report.proven_pairs.append((name, op))
    return report


def short_grid(spec):
    """``spec`` with one block fewer on the grid axis that walks the
    output's slowest axis (its first, or the next where that axis has one
    block): a seeded defect the proof and the card must both see."""
    import dataclasses

    n_axes = len(spec.grid)
    origin = tuple(spec.out_spec.index_map(*([0] * n_axes)))
    for d in range(len(origin)):
        for a in reversed(range(n_axes)):
            step = [0] * n_axes
            step[a] = 1
            if spec.grid[a] >= 2 and spec.out_spec.index_map(*step)[d] != origin[d]:
                grid = tuple(e - (i == a) for i, e in enumerate(spec.grid))
                return dataclasses.replace(spec, grid=grid, launch=grid)
    raise ValueError(f"{spec.name}: no output axis of two blocks or more to shorten")


# The card's launches, one per route: (route, wrapper module, its spec
# function, candidate (or the transpose kernel), op, (m, n, k, g), dtype,
# persistent).  Shapes from the sanitizer's route cells and the JAX
# package's ragged cell, each the first that reaches its route.
LAUNCH_ROUTES = (
    ("transpose", "transpose", "transpose_grid_spec", "transpose", "T", (200, 136, 72, 1),
     "bfloat16", False),
    ("nt_bf16", "matmul_nt", "nt_grid_specs", "PALLAS_NT", "NT", (12, 296, 64, 1),
     "bfloat16", False),
    ("gemm_f32 skinny", "matmul_nt", "nt_grid_specs", "PALLAS_NT", "NT", (12, 296, 64, 1),
     "float32", False),
    ("gemm_f32 tiled", "matmul_nn", "nn_grid_specs", "PALLAS_NN", "NN", (200, 136, 72, 1),
     "float32", False),
    ("matmul_fma", "matmul_nt", "nt_grid_specs", "PALLAS_NT", "NT", (129, 127, 65, 1),
     "float32", False),
    ("nn_skinny", "matmul_nn", "nn_grid_specs", "PALLAS_NN", "NN", (12, 296, 64, 1),
     "bfloat16", False),
    ("nn_wgmma", "matmul_nn", "nn_grid_specs", "PALLAS_NN", "NN", (200, 136, 72, 1),
     "bfloat16", True),
    ("tnn_fused_wgmma", "matmul_tnn_fused", "tnn_fused_grid_specs", "PALLAS_TNN_FUSED", "NT",
     (200, 136, 72, 1), "bfloat16", True),
    ("tnn_fused_bf16", "matmul_tnn_fused", "tnn_fused_grid_specs", "PALLAS_TNN_FUSED", "NT",
     (129, 127, 65, 1), "bfloat16", False),
    ("tnn_fused_fma", "matmul_tnn_fused", "tnn_fused_grid_specs", "PALLAS_TNN_FUSED", "NT",
     (129, 127, 65, 1), "float32", False),
    ("tnn_fused_f32 tiled", "matmul_tnn_fused", "tnn_fused_grid_specs", "PALLAS_TNN_FUSED",
     "NT", (200, 136, 72, 1), "float32", False),
    ("tnn_fused_f32 skinny", "matmul_tnn_fused", "tnn_fused_grid_specs", "PALLAS_TNN_FUSED",
     "NT", (12, 296, 64, 1), "float32", False),
    ("bmm_f32", "matmul_batched", "batched_grid_specs", "PALLAS_BNT", "BNT", (200, 136, 72, 3),
     "float32", False),
    ("bmm_bf16", "matmul_batched", "batched_grid_specs", "PALLAS_BNN", "BNN", (200, 136, 72, 3),
     "bfloat16", False),
    ("batched_fma", "matmul_batched", "batched_grid_specs", "PALLAS_BNT", "BNT",
     (129, 127, 65, 3), "float32", False),
    ("attention_decode_split", "attention_fused", "attention_grid_specs", "FUSED_ATTN", "ATTN",
     (12, 296, 64, 2), "bfloat16", False),
    ("attention_flash", "attention_fused", "attention_grid_specs", "FUSED_ATTN", "ATTN",
     (129, 127, 64, 3), "bfloat16", False),
    ("attention_flash_f32", "attention_fused", "attention_grid_specs", "FUSED_ATTN", "ATTN",
     (129, 127, 64, 3), "float32", False),
    ("attention_fma", "attention_fused", "attention_grid_specs", "FUSED_ATTN", "ATTN",
     (129, 127, 65, 3), "float32", False),
)


def _single_split_config(kernel: str, m: int, n: int, k: int, dsize: int, g: int, sms: int):
    """A config of ``kernel`` whose plan does not split (its first spec
    writes the output), or None for the transpose."""
    from repro_torch.kernels.tiling import tile_plans

    if kernel is None:
        return None
    for cfg, plan in tile_plans(kernel, m, n, k, dsize, g, True, sms):
        splits = plan[1] if kernel == "attention_fused" else plan[2]
        if splits == 1:
            return cfg
    raise ValueError(f"{kernel} has no unsplit plan at ({m}, {n}, {k}, {g})")


def launch_routes(device, sms: int, routes=LAUNCH_ROUTES, short: bool = True) -> List[dict]:
    """Launch every route of ``routes`` on the card ``device`` from its
    spec (see the module doc); with ``short``, also each non-persistent
    route on a grid one block short.  One row per route: the checks'
    results and ``ok``."""
    import importlib

    import torch

    from repro_torch.core.candidates import CANDIDATES
    from repro_torch.kernels import transpose as tmod

    from . import sanitize

    dev = torch.device(device)
    rows = []
    for label, module, fn_name, name, op, (m, n, k, g), dtype_name, persistent in routes:
        mod = importlib.import_module(f"repro_torch.kernels.{module}")
        dt = getattr(torch, dtype_name)
        dsize = torch.finfo(dt).bits // 8
        gen = torch.Generator().manual_seed(sanitize._SEED)
        values = [(torch.randn(sh, generator=gen) * 0.5).to(dt)
                  for sh in sanitize._operand_shapes(op, m, n, k, g)]
        if name == "transpose":
            kernel = None
            run = lambda *xs, config: tmod.transpose(*xs, block=config)  # noqa: E731
        else:
            kernel = CANDIDATES[name].kernel
            run = lambda *xs, config, _c=CANDIDATES[name]: _c.run(*xs, config=config)  # noqa: E731
        row = {"route": label, "shape": [m, n, k, g], "dtype": dtype_name, "persistent": persistent}

        def poisoned(cfg):
            """The route on poisoned output memory: (output, allocations
            back poisoned, allocations)."""
            xs = sanitize._placed(torch, values, 0.0, dev)
            _, allocs = sanitize._recorded(torch, lambda *a: run(*a, config=cfg), xs)
            torch.cuda.synchronize(dev)
            ranges = sanitize._replayed(torch, [nb for _, nb in allocs], sanitize._NAN_BYTE, dev)
            out, allocs = sanitize._recorded(torch, lambda *a: run(*a, config=cfg), xs)
            torch.cuda.synchronize(dev)
            back = sum(any(lo <= p and p + nb <= hi for lo, hi in ranges) for p, nb in allocs)
            return out.cpu(), back, len(allocs)

        want = sanitize._oracle(torch, op, values)
        rtol, atol = (0.0, 0.0) if op == "T" else sanitize._tol(dtype_name, k)
        out, back, n_allocs = poisoned(None)
        g64 = out.double()
        row["written"] = bool(torch.isfinite(g64).all())
        row["allocations_poisoned"] = f"{back}/{n_allocs}"
        row["max_abs_err"] = float((g64 - want).abs().max()) if out.numel() else 0.0
        row["matches"] = bool((g64 - want).abs().le(atol + rtol * want.abs()).all())
        ok = row["written"] and row["matches"] and back == n_allocs
        if short and not persistent:
            cfg = _single_split_config(kernel, m, n, k, dsize, g, sms)
            full, _, _ = poisoned(cfg)
            orig = getattr(mod, fn_name)
            seeded = {}

            def shortened(*args, **kw):
                specs = orig(*args, **kw)
                one = not isinstance(specs, tuple)
                first = short_grid(specs if one else specs[0])
                seeded["spec"] = first
                return first if one else (first,) + tuple(specs[1:])

            setattr(mod, fn_name, shortened)
            try:
                got, _, _ = poisoned(cfg)
            finally:
                setattr(mod, fn_name, orig)
            spec = seeded["spec"]
            missing = unwritten_blocks(spec)
            rules = dict(verify_spec(spec))
            named = bool(missing) and str(missing[0]) in rules.get("KC310", "")
            mask = torch.zeros(tuple(spec.out_spec.extent), dtype=torch.bool)
            for blk in missing:
                mask[tuple(slice(b * e, (b + 1) * e) for b, e in zip(blk, spec.out_spec.block))] = True
            mask = mask.reshape(got.shape)
            bits, full_bits = sanitize._bits(torch, got), sanitize._bits(torch, full)
            poison = int(torch.full((), -1, dtype=bits.dtype))
            row["short"] = {
                "grid": list(spec.launch), "config": cfg, "missing_blocks": len(missing),
                "first_missing": list(missing[0]) if missing else None,
                "proof_rules": sorted(rules), "proof_names_block": named,
                "poisoned_exactly": bool((bits[mask] == poison).all())
                and bool((bits[~mask] == full_bits[~mask]).all()),
                "poisoned_elements": int((bits == poison).sum()), "mask_elements": int(mask.sum()),
            }
            ok = (ok and {"KC313", "KC310"} <= set(rules) and named
                  and row["short"]["poisoned_exactly"] and bool(missing))
        row["ok"] = ok
        rows.append(row)
    return rows


def run(repo_root: Optional[str] = None, cache=None) -> List[Finding]:
    """The lint CLI's entry point (the source cache is unused: this pass
    evaluates the specs, it reads no source)."""
    return check_coverage(repo_root=repo_root).findings
