"""Poison sanitizer (NM404): no kernel reads memory it was not given.

The static passes prove the plans (contracts) and the accumulation types
(numerics), but neither can prove that a kernel never reads outside its
operands, nor that it never reads the output or workspace memory it
allocated before writing it.  This mode proves both empirically, the way
MSan proves uninitialised reads.  The JAX package poisons the padding
its Pallas kernels are handed; a CUDA kernel here is handed no padding,
so the poison goes where a stray read would land:

  * each operand is a contiguous view at a 256-byte offset inside a larger
    buffer (the route's 16-byte alignment holds), and the buffer's head
    and tail are filled with a poison value (NaN, +inf, -inf): a read
    past the view's first or last element reads poison;
  * on the card, the output and workspace allocations a wrapper makes
    (``torch.empty`` of C, of the split partials, of the transpose's
    B^T) are replayed before the run: blocks of the same sizes, in the
    same order, are allocated, filled with 0xFF bytes (NaN in f32 and
    bf16) and freed in reverse, so that the caching allocator hands the
    wrapper exactly that memory back.  Every allocation of the run is
    then checked to lie inside a poisoned block, so the check is not
    hollow: a cell whose allocations did not come back poisoned is a
    finding too.

Each cell (candidate, op, shape, dtype, plan) runs on the poisoned
buffers and on an identical zero-filled twin (operand padding and
replayed allocations zero).  The logical output must be bit-identical
between the two runs -- one poisoned value anywhere in a reduction turns
its element into NaN or inf, so equality is a leak-proof oracle -- and
finite, and within ``tests/test_kernels.py::_tol`` of the f64 version
of the op.  The oracle also catches a read that runs past a row into the
next row's real data.  The attention ops keep the key extent logical, as
the JAX package does: keys are masked by ``lengths``, never padded.

Every plan of ``kernels/tiling.py`` runs (each tunable candidate's
kernel's ``tile_plans``, and the transpose kernel's instances), at the
JAX package's ragged shapes and at ``ROUTE_SHAPES``, ragged shapes whose
operands meet the alignment of the port's fast routes (``wgmma``,
``gemm_f32``, the split-KV and flash attention kernels): the JAX
package's shapes send most ops down the unaligned FMA kernels.

On the CPU the same harness runs the plain routes, where a stray read has
no padding to find (and no allocator replay): it is a lint mode (``lint
--sanitize``) and a test that the harness fires on a seeded leak.  On the
card it is a ``gpu``-marked test and a phase of ``chip_smoke.py``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple

from .findings import Finding

__all__ = ["SanitizeReport", "DEFAULT_SHAPES", "FULL_SHAPES", "ROUTE_SHAPES",
           "DEFAULT_POISONS", "grid", "sanitize_candidates", "run"]

# one ragged cell of the JAX package: every axis off every tile edge
DEFAULT_SHAPES: Tuple[Tuple[int, int, int, int], ...] = ((129, 127, 65, 3),)
# its full grid adds a second ragged cell with a different alignment
# profile (m under one tile, n spanning several, tiny k)
FULL_SHAPES: Tuple[Tuple[int, int, int, int], ...] = DEFAULT_SHAPES + ((63, 300, 33, 2),)
# ragged cells whose extents meet the fast routes' alignment: f32 tiled,
# bf16 NN/fused-TNN wgmma and batched mma (m > 64, n % 8 == 0, k % 8 ==
# 0); skinny f32, the NN skinny kernel and the split-KV attention kernel
# (m <= 16, 296 keys in many splits); the flash kernels at d_head 64
# over 127 keys
ROUTE_SHAPES: Tuple[Tuple[int, int, int, int], ...] = (
    (200, 136, 72, 3),
    (12, 296, 64, 2),
    (129, 127, 64, 3),
)
DEFAULT_POISONS: Tuple[str, ...] = ("nan", "+inf", "-inf")
_POISON_VALUES = {"nan": float("nan"), "+inf": float("inf"), "-inf": float("-inf")}
_OFFSET_BYTES = 256  # each operand's head of poison; its tail is as long
_NAN_BYTE = 0xFF  # every byte 0xFF: NaN in f32 and in bf16
_SEED = 20260809
_TRANSPOSE = "transpose"  # the kernel reached only through the two-kernel arms


def grid(full: bool = False) -> Tuple[Tuple[int, int, int, int], ...]:
    """The shapes a run covers: the JAX package's ragged cells (``full``:
    both) and ``ROUTE_SHAPES``."""
    return (FULL_SHAPES if full else DEFAULT_SHAPES) + ROUTE_SHAPES


@dataclass
class SanitizeReport:
    findings: List[Finding] = field(default_factory=list)
    pairs: List[Tuple[str, str]] = field(default_factory=list)
    cells: int = 0  # (candidate, op, shape, dtype, plan) cells
    runs: int = 0  # launches of a cell's subject, zero-filled and poisoned
    poisons: Tuple[str, ...] = ()
    allocations: int = 0  # output/workspace allocations checked to come back poisoned
    unpoisoned: int = 0  # ... that did not
    seconds: float = 0.0
    device: str = "cpu"

    @property
    def leaks(self) -> int:
        """Cells and poisons whose poison reached the logical output."""
        return sum(1 for f in self.findings
                   if f.context.rsplit(":", 1)[-1] in self.poisons)


@dataclass(frozen=True)
class _Subject:
    name: str
    op: str  # an OpKey op, or "T" for the transpose kernel
    run: Callable  # run(*operands, config) -> output
    configs: Callable  # configs(m, n, k, dsize, g) -> the plans' configs, or [None]
    path: str
    line: int
    kernel_arm: bool  # launches a CUDA kernel on the card (not a library call)


def _subjects(candidates: Optional[Sequence[str]], repo_root: Optional[str]) -> List[_Subject]:
    from repro_torch.core.candidates import CANDIDATES
    from repro_torch.kernels import tiling, transpose

    from .contracts import _candidate_location, _fn_location

    out = []
    for name, cand in sorted(CANDIDATES.items()):
        if candidates is not None and name not in candidates:
            continue
        path, line = _candidate_location(cand, repo_root)
        if cand.tunable and cand.kernel is not None:
            def configs(m, n, k, dsize, g, _kern=cand.kernel):
                return [c for c, _ in tiling.tile_plans(_kern, m, n, k, dsize, g)]
        else:
            def configs(m, n, k, dsize, g):
                return [None]
        for op in cand.ops:
            out.append(_Subject(name, op, lambda *xs, config, _c=cand: _c.run(*xs, config=config),
                                configs, path, line, cand.kernel is not None))
    if candidates is None or _TRANSPOSE in candidates:
        path, line = _fn_location(transpose.transpose, repo_root)
        out.append(_Subject(_TRANSPOSE, "T",
                            lambda b, config: transpose.transpose(b, block=config),
                            lambda m, n, k, dsize, g: list(tiling.TRANSPOSE_INSTANCES),
                            path, line, True))
    return out


def _operand_shapes(op: str, m: int, n: int, k: int, g: int):
    from repro_torch.core.measure import operand_shapes

    return ((n, k),) if op == "T" else operand_shapes(op, m, n, k, g)


def _oracle(torch, op: str, xs):
    """The op in f64 on the operands' values (CPU tensors)."""
    x = [t.double() for t in xs]
    if op == "T":
        return x[0].t()
    if op == "NT":
        return x[0] @ x[1].t()
    if op == "NN":
        return x[0] @ x[1]
    if op == "TN":
        return x[0].t() @ x[1]
    if op == "BNT":
        return torch.bmm(x[0], x[1].transpose(1, 2))
    if op == "BNN":
        return torch.bmm(x[0], x[1])
    if op == "ATTN":
        p = torch.softmax(torch.bmm(x[0], x[1].transpose(1, 2)), dim=-1)
        return torch.bmm(p, x[2])
    raise ValueError(f"unknown op {op!r}")


def _tol(dtype_name: str, k: int) -> Tuple[float, float]:
    """tests/test_kernels.py::_tol: (rtol, atol) for a k-deep reduction."""
    r = 1e-5 if dtype_name == "float32" else 2e-2
    return r, r * max(1.0, k ** 0.5)


def _placed(torch, values, fill: float, device):
    """Each of ``values`` (CPU tensors) as a contiguous view at a 256-byte
    offset inside a buffer on ``device`` whose head and tail hold
    ``fill``."""
    views = []
    for v in values:
        pad = _OFFSET_BYTES // v.element_size()
        buf = torch.full((pad + v.numel() + pad,), fill, dtype=v.dtype, device=device)
        view = buf[pad:pad + v.numel()].view(v.shape)
        view.copy_(v)
        views.append(view)
    return views


def _recorded(torch, fn, args):
    """``fn(*args)`` and the (address, bytes) of each CUDA storage it
    allocated, in order."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    known = {a.untyped_storage().data_ptr() for a in args}
    allocs: List[Tuple[int, int]] = []

    class _Spy(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, fargs=(), kwargs=None):
            out = func(*fargs, **(kwargs or {}))
            for t in tree_flatten(out)[0]:
                if isinstance(t, torch.Tensor) and t.device.type == "cuda":
                    st = t.untyped_storage()
                    if st.nbytes() and st.data_ptr() not in known:
                        known.add(st.data_ptr())
                        allocs.append((st.data_ptr(), st.nbytes()))
            return out

    with _Spy():
        out = fn(*args)
    return out, allocs


def _replayed(torch, sizes: Sequence[int], byte: int, device) -> List[Tuple[int, int]]:
    """Allocate blocks of ``sizes`` in order, fill them with ``byte`` and
    free them in reverse: the caching allocator's free lists are then as
    before, so the same requests get these blocks back.  Returns their
    address ranges."""
    blocks = [torch.empty(s, dtype=torch.uint8, device=device) for s in sizes]
    for b in blocks:
        b.fill_(byte)
    ranges = [(b.data_ptr(), b.data_ptr() + b.numel()) for b in blocks]
    while blocks:
        blocks.pop()
    return ranges


def _bits(torch, t):
    return t.contiguous().view(torch.int16 if t.element_size() == 2 else torch.int32)


def sanitize_candidates(
    shapes: Sequence[Tuple[int, int, int, int]] = DEFAULT_SHAPES + ROUTE_SHAPES,
    dtypes: Sequence[str] = ("float32", "bfloat16"),
    poisons: Sequence[str] = DEFAULT_POISONS,
    repo_root: Optional[str] = None,
    candidates: Optional[Sequence[str]] = None,
    device: str = "cpu",
) -> SanitizeReport:
    """Run every plan of every selected candidate (and of the transpose
    kernel) on poisoned and zero-filled memory; see the module doc."""
    import torch

    from repro_torch.core.opkey import GROUPED_OPS
    from repro_torch.kernels.common import config_key

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    report = SanitizeReport(poisons=tuple(poisons), device=str(dev))
    t0 = time.perf_counter()
    for subj in _subjects(candidates, repo_root):
        report.pairs.append((subj.name, subj.op))

        def add(cell, message, what):
            report.findings.append(Finding(rule="NM404", path=subj.path, line=subj.line,
                                           message=f"{cell}: {message}",
                                           context=f"sanitize:{cell}:{what}"))

        for m, n, k, g in shapes:
            gg = g if subj.op in GROUPED_OPS else 1
            shapes_ = _operand_shapes(subj.op, m, n, k, gg)
            for dtype_name in dtypes:
                dt = getattr(torch, dtype_name)
                gen = torch.Generator().manual_seed(_SEED)
                values = [(torch.randn(s, generator=gen) * 0.5).to(dt) for s in shapes_]
                want = _oracle(torch, subj.op, values)
                rtol, atol = _tol(dtype_name, k)
                if subj.op == "T":
                    rtol = atol = 0.0
                dsize = torch.finfo(dt).bits // 8
                for cfg in subj.configs(m, n, k, dsize, gg):
                    cell = (f"{subj.name}:{subj.op}:{m}x{n}x{k}x{gg}:{dtype_name}:"
                            f"{config_key(cfg)}")
                    report.cells += 1

                    def launch(fill: float, byte: int, sizes):
                        xs = _placed(torch, values, fill, dev)
                        if not on_card:
                            return subj.run(*xs, config=cfg), None
                        torch.cuda.synchronize(dev)
                        ranges = _replayed(torch, sizes, byte, dev)
                        out, allocs = _recorded(torch, lambda *a: subj.run(*a, config=cfg),
                                                xs)
                        torch.cuda.synchronize(dev)
                        poisoned = [any(lo <= p and p + nb <= hi for lo, hi in ranges)
                                    for p, nb in allocs]
                        return out, (len(allocs), sum(poisoned))

                    try:
                        sizes = []
                        if on_card:  # a zero-filled run that only records the allocations
                            _, allocs = _recorded(
                                torch, lambda *a: subj.run(*a, config=cfg),
                                _placed(torch, values, 0.0, dev))
                            sizes = [nb for _, nb in allocs]
                        out_z, _ = launch(0.0, 0, sizes)
                        report.runs += 1
                        got = out_z.cpu()
                    except Exception as exc:  # a plan that does not run is a finding
                        add(cell, f"raised {type(exc).__name__}: {exc}", "raise")
                        continue
                    if tuple(got.shape) != tuple(want.shape) or got.dtype != dt:
                        add(cell, f"returned {tuple(got.shape)}/{got.dtype}, the op gives "
                            f"{tuple(want.shape)}/{dtype_name}", "shape")
                        continue
                    g64 = got.double()
                    if not bool(torch.isfinite(g64).all()):
                        add(cell, "output is not finite on zero-filled memory", "finite")
                        continue
                    err = float((g64 - want).abs().max()) if got.numel() else 0.0
                    if not bool((g64 - want).abs().le(atol + rtol * want.abs()).all()):
                        add(cell, f"output deviates from the f64 oracle (max abs err {err:.3g}, "
                            f"rtol {rtol}, atol {atol:.3g})", "oracle")
                        continue
                    hollow = False
                    for plabel in poisons:
                        try:
                            out_p, counts = launch(_POISON_VALUES[plabel], _NAN_BYTE, sizes)
                            report.runs += 1
                        except Exception as exc:
                            add(cell, f"raised {type(exc).__name__} on {plabel}-poisoned "
                                f"memory: {exc}", f"{plabel}:raise")
                            continue
                        if counts is not None and subj.kernel_arm:
                            report.allocations += counts[0]
                            report.unpoisoned += counts[0] - counts[1]
                            hollow |= counts[1] != counts[0] or counts[0] != len(sizes)
                        bad = int((_bits(torch, out_p.cpu()) != _bits(torch, got)).sum())
                        if bad:
                            add(cell, f"{plabel}-poisoned memory leaked into the logical output "
                                f"({bad} elements differ from the zero-filled run)", plabel)
                    if hollow and subj.kernel_arm:
                        add(cell, "output/workspace allocations did not come back poisoned from "
                            "the allocator: the check proves nothing about them here",
                            "allocator")
    report.seconds = time.perf_counter() - t0
    return report


def run(repo_root: Optional[str] = None, full: bool = False) -> List[Finding]:
    """The ``lint --sanitize`` entry point: the plain routes on the CPU."""
    return sanitize_candidates(shapes=grid(full), repo_root=repo_root).findings
