"""NN matmul: C = A @ B, A:(m, k), B:(k, n) -- stage 2 of the paper's TNN,
every data gradient and stage 2 of every weight gradient.

Replaces the Pallas kernel ``repro/kernels/matmul_nn.py:77``.  On CUDA
tensors the wrapper launches one of three kernels, picked before the
launch by ``nn_plans`` from dtype, shape and the operands' alignment:

- ``wgmma`` (bf16, m > 64, k and n multiples of 8, A and B 16-byte
  aligned): ``csrc/matmul_nn.cu``, built for the training backward (bound
  by operations).  A persistent grid walks 128 x BN output tiles; TMA
  loads A K-major and B, stored (k, n), MN-major as 64-column boxes; two
  warpgroups run ``wgmma`` with the transpose-B immediate set.  BN (64,
  128, 192 or 256) and a split of k come from a cost model over waves on
  the card's SMs (``_wgmma_plan``); split k writes f32 partials that a
  second kernel sums in split order.
- ``skinny`` (bf16, m <= 64, the same alignment): ``csrc/matmul_nn.cu``'s
  swap-AB kernel for decode and short prefill (bound by the bytes of B):
  C^T = B^T . A^T on ``mma.sync``, B's (k, n) tiles read with
  ``ldmatrix.trans``, a ``cp.async`` ring, k split as the direct NT
  kernel splits it (``nt_split``).
- f32 (no TF32): ``csrc/matmul.cu``'s ``gemm_f32`` for aligned operands
  (k and n multiples of 4, A and B 16-byte aligned; ``f32_plans`` in
  ``common.py``), ``skinny`` where m <= 16 or n <= 64 and ``tiled`` above
  (the direct NT kernel's f32 routes, with B's (k, n) rows stored as they
  are): the f32 stage 2 of ``PALLAS_TNN`` and ``PALLAS_TN``.
- ``fma`` (f32 or bf16 operands the kernels above do not take): the NN
  instance of ``csrc/matmul.cu``'s FMA kernel.

Tile configs (``kernels/tiling.py``): ``nn_plans`` lists the plans of a
shape's route as (config, plan) pairs, the cost model's first, and
``block=None`` launches that one.  A config ``(bm, bn, bk)`` is, on
``wgmma``, (128, BN, bk) with BN one of the instances above and bk the k of
one split (the cost model's split, and 1, 2, 4, ... up to 32 splits); on
``skinny``, (MA, 128, bk) as the direct NT kernel's (``matmul_nt.py``);
on f32's ``tiled`` and ``skinny``, the route's tile and the k of a split
(``f32_plans``); on ``fma``, its one tile, ``fma_tile(m)``.  Any other
config -- a wgmma tile at an m the skinny kernel owns, a BN with no
instance, a split the route does not list -- raises, on both routes.

``nn_grid_specs`` declares each plan's launches (``kernels/gridspec.py``):
the ``wgmma`` kernel's persistent grid of (split, tile) units walked by
min(units, SMs) programs, the others' one block per output tile and split.

Each call counts one launch, split or not.  A launch that fails raises; no
variant stands in for another.  On CPU tensors the wrapper runs the plain
version in ``ref.py``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import _build, ref
from .common import (
    H100_SMS,
    cdiv,
    check_operand,
    count_launch,
    f32_grid_specs,
    f32_plans,
    fma_grid_spec,
    fma_tile,
    gemm_grid_specs,
    launch_matmul,
    launch_matmul_f32,
    pick_plan,
    reduce_programs,
    route,
    sm_count,
    split_choices,
    splitk_reduce_spec,
    validate_config,
)
from .gridspec import MAX_GRID_Y, MAX_UNITS, BlockMap, check_launch, persistent_spec
from .matmul_nt import nt_split, skinny_rows

__all__ = ["matmul_nn", "nn_plans", "nn_plan", "nn_grid_specs", "wgmma_tile_map"]

_SKINNY_M = 64  # csrc kMTile: the swap-AB kernel's A rows per block
_SKINNY_COLS = 128  # kCols: B columns per block
_SKINNY_MAX_M = MAX_GRID_Y * _SKINNY_M  # its gridDim.y walks further 64-row tiles
_WG_BM = 128  # csrc kWgBM: the wgmma variant's tile rows
_WG_BK = 64  # kWgBK: k per stage, the unit of a split
_MAX_SPLITS = 32
# The wgmma variant's tile widths (csrc launch_wgmma instances), widest
# first so that a tie picks the wider one, and the relative cost of a tile
# column at each: a narrow wgmma reads A from shared memory for few columns.
_WG_BN_COST = {256: 1.0, 192: 1.0, 128: 1.1, 64: 1.3}
# The cost model's time scales, in us on an H100: one column of a 128-row
# tile over one 64-deep k-block (16384 flop at ~65 % of one SM's share of
# the bf16 peak), and a split's overhead (the reduce's launch, and the f32
# partials' bytes at ~3 TB/s).
_US_PER_COL_KB = 0.0034
_US_REDUCE = 3.0
_PARTIAL_BYTES_PER_US = 3.0e6


def _bf16_route(m: int, n: int, k: int, aligned: bool) -> str:
    if not (aligned and k > 0 and k % 8 == 0 and n % 8 == 0):
        return "fma"
    return "skinny" if m <= _SKINNY_M else "wgmma"


@functools.lru_cache(maxsize=None)
def nn_plans(m: int, n: int, k: int, dtype: torch.dtype, aligned: bool = True,
             sms: int = H100_SMS):
    """The (config, plan) pairs of this shape's route (``aligned``: A and
    B 16-byte aligned), the cost model's first.  A plan is ``(variant, BN,
    splits, k-blocks per split)``: ``("wgmma", BN, s, per)``, ``("skinny",
    None, s, per)`` or ``("fma", None, 1, 1)`` in bf16, a split a run of
    64-deep k-blocks, none empty; in f32 those of ``f32_plans``."""
    if dtype == torch.float32:
        return f32_plans(m, n, k, False, aligned, sms)
    variant = _bf16_route(m, n, k, aligned)
    if variant == "fma":
        return ((fma_tile(m), ("fma", None, 1, 1)),)
    nkb = max(1, cdiv(k, _WG_BK))
    if variant == "skinny":
        pers = (nt_split(m, n, k, sms)[1],) + split_choices(nkb)
        plans = {(skinny_rows(m), _SKINNY_COLS, per * _WG_BK):
                 ("skinny", None, cdiv(nkb, per), per) for per in pers}
        return tuple(plans.items())
    bn0, _, per0 = _wgmma_plan(m, n, k, sms)
    plans = {(_WG_BM, bn0, per0 * _WG_BK): ("wgmma", bn0, cdiv(nkb, per0), per0)}
    for bn in sorted(_WG_BN_COST):
        for per in split_choices(nkb, _MAX_SPLITS):
            if cdiv(m, _WG_BM) * cdiv(n, bn) * cdiv(nkb, per) <= MAX_UNITS:
                plans.setdefault((_WG_BM, bn, per * _WG_BK), ("wgmma", bn, cdiv(nkb, per), per))
    return tuple(plans.items())


def nn_plan(m: int, n: int, k: int, dtype: torch.dtype, a_ptr: int, b_ptr: int, sms: int,
            block: Optional[Tuple[int, int, int]] = None) -> tuple:
    """The plan a call with operands at ``a_ptr`` and ``b_ptr`` launches
    for ``block`` (None: the cost model's); raises ``ValueError`` on a
    config its route has no plan for.  Decided before the launch."""
    aligned = a_ptr % 16 == 0 and b_ptr % 16 == 0
    return pick_plan(nn_plans(m, n, k, dtype, aligned, sms), block,
                     f"NN kernel at ({m}, {n}, {k}) {dtype}")


@functools.lru_cache(maxsize=None)  # a model repeats a few shapes on every step
def _wgmma_plan(m: int, n: int, k: int, sms: int) -> Tuple[int, int, int]:
    """(BN, splits, k-blocks per split) of the wgmma variant: the pair whose
    waves of (split, tile) units over ``sms`` SMs, plus the split's reduce,
    cost least."""
    nkb = cdiv(k, _WG_BK)
    m_tiles = cdiv(m, _WG_BM)
    best = None
    for bn, col_cost in _WG_BN_COST.items():
        tiles = m_tiles * cdiv(n, bn)
        for want in range(1, min(nkb, _MAX_SPLITS) + 1):
            per = cdiv(nkb, want)
            splits = cdiv(nkb, per)  # no empty split
            if tiles * splits > MAX_UNITS:
                break
            us = cdiv(tiles * splits, sms) * per * bn * col_cost * _US_PER_COL_KB
            if splits > 1:  # partials written, read back, and C written
                us += _US_REDUCE + (8 * splits + 2) * m * n / _PARTIAL_BYTES_PER_US
            if best is None or us < best[0]:
                best = (us, bn, splits, per)
    if best is None:
        raise ValueError(f"NN kernel takes at most {MAX_UNITS} tiles, got ({m}, {n})")
    return best[1:]


def wgmma_tile_map(m_tiles: int, n_tiles: int, n_fast: bool):
    """Tile t of a persistent ``wgmma`` walk (csrc ``tile_origin``) as its
    (m-tile, n-tile): the n-tiles fastest with ``n_fast``, else the
    m-tiles."""
    if n_fast:
        return lambda t: (t // n_tiles, t % n_tiles)
    return lambda t: (t % m_tiles, t // m_tiles)


@functools.lru_cache(maxsize=None)  # built once a shape: a wrapper runs it every call
def nn_grid_specs(m: int, n: int, k: int, plan: tuple, sms: int) -> tuple:
    """The launches of an ``nn_plans`` plan on ``sms`` SMs: the ``wgmma``
    kernel's units (split, tile), tile t decoded by ``wgmma_tile_map`` with
    the n-tiles fastest when A is the larger (m > n), walked by min(units,
    sms) programs; the skinny kernel's block (x, y, z) at 128 columns x,
    64 rows y, split z; ``gemm_f32``'s or the FMA kernel's; each split
    plan then ``splitk_reduce``."""
    variant, bn, splits, per = plan
    if variant == "fma":
        return (fma_grid_spec(m, n, k, False),)
    if isinstance(bn, tuple):  # gemm_f32's plan names its (bm, bn) tile
        return f32_grid_specs(m, n, k, False, plan)
    if variant == "skinny":
        return gemm_grid_specs("nn_skinny", m, n, k, (_SKINNY_M, _SKINNY_COLS), per * _WG_BK,
                               splits, False)
    m_tiles, n_tiles = cdiv(m, _WG_BM), cdiv(n, bn)
    tile = wgmma_tile_map(m_tiles, n_tiles, m > n)
    kspan = per * _WG_BK
    a = BlockMap((_WG_BM, kspan), lambda sp, t: (tile(t)[0], sp), (m, k))
    b = BlockMap((kspan, bn), lambda sp, t: (sp, tile(t)[1]), (k, n))
    if splits == 1:
        out = BlockMap((_WG_BM, bn), lambda sp, t: tile(t), (m, n))
    else:
        out = BlockMap((1, _WG_BM, bn), lambda sp, t: (sp, *tile(t)), (splits, m, n))
    units = splits * m_tiles * n_tiles
    spec = persistent_spec("nn_wgmma", (splits, m_tiles * n_tiles), min(units, sms), (a, b), out)
    return (spec,) if splits == 1 else (spec, splitk_reduce_spec(m * n, splits))


def matmul_nn(
    a: torch.Tensor, b: torch.Tensor, *, block: Optional[Tuple[int, int, int]] = None
) -> torch.Tensor:
    """C = A @ B in A's dtype, f32 accumulation.  ``block`` is a (bm, bn,
    bk) tile config of ``nn_plans`` (None: the cost model's); any other
    raises on both routes."""
    if block is not None:
        block = validate_config(block)
    check_operand("a", a, 2)
    check_operand("b", b, 2)
    m, k = a.shape
    k2, n = b.shape
    if k != k2 or a.dtype != b.dtype:
        raise ValueError(f"NN operands mismatch: {tuple(a.shape)} {a.dtype} @ "
                         f"{tuple(b.shape)} {b.dtype}")
    r = route(a, b)
    sms = H100_SMS if r != "kernel" else sm_count(torch.cuda.current_device())
    plan = nn_plan(m, n, k, a.dtype, a.data_ptr(), b.data_ptr(), sms, block)
    variant, bn, splits, per = plan
    if r == "plain":
        return ref.matmul_nn(a, b)
    if r == "meta":
        return a.new_empty((m, n))
    if m * n == 0:
        return torch.empty((m, n), dtype=a.dtype, device=a.device)
    specs = nn_grid_specs(m, n, k, plan, sms)
    if variant == "fma":
        c = launch_matmul(a, b, m, n, k, False, specs[0])
    elif a.dtype == torch.float32:
        c = launch_matmul_f32(a, b, m, n, k, False, plan, specs)
    else:
        check_launch(specs, f"NN kernel takes at most {_SKINNY_MAX_M} rows, got {m}")
        c = torch.empty((m, n), dtype=a.dtype, device=a.device)
        ws = (torch.empty(specs[0].out_spec.extent, dtype=torch.float32, device=a.device)
              if splits > 1 else None)
        ws_ptr = _build.ptr(ws) if ws is not None else ctypes.c_void_p(None)
        if variant == "wgmma":
            _build.launch("matmul_nn", "repro_matmul_nn_wgmma", _build.ptr(a), _build.ptr(b),
                          _build.ptr(c), ws_ptr, m, n, k, bn, splits, per,
                          specs[0].launch[0], reduce_programs(specs), _build.stream_of(a))
        else:
            _build.launch("matmul_nn", "repro_matmul_nn_skinny", _build.ptr(a), _build.ptr(b),
                          _build.ptr(c), ws_ptr, m, n, k, splits, per, *specs[0].launch,
                          reduce_programs(specs), _build.stream_of(a))
    count_launch("matmul_nn", block, (variant, a.dtype))
    return c
