"""Batched matmuls over a leading batch axis -- the attention contractions:

  matmul_bnt  C_i = A_i @ B_i^T   A:(g, m, k)  B:(g, n, k)  ->  (g, m, n)
  matmul_bnn  C_i = A_i @ B_i     A:(g, m, k)  B:(g, k, n)  ->  (g, m, n)

Replace the Pallas kernel ``repro/kernels/matmul_batched.py:124``
(``_matmul_batched``, behind ``matmul_bnt`` and ``matmul_bnn``).  On CUDA
tensors the wrappers launch one of three kernels of
``csrc/matmul_batched.cu``, picked before the launch by
``batched_plans`` from dtype, shape and the operands' alignment:

- ``tiled`` (f32, k a multiple of 4, BNN's n too, 16-byte aligned
  operands): the attention backward's contractions, bound by operations
  at the f32 FMA rate (exact FFMA, no TF32).  64 x 64 tiles, an 8 x 4
  register micro-tile per thread fed by float4 reads of shared memory,
  double-buffered 16-deep k steps; k splits over the grid up to three
  blocks per SM (``_tiled_split``: n = 64 leaves few tiles), and a second
  kernel sums the f32 partials in split order.
- ``mma`` (bf16, k a multiple of 8, BNN's n too, 16-byte aligned):
  ``mma.sync`` m16n8k16 with f32 accumulation on 64 x 64 tiles through a
  ``cp.async`` ring; BNT's B is read with ``ldmatrix``, BNN's with
  ``ldmatrix.trans``.
- ``fma`` (any other operands): FMA over f32-staged shared tiles, one
  block per (slice, 64-column tile), a 16-row tile for m <= 16.

Tile configs (``kernels/tiling.py``): ``batched_plans`` lists the plans
of a shape's route as (config, plan) pairs, the cost model's first, and
``block=None`` launches that one.  On the ``tiled`` route a config (64,
64, bk) sets the k of one split (the cost model's split, and 1, 2, 4, ...
splits with g x splits within gridDim.z); the ``mma`` route runs one
tile, (64, 64, 64), and the ``fma`` route ``fma_tile(m)``.  Any other
config raises, on both routes.

``batched_grid_specs`` declares each route's launches
(``kernels/gridspec.py``): block (x, y, z) at n-tile x, m-tile y and z
folding (slice, split) as slice z / splits, split z % splits.

Each call counts one launch, split or not.  On CPU tensors the wrappers
run the plain versions in ``ref.py``.
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
    fma_tile,
    pick_plan,
    reduce_programs,
    route,
    sm_count,
    split_choices,
    splitk_reduce_spec,
    validate_config,
)
from .gridspec import MAX_GRID_Y, MAX_GRID_Z, BlockMap, check_launch, dense_spec

__all__ = ["matmul_bnt", "matmul_bnn", "batched_plans", "batched_plan", "batched_grid_specs"]

_MAX_Z = MAX_GRID_Z  # gridDim.z: slices (times splits for the tiled kernel)
_MAX_M = MAX_GRID_Y * 16  # gridDim.y of the smallest row tile
_TILE = 64  # the tiled and mma kernels' output tile, 64 x 64
_TILED_BK = 16  # the tiled kernel's k step, the unit of a split
_MIN_STEPS_PER_SPLIT = 4  # a split walks at least 64 of k
_BLOCKS_PER_SM = 3  # the most blocks per SM the tiled kernel's split aims for
_MMA_TILE = (_TILE, _TILE, 64)  # the mma kernel's tile: kMBM x kMBN, kMBK per stage


def _route(dtype: torch.dtype, k: int, n: int, nt: bool, aligned: bool) -> str:
    vec = 4 if dtype == torch.float32 else 8
    if not (aligned and k > 0 and k % vec == 0 and (nt or n % vec == 0)):
        return "fma"
    return "mma" if dtype == torch.bfloat16 else "tiled"


@functools.lru_cache(maxsize=None)
def batched_plans(dtype: torch.dtype, g: int, m: int, n: int, k: int, nt: bool,
                  aligned: bool = True, sms: int = H100_SMS):
    """The (config, plan) pairs of this shape's route, the cost model's
    first: ``nt`` says B is (g, n, k), ``aligned`` that A and B are
    16-byte aligned.  A plan is ``(variant, None, splits, k-steps per
    split)``: ``("tiled", None, s, per)`` (f32), ``("mma", None, 1, 1)``
    (bf16) or ``("fma", None, 1, 1)``.  The tiled kernel's vector loads
    need k (and BNN's n, B's row length) to be a multiple of 4 floats, the
    mma kernel's of 8 bf16."""
    variant = _route(dtype, k, n, nt, aligned)
    if variant != "tiled":
        tile = _MMA_TILE if variant == "mma" else fma_tile(m)
        return ((tile, (variant, None, 1, 1)),)
    steps = cdiv(k, _TILED_BK)
    pers = (_tiled_split(g, m, n, k, sms)[1],) + split_choices(steps, max(1, _MAX_Z // g))
    plans = {(_TILE, _TILE, per * _TILED_BK): ("tiled", None, cdiv(steps, per), per)
             for per in pers}
    return tuple(plans.items())


def batched_plan(dtype: torch.dtype, g: int, m: int, n: int, k: int, nt: bool, a_ptr: int,
                 b_ptr: int, sms: int, block: Optional[Tuple[int, int, int]] = None
                 ) -> Tuple[str, None, int, int]:
    """The plan a call with operands at ``a_ptr`` and ``b_ptr`` launches
    for ``block`` (None: the cost model's); raises ``ValueError`` on a
    config its route has no plan for.  Decided before the launch."""
    aligned = a_ptr % 16 == 0 and b_ptr % 16 == 0
    return pick_plan(batched_plans(dtype, g, m, n, k, nt, aligned, sms), block,
                     f"batched kernel ({'BNT' if nt else 'BNN'}) at g={g} ({m}, {n}, {k}) "
                     f"{dtype}")


@functools.lru_cache(maxsize=None)  # the attention backward repeats its shapes
def _tiled_split(g: int, m: int, n: int, k: int, sms: int) -> Tuple[int, int]:
    """(splits, 16-deep k-steps per split) of the tiled kernel: split k
    while the grid stays within ``_BLOCKS_PER_SM`` blocks per SM, each
    split at least ``_MIN_STEPS_PER_SPLIT`` steps deep, and g x splits
    within gridDim.z.  No split is empty."""
    steps = cdiv(k, _TILED_BK)
    blocks = max(1, g * cdiv(m, _TILE) * cdiv(n, _TILE))
    want = min(max(1, _BLOCKS_PER_SM * sms // blocks),
               max(1, steps // _MIN_STEPS_PER_SPLIT), max(1, _MAX_Z // g))
    per = cdiv(steps, want)
    return cdiv(steps, per), per


@functools.lru_cache(maxsize=None)  # built once a shape: a wrapper runs it every call
def batched_grid_specs(g: int, m: int, n: int, k: int, nt: bool, plan: tuple) -> tuple:
    """The launches of a ``batched_plans`` plan (``nt``: B is (g, n, k),
    else (g, k, n)): block (x, y, z) computes the output tile at n-tile x,
    m-tile y of slice z / splits over split z % splits's run of k; a split
    plan writes f32 partials, (splits, g, m, n), and ``splitk_reduce``
    sums them."""
    variant, _, splits, per = plan
    if variant == "tiled":
        name, (bm, bn), kspan = "bmm_f32", (_TILE, _TILE), per * _TILED_BK
    elif variant == "mma":
        name, (bm, bn), kspan = "bmm_bf16", (_TILE, _TILE), k
    else:
        name, (bm, bn, _), kspan = "batched_fma", fma_tile(m), k
    launch = (cdiv(n, bn), cdiv(m, bm), g * splits)
    a = BlockMap((1, bm, kspan), lambda x, y, z: (z // splits, y, z % splits), (g, m, k))
    if nt:
        b = BlockMap((1, bn, kspan), lambda x, y, z: (z // splits, x, z % splits), (g, n, k))
    else:
        b = BlockMap((1, kspan, bn), lambda x, y, z: (z // splits, z % splits, x), (g, k, n))
    if splits == 1:
        return (dense_spec(name, launch, (a, b),
                           BlockMap((1, bm, bn), lambda x, y, z: (z, y, x), (g, m, n))),)
    ws = BlockMap((1, 1, bm, bn), lambda x, y, z: (z % splits, z // splits, y, x),
                  (splits, g, m, n))
    return (dense_spec(name, launch, (a, b), ws), splitk_reduce_spec(g * m * n, splits))


def _batched(a: torch.Tensor, b: torch.Tensor, nt: bool, block) -> torch.Tensor:
    if block is not None:
        block = validate_config(block)
    check_operand("a", a, 3)
    check_operand("b", b, 3)
    g, m, k = a.shape
    g2, n, k2 = b.shape if nt else (b.shape[0], b.shape[2], b.shape[1])
    if g != g2 or k != k2 or a.dtype != b.dtype:
        raise ValueError(f"batched operands mismatch: {tuple(a.shape)} {a.dtype} vs "
                         f"{tuple(b.shape)} {b.dtype} ({'BNT' if nt else 'BNN'})")
    r = route(a, b)
    if r != "kernel":
        if block is not None:
            batched_plan(a.dtype, g, m, n, k, nt, a.data_ptr(), b.data_ptr(), H100_SMS, block)
        if r == "meta":
            return a.new_empty((g, m, n))
        return ref.matmul_bnt(a, b) if nt else ref.matmul_bnn(a, b)
    if m > _MAX_M:
        raise ValueError(f"batched kernel takes at most {_MAX_M} rows, got {m}")
    plan = batched_plan(a.dtype, g, m, n, k, nt, a.data_ptr(), b.data_ptr(),
                        sm_count(torch.cuda.current_device()), block)
    variant, _, splits, per = plan
    specs = batched_grid_specs(g, m, n, k, nt, plan)
    check_launch(specs, f"batched kernel takes at most {_MAX_Z} slices, got {g}")
    c = torch.empty((g, m, n), dtype=a.dtype, device=a.device)
    if not c.numel():
        return c
    args = (_build.ptr(a), _build.ptr(b), _build.ptr(c))
    if variant == "tiled":
        ws = (torch.empty(specs[0].out_spec.extent, dtype=torch.float32, device=a.device)
              if splits > 1 else None)
        _build.launch("matmul_batched", "repro_matmul_batched_f32", *args,
                      _build.ptr(ws) if ws is not None else ctypes.c_void_p(None),
                      g, m, n, k, int(nt), splits, per, *specs[0].launch,
                      reduce_programs(specs), _build.stream_of(a))
    elif variant == "mma":
        _build.launch("matmul_batched", "repro_matmul_batched_bf16", *args, g, m, n, k,
                      int(nt), *specs[0].launch, _build.stream_of(a))
    else:
        _build.launch("matmul_batched", "repro_matmul_batched_fma", *args, g, m, n, k,
                      int(nt), _build.dtype_code(a.dtype), *specs[0].launch,
                      _build.stream_of(a))
    count_launch("matmul_bnt" if nt else "matmul_bnn", block)
    return c


def matmul_bnt(
    a: torch.Tensor, b: torch.Tensor, *, block: Optional[Tuple[int, int, int]] = None
) -> torch.Tensor:
    """Batched NT in A's dtype, f32 accumulation.  ``block`` is a (bm, bn,
    bk) tile config of ``batched_plans`` (None: the cost model's); any
    other raises on both routes."""
    return _batched(a, b, True, block)


def matmul_bnn(
    a: torch.Tensor, b: torch.Tensor, *, block: Optional[Tuple[int, int, int]] = None
) -> torch.Tensor:
    """Batched NN in A's dtype, f32 accumulation.  ``block`` is a (bm, bn,
    bk) tile config of ``batched_plans`` (None: the cost model's); any
    other raises on both routes."""
    return _batched(a, b, False, block)
