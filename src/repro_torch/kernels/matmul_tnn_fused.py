"""Fused TNN matmul: C = A @ B^T, A:(m, k), B:(n, k), with B consumed in its
stored layout -- no transpose kernel, no turned-around tile.

Replaces the Pallas kernel ``repro/kernels/matmul_tnn_fused.py:90``.  On
CUDA tensors the wrapper launches ``csrc/matmul_tnn_fused.cu``, whose
variant it picks before the launch from dtype, shape and alignment
(``tnn_fused_variant``):

- ``wgmma`` (bf16, k % 8 == 0, A and B 16-byte aligned, as TMA needs): the
  wide arm of the two NT kernels, built for the training forward (m = 2048
  tokens, bound by operations).  A persistent grid walks 128 x BN output
  tiles n-major; TMA loads both operands K-major into a shared-memory ring
  and two warpgroups run ``wgmma`` on B's stored rows.  BN (64, 96, 192 or
  256) is the width whose waves of tiles over 132 SMs cost least.
- ``mma_sync`` (bf16, any other k or alignment): ``mma.sync`` m16n8k16 on
  64 x 64 tiles, whose column-major B operand is B's stored (n, k) rows,
  loaded with ``ldmatrix`` and no ``.trans``; unaligned rows take a
  zero-filling scalar path.
- ``f32_tiled`` / ``f32_skinny`` (f32, k % 4 == 0, A and B 16-byte
  aligned): exact FFMA on register micro-tiles, both operands copied as
  stored (16-byte ``cp.async``) into K-major shared tiles; 128 x 128
  tiles for the training forward, 16 x 128 (m <= 16) or 128 x 16 (n <= 64)
  for decode and the MoE routers, and k split over the grid where the
  tiles leave SMs idle (``common.f32_split``'s cost model), the partials
  summed in split order.
- ``fma`` (f32, any other k or alignment): FMA over the same K-major
  tiles with scalar loads, no TF32.

The skinny arm, for serving, is the direct NT kernel (``matmul_nt``).  A
launch that fails raises; no variant stands in for another.

Tile configs (``kernels/tiling.py``): ``tnn_fused_plans`` lists the
plans of a shape's route as (config, plan) pairs, the cost model's first,
and ``block=None`` launches that one.  On the ``wgmma`` route a config
(128, BN, 64) launches the BN instance (64, 96, 192 or 256; 64 is the k of
a stage); on the f32 routes a config (bm, bn, bk) is the route's tile and
the k of one split (the cost model's, and that of 1, 2, 4, ... up to 32
splits); the ``mma_sync`` and ``fma`` routes run one tile each, (64, 64,
32).  Any other config raises, on both routes.  ``tnn_fused_grid_specs``
declares each route's launches (``kernels/gridspec.py``).  Each launch is counted
under its route and dtype in ``GEMM_ROUTES``.  On CPU tensors the wrapper
runs the plain version in ``ref.py``.
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
    f32_plans,
    f32_route,
    gemm_grid_specs,
    pick_plan,
    reduce_programs,
    route,
    sm_count,
    validate_config,
)
from .gridspec import MAX_GRID_Y, MAX_UNITS, BlockMap, check_launch, dense_spec, persistent_spec
from .matmul_nn import wgmma_tile_map

__all__ = ["matmul_tnn_fused", "tnn_fused_variant", "tnn_fused_plans", "tnn_fused_grid_specs"]

_TILE = 64  # csrc kBM = kBN of the mma.sync and FMA variants
_TILE_BK = 32  # their kBK
_WG_BK = 64  # kWgBK: k per stage of the wgmma variant
_F32_BK = 16  # kFBK: k per step of the f32 variants, the unit of a split
_MAX_N = MAX_GRID_Y * _TILE  # their gridDim.y walks the n-tiles; the f32 ones' the m-tiles
_WG_BM = 128  # csrc kWgBM: the wgmma variant's tile rows
_SMS = 132  # an H100's SMs: the persistent grid's width
# The wgmma variant's tile widths (csrc launch_wgmma instances), widest
# first so that a tie picks the wider one, and the relative cost of a tile
# column at each: a 64- or 96-wide wgmma reads A from shared memory for few
# columns and is bound by shared memory, not by the tensor cores.
_WG_BN_COST = {256: 1.0, 192: 1.0, 96: 1.15, 64: 1.3}


def tnn_fused_variant(dtype: torch.dtype, m: int, n: int, k: int, a_ptr: int,
                      b_ptr: int) -> Tuple[str, Optional[int]]:
    """The kernel variant a CUDA call launches, and the wgmma variant's
    tile width BN: ``("wgmma", BN)``, ``("mma_sync", None)``,
    ``("f32_tiled", None)``, ``("f32_skinny", None)`` or ``("fma", None)``.
    A pure function of dtype, shape and the operands' addresses, decided
    before the launch."""
    if dtype == torch.float32:  # gemm_f32's NT routes: the same tiles and rules
        f32 = f32_route(m, n, k, True, a_ptr % 16 == 0 and b_ptr % 16 == 0)
        return (f32 if f32 == "fma" else f"f32_{f32}"), None
    if k > 0 and k % 8 == 0 and a_ptr % 16 == 0 and b_ptr % 16 == 0:
        return "wgmma", _wgmma_block_n(m, n)
    return "mma_sync", None


@functools.lru_cache(maxsize=None)  # a model repeats a few shapes on every step
def _wgmma_block_n(m: int, n: int) -> int:
    """The tile width whose waves of 128 x BN tiles over 132 SMs cost least:
    waves x BN x the width's cost per column (every tile of a shape has the
    same k)."""
    m_tiles = cdiv(m, _WG_BM)
    return min(_WG_BN_COST,
               key=lambda bn: cdiv(m_tiles * cdiv(n, bn), _SMS) * bn * _WG_BN_COST[bn])


@functools.lru_cache(maxsize=None)
def tnn_fused_plans(m: int, n: int, k: int, dtype: torch.dtype, aligned: bool = True,
                    sms: int = H100_SMS):
    """The (config, plan) pairs of this shape's route (``aligned``: A and
    B 16-byte aligned), the cost model's first.  A plan is ``(variant,
    tile, splits, k-steps per split)``: ``("wgmma", BN, 1, 1)``, an f32
    route's ``(variant, (bm, bn), splits, per)`` (``common.f32_plans``'s
    NT plans on ``sms`` SMs: the cost model's split first, then 1, 2, 4,
    ... 32 splits), or ``(variant, None, 1, 1)``."""
    ptr = 0 if aligned else 1
    variant, bn0 = tnn_fused_variant(dtype, m, n, k, ptr, ptr)
    if variant.startswith("f32_"):
        return tuple((config, (variant, *plan[1:]))
                     for config, plan in f32_plans(m, n, k, True, aligned, sms))
    if variant != "wgmma":
        return (((_TILE, _TILE, _TILE_BK), (variant, None, 1, 1)),)
    widths = [bn0] + [bn for bn in sorted(_WG_BN_COST)
                      if bn != bn0 and cdiv(m, _WG_BM) * cdiv(n, bn) <= MAX_UNITS]
    return tuple(((_WG_BM, bn, _WG_BK), ("wgmma", bn, 1, 1)) for bn in widths)


@functools.lru_cache(maxsize=None)  # built once a shape: a wrapper runs it every call
def tnn_fused_grid_specs(m: int, n: int, k: int, plan: tuple, sms: int) -> tuple:
    """The launches of a ``tnn_fused_plans`` plan on ``sms`` SMs: the
    ``wgmma`` kernel's persistent walk of its 128 x BN tiles, m-tiles
    fastest (n-major), on min(tiles, sms) programs; the ``mma_sync`` and
    FMA kernels' block (x, y) at m-tile x, n-tile y; the f32 kernel's
    block (x, y, z) at n-tile x, m-tile y, split z, then ``splitk_reduce``
    where k splits."""
    variant, tile, splits, per = plan
    if variant.startswith("f32_"):
        return gemm_grid_specs("tnn_fused_f32", m, n, k, tile, per * _F32_BK, splits, True)
    if variant != "wgmma":
        name = "tnn_fused_bf16" if variant == "mma_sync" else "tnn_fused_fma"
        return (dense_spec(name, (cdiv(m, _TILE), cdiv(n, _TILE)),
                           (BlockMap((_TILE, k), lambda x, y, z: (x, 0), (m, k)),
                            BlockMap((_TILE, k), lambda x, y, z: (y, 0), (n, k))),
                           BlockMap((_TILE, _TILE), lambda x, y, z: (x, y), (m, n))),)
    m_tiles, n_tiles = cdiv(m, _WG_BM), cdiv(n, tile)
    at = wgmma_tile_map(m_tiles, n_tiles, False)
    return (persistent_spec(
        "tnn_fused_wgmma", (m_tiles * n_tiles,), min(m_tiles * n_tiles, sms),
        (BlockMap((_WG_BM, k), lambda t: (at(t)[0], 0), (m, k)),
         BlockMap((tile, k), lambda t: (at(t)[1], 0), (n, k))),
        BlockMap((_WG_BM, tile), at, (m, n))),)


def matmul_tnn_fused(
    a: torch.Tensor, b: torch.Tensor, *, block: Optional[Tuple[int, int, int]] = None
) -> torch.Tensor:
    """C = A @ B^T in A's dtype, f32 accumulation.  ``block`` is a (bm, bn,
    bk) tile config of ``tnn_fused_plans`` (None: the cost model's); any
    other raises on both routes."""
    if block is not None:
        block = validate_config(block)
    check_operand("a", a, 2)
    check_operand("b", b, 2)
    m, k = a.shape
    n, k2 = b.shape
    if k != k2 or a.dtype != b.dtype:
        raise ValueError(f"fused TNN operands mismatch: {tuple(a.shape)} {a.dtype} @ "
                         f"{tuple(b.shape)}^T {b.dtype}")
    r = route(a, b)
    sms = H100_SMS if r != "kernel" else sm_count(torch.cuda.current_device())
    aligned = a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0
    variant, tile, splits, per = pick_plan(tnn_fused_plans(m, n, k, a.dtype, aligned, sms),
                                           block,
                                           f"fused TNN kernel at ({m}, {n}, {k}) {a.dtype}")
    if r == "plain":
        return ref.matmul_tnn_fused(a, b)
    if r == "meta":
        return a.new_empty((m, n))
    f32 = variant.startswith("f32_")
    specs = tnn_fused_grid_specs(m, n, k, (variant, tile, splits, per), sms)
    if variant == "wgmma":
        check_launch(specs, f"fused TNN kernel takes at most {MAX_UNITS} tiles, got ({m}, {n})")
    elif f32:
        check_launch(specs, f"fused TNN f32 kernel takes at most {MAX_GRID_Y * tile[0]} rows, "
                            f"got {m}")
    else:
        check_launch(specs, f"fused TNN kernel takes at most {_MAX_N} columns, got {n}")
    c = torch.empty((m, n), dtype=a.dtype, device=a.device)
    if c.numel():
        if variant == "wgmma":
            _build.launch(
                "matmul_tnn_fused", "repro_matmul_tnn_fused_wgmma", _build.ptr(a),
                _build.ptr(b), _build.ptr(c), m, n, k, tile, specs[0].launch[0],
                _build.stream_of(a),
            )
        elif f32:
            ws = (torch.empty(specs[0].out_spec.extent, dtype=torch.float32, device=a.device)
                  if splits > 1 else None)
            _build.launch(
                "matmul_tnn_fused", "repro_matmul_tnn_fused_f32", _build.ptr(a), _build.ptr(b),
                _build.ptr(c), _build.ptr(ws) if ws is not None else ctypes.c_void_p(None),
                m, n, k, tile[0], tile[1], splits, per, *specs[0].launch,
                reduce_programs(specs), _build.stream_of(a),
            )
        else:
            _build.launch(
                "matmul_tnn_fused", "repro_matmul_tnn_fused", _build.ptr(a), _build.ptr(b),
                _build.ptr(c), m, n, k, _build.dtype_code(a.dtype), *specs[0].launch,
                _build.stream_of(a),
            )
        count_launch("matmul_tnn_fused", block, (variant, a.dtype))
    return c
