"""Direct NT matmul: C = A @ B^T, A:(m, k), B:(n, k) -- the direct arm.

Replaces the Pallas kernel ``repro/kernels/matmul_nt.py:81``.  On CUDA
tensors the wrapper launches:

- bf16: ``csrc/matmul_nt.cu``, the skinny arm of the two NT kernels, built
  for the serving projections (m a decode bucket or a prompt of <= 64
  tokens; bound by the bytes of B).  It computes C^T = B . A^T on the
  tensor cores (``mma.sync`` m16n8k16 with B's stored rows as the m16
  operand and A's rows as the n8 operand, both through ``ldmatrix``
  without ``.trans``), streams B along k through a ``cp.async`` ring, and
  splits k over the grid when the shape has too few blocks to fill the
  card (``nt_split``): a second kernel then sums the f32 partials in a
  fixed order.  Unaligned operands take a scalar load path inside the
  kernel.
- f32 (no TF32): ``csrc/matmul.cu``'s ``gemm_f32`` for aligned operands
  (k % 4 == 0, A and B 16-byte aligned; ``f32_plans`` in ``common.py``):
  ``skinny`` where m <= 16 or n <= 64 (decode, the MoE routers: the long
  operand streamed once, k split until the grid fills the card, the f32
  partials summed in split order) and ``tiled`` above (128 x 128 tiles, 8
  x 8 register micro-tiles, split k where the tiles cannot fill the card);
  ``fma``, the FMA kernel, for the rest.  Both read B along k and turn
  each tile around in shared memory.

The NN wrapper's skinny kernel (``csrc/matmul_nn.cu``) has the same block
geometry and takes its split from ``nt_split`` too.

Tile configs (``kernels/tiling.py``): ``nt_plans`` lists the plans of a
shape's route as (config, plan) pairs, the cost model's first, and
``block=None`` launches that one.  A config ``(bm, bn, bk)`` of the bf16
kernel is bm the A-row instance that m takes (``skinny_rows``: 8, 16, 32
or 64), bn its 128 B rows per block and bk the k of one split: the cost
model's split (``nt_split``) and 1, 2, 4, ... splits of k.  A config of
the f32 kernel is its route's tile and the k of one split (``f32_plans``);
the FMA kernel runs one tile, ``fma_tile(m)``.  Any other config raises,
on both routes.

``nt_grid_specs`` declares each route's launch (``kernels/gridspec.py``):
the bf16 kernel's block (x, y, z) takes 128 rows of B at x, 64 rows of
A at y and split z of k.  The wide arm, for training, is the fused TNN
kernel.  On CPU tensors the
wrapper runs the plain version in ``ref.py``.
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
    gemm_grid_specs,
    launch_matmul,
    launch_matmul_f32,
    pick_plan,
    reduce_programs,
    route,
    sm_count,
    split_choices,
    validate_config,
)
from .gridspec import MAX_GRID_Y, check_launch

__all__ = ["matmul_nt", "nt_split", "nt_workspace_shape", "nt_plans", "nt_grid_specs",
           "skinny_rows"]

_ROWS = 128  # csrc/matmul_nt.cu kRows: B rows per block
_M_TILE = 64  # kMTile: A rows per block; gridDim.y walks further tiles
_BK = 64  # kBK: k per pipeline stage, the unit of a split
_MAX_M = MAX_GRID_Y * _M_TILE


@functools.lru_cache(maxsize=None)  # a model repeats a few shapes on every step
def nt_split(m: int, n: int, k: int, sms: int) -> Tuple[int, int]:
    """(splits, k-blocks per split) of the bf16 kernel: a pure function of
    the shape and the card's SM count.  Split k until the grid has about two
    blocks per SM, at most one split per 64-wide k-block, and no more splits
    than keep the f32 partials' bytes under B's (k / (2 m) for m <= 64).
    No split is empty."""
    nkb = cdiv(k, _BK)
    if nkb <= 1:
        return 1, 1
    blocks = max(1, cdiv(n, _ROWS) * cdiv(m, _M_TILE))
    want = cdiv(2 * sms, blocks)
    cap = max(1, k // (2 * min(m, _M_TILE)))
    per = cdiv(nkb, max(1, min(nkb, want, cap)))
    return cdiv(nkb, per), per


def nt_workspace_shape(m: int, n: int, k: int, sms: int) -> Optional[Tuple[int, int, int]]:
    """Shape of the f32 partials a split-k call needs, or None without a split."""
    splits, _ = nt_split(m, n, k, sms)
    return (splits, m, n) if splits > 1 else None


def skinny_rows(m: int) -> int:
    """The A-row instance the swap-AB kernels (this one and the NN skinny
    kernel) launch for m: min(m, 64) rounded up to 8, 16, 32 or 64."""
    r = min(m, _M_TILE)
    return 8 if r <= 8 else 16 if r <= 16 else 32 if r <= 32 else 64


@functools.lru_cache(maxsize=None)
def nt_plans(m: int, n: int, k: int, dtype: torch.dtype, aligned: bool = True,
             sms: int = H100_SMS):
    """The (config, plan) pairs of this shape's route (``aligned``: A and
    B 16-byte aligned), the cost model's first.  A plan is ``(route, tile,
    splits, k-steps per split)``: ``("mma", None, s, per)`` (bf16, which
    takes any alignment), or f32's ``f32_plans``."""
    if dtype == torch.float32:
        return f32_plans(m, n, k, True, aligned, sms)
    nkb = max(1, cdiv(k, _BK))
    pers = (nt_split(m, n, k, sms)[1],) + split_choices(nkb)
    plans = {(skinny_rows(m), _ROWS, per * _BK): ("mma", None, cdiv(nkb, per), per)
             for per in pers}
    return tuple(plans.items())


@functools.lru_cache(maxsize=None)  # built once a shape: a wrapper runs it every call
def nt_grid_specs(m: int, n: int, k: int, plan: tuple) -> tuple:
    """The launches of an ``nt_plans`` plan: the bf16 kernel (``nt_bf16``,
    then ``splitk_reduce`` where k splits), ``gemm_f32``'s, or the FMA
    kernel's."""
    route_, _, splits, per = plan
    if route_ == "fma":
        return (fma_grid_spec(m, n, k, True),)
    if route_ != "mma":
        return f32_grid_specs(m, n, k, True, plan)
    return gemm_grid_specs("nt_bf16", m, n, k, (_M_TILE, _ROWS), per * _BK, splits, True)


def matmul_nt(
    a: torch.Tensor, b: torch.Tensor, *, block: Optional[Tuple[int, int, int]] = None
) -> torch.Tensor:
    """C = A @ B^T in A's dtype, f32 accumulation.  ``block`` is a (bm, bn,
    bk) tile config of ``nt_plans`` (None: the cost model's); any other
    raises on both routes."""
    if block is not None:
        block = validate_config(block)
    check_operand("a", a, 2)
    check_operand("b", b, 2)
    m, k = a.shape
    n, k2 = b.shape
    if k != k2 or a.dtype != b.dtype:
        raise ValueError(f"NT operands mismatch: {tuple(a.shape)} {a.dtype} @ "
                         f"{tuple(b.shape)}^T {b.dtype}")
    r = route(a, b)
    sms = H100_SMS if r != "kernel" else sm_count(torch.cuda.current_device())
    aligned = a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0
    plan = pick_plan(nt_plans(m, n, k, a.dtype, aligned, sms), block,
                     f"NT kernel at ({m}, {n}, {k}) {a.dtype}")
    route_, _, splits, per = plan
    if r == "plain":
        return ref.matmul_nt(a, b)
    if r == "meta":
        return a.new_empty((m, n))
    specs = nt_grid_specs(m, n, k, plan)
    if route_ == "fma":
        c = launch_matmul(a, b, m, n, k, True, specs[0])
    elif a.dtype == torch.float32:
        c = launch_matmul_f32(a, b, m, n, k, True, plan, specs)
    else:
        check_launch(specs, f"NT kernel takes at most {_MAX_M} rows, got {m}")
        c = torch.empty((m, n), dtype=a.dtype, device=a.device)
        if c.numel():
            ws = (torch.empty(specs[0].out_spec.extent, dtype=torch.float32, device=a.device)
                  if splits > 1 else None)
            _build.launch(
                "matmul_nt", "repro_matmul_nt", _build.ptr(a), _build.ptr(b), _build.ptr(c),
                _build.ptr(ws) if ws is not None else ctypes.c_void_p(None),
                m, n, k, splits, per, *specs[0].launch, reduce_programs(specs),
                _build.stream_of(a),
            )
    if c.numel():
        count_launch("matmul_nt", block, (route_, a.dtype))
    return c
