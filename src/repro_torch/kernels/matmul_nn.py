"""NN matmul: C = A @ B, A:(m, k), B:(k, n) -- stage 2 of the paper's TNN,
every data gradient and stage 2 of every weight gradient.

Replaces the Pallas kernel ``repro/kernels/matmul_nn.py:77``.  On CUDA
tensors the wrapper launches one of three kernels, picked before the
launch by ``nn_variant`` from dtype, shape and the operands' addresses:

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
- ``fma`` (f32, or bf16 operands the two above do not take): the NN
  instance of ``csrc/matmul.cu`` (FMA, f32 accumulation, no TF32).

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
    LAUNCHES,
    cdiv,
    check_operand,
    launch_matmul,
    route,
    sm_count,
    validate_config,
)
from .matmul_nt import nt_split

__all__ = ["matmul_nn", "nn_variant"]

_SKINNY_M = 64  # csrc kMTile: the swap-AB kernel's A rows per block
_SKINNY_MAX_M = 65535 * _SKINNY_M  # its gridDim.y walks further 64-row tiles
_WG_BM = 128  # csrc kWgBM: the wgmma variant's tile rows
_WG_BK = 64  # kWgBK: k per stage, the unit of a split
_MAX_UNITS = 2**31 - 1  # the wgmma variant numbers its (split, tile) units with an int
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


def _aligned(n: int, k: int, a_ptr: int, b_ptr: int) -> bool:
    return k > 0 and k % 8 == 0 and n % 8 == 0 and a_ptr % 16 == 0 and b_ptr % 16 == 0


def nn_variant(m: int, n: int, k: int, dtype: torch.dtype, a_ptr: int, b_ptr: int,
               sms: int) -> Tuple[str, Optional[int], int, int]:
    """The kernel a CUDA call launches: ``(variant, BN, splits, k-blocks
    per split)`` -- ``("wgmma", BN, s, per)``, ``("skinny", None, s, per)``
    or ``("fma", None, 1, 1)``.  A pure function of the shape, dtype, the
    operands' addresses and the card's SM count, decided before the
    launch.  A split is a run of 64-deep k-blocks; none is empty."""
    if dtype != torch.bfloat16 or not _aligned(n, k, a_ptr, b_ptr):
        return "fma", None, 1, 1
    if m <= _SKINNY_M:
        return ("skinny", None) + nt_split(m, n, k, sms)
    return ("wgmma",) + _wgmma_plan(m, n, k, sms)


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
            if tiles * splits > _MAX_UNITS:
                break
            us = cdiv(tiles * splits, sms) * per * bn * col_cost * _US_PER_COL_KB
            if splits > 1:  # partials written, read back, and C written
                us += _US_REDUCE + (8 * splits + 2) * m * n / _PARTIAL_BYTES_PER_US
            if best is None or us < best[0]:
                best = (us, bn, splits, per)
    if best is None:
        raise ValueError(f"NN kernel takes at most {_MAX_UNITS} tiles, got ({m}, {n})")
    return best[1:]


def matmul_nn(
    a: torch.Tensor, b: torch.Tensor, *, block: Optional[Tuple[int, int, int]] = None
) -> torch.Tensor:
    """C = A @ B in A's dtype, f32 accumulation.  ``block`` is validated as
    a (bm, bn, bk) tile config; the CUDA kernels pick their own tiles."""
    if block is not None:
        validate_config(block)
    check_operand("a", a, 2)
    check_operand("b", b, 2)
    m, k = a.shape
    k2, n = b.shape
    if k != k2 or a.dtype != b.dtype:
        raise ValueError(f"NN operands mismatch: {tuple(a.shape)} {a.dtype} @ "
                         f"{tuple(b.shape)} {b.dtype}")
    if route(a, b) == "plain":
        return ref.matmul_nn(a, b)
    if m * n == 0:
        return torch.empty((m, n), dtype=a.dtype, device=a.device)
    variant, bn, splits, per = nn_variant(m, n, k, a.dtype, a.data_ptr(), b.data_ptr(),
                                          sm_count(torch.cuda.current_device()))
    if variant == "fma":
        c = launch_matmul(a, b, m, n, k, b_stored_nk=False)
    else:
        if variant == "skinny" and m > _SKINNY_MAX_M:
            raise ValueError(f"NN kernel takes at most {_SKINNY_MAX_M} rows, got {m}")
        c = torch.empty((m, n), dtype=a.dtype, device=a.device)
        ws = (torch.empty((splits, m, n), dtype=torch.float32, device=a.device)
              if splits > 1 else None)
        ws_ptr = _build.ptr(ws) if ws is not None else ctypes.c_void_p(None)
        if variant == "wgmma":
            _build.launch("matmul_nn", "repro_matmul_nn_wgmma", _build.ptr(a), _build.ptr(b),
                          _build.ptr(c), ws_ptr, m, n, k, bn, splits, per,
                          _build.stream_of(a))
        else:
            _build.launch("matmul_nn", "repro_matmul_nn_skinny", _build.ptr(a), _build.ptr(b),
                          _build.ptr(c), ws_ptr, m, n, k, splits, per, _build.stream_of(a))
    LAUNCHES["matmul_nn"] += 1
    return c
