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
- f32: the NT instance of ``csrc/matmul.cu`` (FMA, no TF32), which reads
  B along k and turns each tile around in shared memory.

The NN wrapper's skinny kernel (``csrc/matmul_nn.cu``) has the same block
geometry and takes its split from ``nt_split`` too.

The wide arm, for training, is the fused TNN kernel.  On CPU tensors the
wrapper runs the plain version in ``ref.py``.
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

__all__ = ["matmul_nt", "nt_split", "nt_workspace_shape"]

_ROWS = 128  # csrc/matmul_nt.cu kRows: B rows per block
_M_TILE = 64  # kMTile: A rows per block; gridDim.y walks further tiles
_BK = 64  # kBK: k per pipeline stage, the unit of a split
_MAX_M = 65535 * _M_TILE


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
    blocks = cdiv(n, _ROWS) * cdiv(m, _M_TILE)
    want = cdiv(2 * sms, blocks)
    cap = max(1, k // (2 * min(m, _M_TILE)))
    per = cdiv(nkb, max(1, min(nkb, want, cap)))
    return cdiv(nkb, per), per


def nt_workspace_shape(m: int, n: int, k: int, sms: int) -> Optional[Tuple[int, int, int]]:
    """Shape of the f32 partials a split-k call needs, or None without a split."""
    splits, _ = nt_split(m, n, k, sms)
    return (splits, m, n) if splits > 1 else None


def matmul_nt(
    a: torch.Tensor, b: torch.Tensor, *, block: Optional[Tuple[int, int, int]] = None
) -> torch.Tensor:
    """C = A @ B^T in A's dtype, f32 accumulation.  ``block`` is validated
    as a (bm, bn, bk) tile config; the CUDA kernels pick their own tiles."""
    if block is not None:
        validate_config(block)
    check_operand("a", a, 2)
    check_operand("b", b, 2)
    m, k = a.shape
    n, k2 = b.shape
    if k != k2 or a.dtype != b.dtype:
        raise ValueError(f"NT operands mismatch: {tuple(a.shape)} {a.dtype} @ "
                         f"{tuple(b.shape)}^T {b.dtype}")
    if route(a, b) == "plain":
        return ref.matmul_nt(a, b)
    if a.dtype == torch.float32:
        c = launch_matmul(a, b, m, n, k, b_stored_nk=True)
    else:
        if m > _MAX_M:
            raise ValueError(f"NT kernel takes at most {_MAX_M} rows, got {m}")
        c = torch.empty((m, n), dtype=a.dtype, device=a.device)
        if c.numel():
            sms = sm_count(torch.cuda.current_device())
            splits, per = nt_split(m, n, k, sms)
            shape = nt_workspace_shape(m, n, k, sms)
            ws = None if shape is None else torch.empty(shape, dtype=torch.float32,
                                                        device=a.device)
            _build.launch(
                "matmul_nt", "repro_matmul_nt", _build.ptr(a), _build.ptr(b), _build.ptr(c),
                _build.ptr(ws) if ws is not None else ctypes.c_void_p(None),
                m, n, k, splits, per, _build.stream_of(a),
            )
    if c.numel():
        LAUNCHES["matmul_nt"] += 1
    return c
