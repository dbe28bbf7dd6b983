"""Fused TNN matmul: C = A @ B^T, A:(m, k), B:(n, k), with B consumed in its
stored layout -- no transpose kernel, no turned-around tile.

Replaces the Pallas kernel ``repro/kernels/matmul_tnn_fused.py:90``.  On
CUDA tensors the wrapper launches ``csrc/matmul_tnn_fused.cu``: bf16 on the
tensor cores (``mma.sync`` m16n8k16, whose column-major B operand is B's
stored (n, k) rows, loaded with ``ldmatrix`` and no ``.trans``), f32 on FMA
over the same K-major tiles; blocks walk the m-tiles fastest so neighbours
share one B strip in L2 (the Pallas grid's n-major order).  On CPU tensors
it runs the plain version in ``ref.py``.  Bound on the H100: operations at
the training shapes (m = 2048 tokens), bytes at decode.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build, ref
from .common import LAUNCHES, check_operand, route, validate_config

__all__ = ["matmul_tnn_fused"]

_TILE = 64  # csrc kBM = kBN
_MAX_N = 65535 * _TILE  # gridDim.y walks the n-tiles


def matmul_tnn_fused(
    a: torch.Tensor, b: torch.Tensor, *, block: Optional[Tuple[int, int, int]] = None
) -> torch.Tensor:
    """C = A @ B^T in A's dtype, f32 accumulation.  ``block`` is validated as
    a (bm, bn, bk) tile config; the CUDA kernel's tiles are fixed."""
    if block is not None:
        validate_config(block)
    check_operand("a", a, 2)
    check_operand("b", b, 2)
    m, k = a.shape
    n, k2 = b.shape
    if k != k2 or a.dtype != b.dtype:
        raise ValueError(f"fused TNN operands mismatch: {tuple(a.shape)} {a.dtype} @ "
                         f"{tuple(b.shape)}^T {b.dtype}")
    if route(a, b) == "plain":
        return ref.matmul_tnn_fused(a, b)
    if n > _MAX_N:
        raise ValueError(f"fused TNN kernel takes at most {_MAX_N} columns, got {n}")
    c = torch.empty((m, n), dtype=a.dtype, device=a.device)
    if c.numel():
        _build.launch(
            "matmul_tnn_fused", "repro_matmul_tnn_fused", _build.ptr(a), _build.ptr(b),
            _build.ptr(c), m, n, k, _build.dtype_code(a.dtype), _build.stream_of(a),
        )
        LAUNCHES["matmul_tnn_fused"] += 1
    return c
