"""Blocked NN matmul: C = A @ B, A:(m, k), B:(k, n) -- stage 2 of TNN.

Replaces the Pallas kernel ``repro/kernels/matmul_nn.py:77``.  On CUDA
tensors the wrapper launches the NN instance of ``csrc/matmul.cu`` (one
block per output tile, a k loop inside the block, f32 accumulation); on
CPU tensors it runs the plain version in ``ref.py``.  Bound on the H100 at
the serving shapes: bytes (B is read once, m is small); the kernel picks
a 16-row tile for m <= 16 so decode does not compute empty rows.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build, ref
from .common import LAUNCHES, check_operand, route, validate_config

__all__ = ["matmul_nn", "launch_matmul"]

_MAX_M = 65535 * 16  # gridDim.y of the smallest row tile


def launch_matmul(a: torch.Tensor, b: torch.Tensor, m: int, n: int, k: int,
                  b_stored_nk: bool) -> torch.Tensor:
    """Allocate C and launch ``repro_matmul`` (shared by NN and NT)."""
    if m > _MAX_M:
        raise ValueError(f"matmul kernel takes at most {_MAX_M} rows, got {m}")
    c = torch.empty((m, n), dtype=a.dtype, device=a.device)
    if c.numel():
        _build.launch(
            "matmul", "repro_matmul", _build.ptr(a), _build.ptr(b), _build.ptr(c),
            m, n, k, int(b_stored_nk), _build.dtype_code(a.dtype), _build.stream_of(a),
        )
    return c


def matmul_nn(
    a: torch.Tensor, b: torch.Tensor, *, block: Optional[Tuple[int, int, int]] = None
) -> torch.Tensor:
    """C = A @ B in A's dtype, f32 accumulation.  ``block`` is validated as
    a (bm, bn, bk) tile config; the CUDA kernel picks its own tiles."""
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
    c = launch_matmul(a, b, m, n, k, b_stored_nk=False)
    if c.numel():
        LAUNCHES["matmul_nn"] += 1
    return c
