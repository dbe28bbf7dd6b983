"""Batched matmuls over a leading batch axis -- the attention contractions:

  matmul_bnt  C_i = A_i @ B_i^T   A:(g, m, k)  B:(g, n, k)  ->  (g, m, n)
  matmul_bnn  C_i = A_i @ B_i     A:(g, m, k)  B:(g, k, n)  ->  (g, m, n)

Replace the Pallas kernel ``repro/kernels/matmul_batched.py:124``
(``_matmul_batched``, behind ``matmul_bnt`` and ``matmul_bnn``).  On CUDA
tensors the wrappers launch ``csrc/matmul_batched.cu``: one block per
(slice, output tile), ``blockIdx.z`` the slice, a k loop inside the block,
f32 accumulation, a 16-row tile for m <= 16.  On CPU tensors they run the
plain versions in ``ref.py``.  Bound on the H100: operations for the
training backward's f32 contractions, bytes at decode.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build, ref
from .common import LAUNCHES, check_operand, route, validate_config

__all__ = ["matmul_bnt", "matmul_bnn"]

_MAX_G = 65535  # gridDim.z
_MAX_M = 65535 * 16  # gridDim.y of the smallest row tile


def _batched(a: torch.Tensor, b: torch.Tensor, nt: bool, block) -> torch.Tensor:
    if block is not None:
        validate_config(block)
    check_operand("a", a, 3)
    check_operand("b", b, 3)
    g, m, k = a.shape
    g2, n, k2 = b.shape if nt else (b.shape[0], b.shape[2], b.shape[1])
    if g != g2 or k != k2 or a.dtype != b.dtype:
        raise ValueError(f"batched operands mismatch: {tuple(a.shape)} {a.dtype} vs "
                         f"{tuple(b.shape)} {b.dtype} ({'BNT' if nt else 'BNN'})")
    if route(a, b) == "plain":
        return ref.matmul_bnt(a, b) if nt else ref.matmul_bnn(a, b)
    if g > _MAX_G:
        raise ValueError(f"batched kernel takes at most {_MAX_G} slices, got {g}")
    if m > _MAX_M:
        raise ValueError(f"batched kernel takes at most {_MAX_M} rows, got {m}")
    c = torch.empty((g, m, n), dtype=a.dtype, device=a.device)
    if c.numel():
        _build.launch(
            "matmul_batched", "repro_matmul_batched", _build.ptr(a), _build.ptr(b),
            _build.ptr(c), g, m, n, k, int(nt), _build.dtype_code(a.dtype),
            _build.stream_of(a),
        )
        LAUNCHES["matmul_bnt" if nt else "matmul_bnn"] += 1
    return c


def matmul_bnt(
    a: torch.Tensor, b: torch.Tensor, *, block: Optional[Tuple[int, int, int]] = None
) -> torch.Tensor:
    """Batched NT in A's dtype, f32 accumulation.  ``block`` is validated as
    a (bm, bn, bk) tile config; the CUDA kernel picks its own tiles."""
    return _batched(a, b, True, block)


def matmul_bnn(
    a: torch.Tensor, b: torch.Tensor, *, block: Optional[Tuple[int, int, int]] = None
) -> torch.Tensor:
    """Batched NN in A's dtype, f32 accumulation.  ``block`` is validated as
    a (bm, bn, bk) tile config; the CUDA kernel picks its own tiles."""
    return _batched(a, b, False, block)
