"""Out-of-place transpose B:(n, k) -> B^T:(k, n), stage 1 of the paper's
TNN.

Replaces the Pallas kernel ``repro/kernels/transpose.py:64``.  On a CUDA
tensor the wrapper launches ``csrc/transpose.cu`` (32x32 shared-memory
tiles with a padding column: coalesced reads and writes, bit-exact); on a
CPU tensor it runs the plain version in ``ref.py``.  Bound on the H100:
bytes (each element read and written once); the shared-memory tile keeps
both the read and the write coalesced.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build, ref
from .common import LAUNCHES, check_operand, route, validate_config

__all__ = ["transpose"]

_MAX_ROWS = 65535 * 32  # gridDim.y of the 32-row tiles


def transpose(b: torch.Tensor, *, block: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """B:(n, k) -> B^T:(k, n), contiguous, in B's dtype.

    ``block`` is validated as a (b_rows, b_cols) tile config; the CUDA
    kernel's tile is fixed at 32x32, so the config does not change it."""
    if block is not None:
        validate_config(block, arity=2)
    check_operand("b", b, 2)
    if route(b) == "plain":
        return ref.transpose(b)
    n, k = b.shape
    if n > _MAX_ROWS:
        raise ValueError(f"transpose kernel takes at most {_MAX_ROWS} rows, got {n}")
    out = torch.empty((k, n), dtype=b.dtype, device=b.device)
    if b.numel():
        _build.launch(
            "transpose", "repro_transpose", _build.ptr(b), _build.ptr(out), n, k,
            _build.dtype_code(b.dtype), _build.stream_of(b),
        )
        LAUNCHES["transpose"] += 1
    return out
