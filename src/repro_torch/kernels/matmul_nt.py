"""Direct NT matmul: C = A @ B^T, A:(m, k), B:(n, k) -- the direct arm.

Replaces the Pallas kernel ``repro/kernels/matmul_nt.py:81``.  On CUDA
tensors the wrapper launches the NT instance of ``csrc/matmul.cu``, which
reads B in its stored (n, k) layout and turns each tile around in shared
memory (the structural NT cost this arm exists to expose); on CPU
tensors it runs the plain version in ``ref.py``.  Bound on the H100 at the
serving shapes: bytes, as for NN; B's tile is read along k (coalesced)
and turned around in shared memory at no extra device-memory traffic.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import ref
from .common import LAUNCHES, check_operand, route, validate_config
from .matmul_nn import launch_matmul

__all__ = ["matmul_nt"]


def matmul_nt(
    a: torch.Tensor, b: torch.Tensor, *, block: Optional[Tuple[int, int, int]] = None
) -> torch.Tensor:
    """C = A @ B^T in A's dtype, f32 accumulation.  ``block`` is validated
    as a (bm, bn, bk) tile config; the CUDA kernel picks its own tiles."""
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
    c = launch_matmul(a, b, m, n, k, b_stored_nk=True)
    if c.numel():
        LAUNCHES["matmul_nt"] += 1
    return c
