"""Public wrappers over the port's kernels (the candidate registry's
kernel arms call these).

  matmul_nn    C = A @ B      one blocked kernel
  matmul_nt    C = A @ B^T    direct NT, tile turned around in shared memory
  matmul_tnn   C = A @ B^T    the paper's TNN: transpose kernel + NN kernel
  matmul_tn    C = A^T @ B    weight-gradient TN: transpose kernel + NN kernel
  transpose    B^T            out-of-place, bandwidth-bound

The two-kernel schedules take an optional ``tblock=(b_rows, b_cols)`` for
their transpose stage, as in the JAX package; by default it derives from
the matmul ``block``.  Both are validated as tile configs.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .common import validate_config
from .matmul_nn import matmul_nn
from .matmul_nt import matmul_nt
from .transpose import transpose

__all__ = ["transpose", "matmul_nn", "matmul_nt", "matmul_tnn", "matmul_tn"]


def matmul_tnn(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    block: Optional[Tuple[int, int, int]] = None,
    tblock: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """The paper's TNN (Algorithm 1): out-of-place transpose of B, then NN.
    Two launches; B^T round-trips through device memory."""
    tb = tblock
    if block is not None:
        block = validate_config(block)
        if tb is None:
            tb = (block[1], block[2])
    return matmul_nn(a, transpose(b, block=tb), block=block)


def matmul_tn(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    block: Optional[Tuple[int, int, int]] = None,
    tblock: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """TN (weight gradient): C = A^T @ B, A:(k,m), B:(k,n) -> (m,n), as an
    out-of-place transpose of A followed by NN."""
    tb = tblock
    if block is not None:
        block = validate_config(block)
        if tb is None:  # A:(k,m) tiles as (contraction, output-m)
            tb = (block[2], block[0])
    return matmul_nn(transpose(a, block=tb), b, block=block)
