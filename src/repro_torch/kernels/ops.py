"""Public wrappers over the port's kernels (the candidate registry's
kernel arms call these).

  matmul_nn    C = A @ B      one kernel: wgmma (wide), swap-AB mma.sync (skinny) or FMA
  matmul_nt    C = A @ B^T    direct NT: B's stored rows are the tensor-core operand
  matmul_tnn   C = A @ B^T    the paper's TNN: transpose kernel + NN kernel
  matmul_tn    C = A^T @ B    weight-gradient TN: transpose kernel + NN kernel
  matmul_tnn_fused  C = A @ B^T  one kernel consuming B's stored layout
  matmul_bnt   C_i = A_i @ B_i^T  batched NT (attention logits, dP)
  matmul_bnn   C_i = A_i @ B_i    batched NN (probs @ V, dQ, dK, dV)
  transpose    B^T            out-of-place, bandwidth-bound

Tile configs (``kernels/tiling.py``): the two-kernel schedules pass
``block`` to their NN kernel and ``tblock=(b_rows, b_cols)``, one of the
transpose kernel's instances, to their transpose stage.  A GEMM tile names
no transpose instance, so ``tblock`` does not derive from ``block`` (the
JAX package derives it); None runs each kernel's own plan.  Each wrapper
raises on a config it has no plan for.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .matmul_batched import matmul_bnn, matmul_bnt
from .matmul_nn import matmul_nn
from .matmul_nt import matmul_nt
from .matmul_tnn_fused import matmul_tnn_fused
from .transpose import transpose

__all__ = ["transpose", "matmul_nn", "matmul_nt", "matmul_tnn", "matmul_tn",
           "matmul_tnn_fused", "matmul_bnt", "matmul_bnn"]


def matmul_tnn(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    block: Optional[Tuple[int, int, int]] = None,
    tblock: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """The paper's TNN (Algorithm 1): out-of-place transpose of B, then NN.
    Two launches; B^T round-trips through device memory."""
    return matmul_nn(a, transpose(b, block=tblock), block=block)


def matmul_tn(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    block: Optional[Tuple[int, int, int]] = None,
    tblock: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """TN (weight gradient): C = A^T @ B, A:(k,m), B:(k,n) -> (m,n), as an
    out-of-place transpose of A followed by NN."""
    return matmul_nn(transpose(a, block=tblock), b, block=block)
