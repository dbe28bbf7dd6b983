"""Out-of-place transpose B:(n, k) -> B^T:(k, n), stage 1 of the paper's
TNN.

Replaces the Pallas kernel ``repro/kernels/transpose.py:64``.  On a CUDA
tensor the wrapper launches ``csrc/transpose.cu`` (shared-memory tiles
with a padding column: coalesced reads and writes, bit-exact); on a CPU
tensor it runs the plain version in ``ref.py``.  Bound on the H100: bytes
(each element read and written once); the shared-memory tile keeps both
the read and the write coalesced.

The kernel is compiled for the (b_rows, b_cols) tiles of
``TRANSPOSE_INSTANCES`` ({32, 64}^2).  ``block=None`` launches the 32x32
one; ``block=(b_rows, b_cols)`` launches that instance; any other tile
raises ``ValueError`` naming the instances, on the CPU route too, before
the plain version runs.  ``transpose_grid_spec`` declares the launch:
block (x, y) moves the input tile at row-tile y, column-tile x.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import torch

from . import _build, ref
from .common import TileConfigError, cdiv, check_operand, count_launch, route, validate_config
from .gridspec import MAX_GRID_Y, BlockMap, KernelGridSpec, check_launch, dense_spec

__all__ = ["transpose", "TRANSPOSE_INSTANCES", "check_transpose_config", "transpose_grid_spec"]

# csrc/transpose.cu's instances: b_rows input rows x b_cols input columns
# per block.  The first is the one a call with no config launches.
TRANSPOSE_INSTANCES: Tuple[Tuple[int, int], ...] = ((32, 32), (32, 64), (64, 32), (64, 64))


def check_transpose_config(config: Sequence[int]) -> Tuple[int, int]:
    config = validate_config(config, arity=2)
    if config not in TRANSPOSE_INSTANCES:
        raise TileConfigError(f"transpose kernel has no {config[0]}x{config[1]} instance; "
                         f"instances (b_rows, b_cols): {TRANSPOSE_INSTANCES}")
    return config


@functools.lru_cache(maxsize=None)  # built once a shape: a wrapper runs it every call
def transpose_grid_spec(n: int, k: int,
                        block: Optional[Tuple[int, int]] = None) -> KernelGridSpec:
    """The transpose kernel's launch for B:(n, k) -> (k, n) at instance
    ``block`` (None: the 32x32 one): grid (cdiv(k, b_cols), cdiv(n,
    b_rows)); block (x, y) reads B's (b_rows, b_cols) tile (y, x) and
    writes B^T's (b_cols, b_rows) tile (x, y)."""
    br, bc = TRANSPOSE_INSTANCES[0] if block is None else check_transpose_config(block)
    return dense_spec(
        "transpose", (cdiv(k, bc), cdiv(n, br)),
        (BlockMap((br, bc), lambda x, y, z: (y, x), (n, k)),),
        BlockMap((bc, br), lambda x, y, z: (x, y), (k, n)))


def transpose(b: torch.Tensor, *, block: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """B:(n, k) -> B^T:(k, n), contiguous, in B's dtype.  ``block``: None
    (the 32x32 instance) or a (b_rows, b_cols) instance."""
    tile = TRANSPOSE_INSTANCES[0] if block is None else check_transpose_config(block)
    check_operand("b", b, 2)
    r = route(b)
    if r == "plain":
        return ref.transpose(b)
    n, k = b.shape
    if r == "meta":
        return b.new_empty((k, n))
    spec = transpose_grid_spec(n, k, tile)
    check_launch((spec,), f"transpose kernel takes at most {MAX_GRID_Y * tile[0]} rows, got {n}")
    out = torch.empty((k, n), dtype=b.dtype, device=b.device)
    if b.numel():
        _build.launch(
            "transpose", "repro_transpose", _build.ptr(b), _build.ptr(out), n, k, *tile,
            _build.dtype_code(b.dtype), *spec.launch, _build.stream_of(b),
        )
        count_launch("transpose", block)
    return out
