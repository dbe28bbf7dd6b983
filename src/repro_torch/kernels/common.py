"""Shared helpers of the port's kernel wrappers: tile-config validation,
operand checks, routing by device and the launch counters.

Routing rule of every wrapper: an operand on the CPU runs the kernel's
plain PyTorch version (``ref.py``); an operand on a CUDA device launches
the CUDA kernel or raises; anything else raises.  The checks on dtype,
rank and contiguity run first on both routes, so the CPU tests see the
same rejections as the card.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

__all__ = [
    "cdiv",
    "DEFAULT_CONFIG_KEY",
    "config_key",
    "parse_config_key",
    "validate_config",
    "KERNEL_DTYPES",
    "check_operand",
    "route",
    "LAUNCHES",
    "reset_launches",
]

TileConfig = Tuple[int, ...]

DEFAULT_CONFIG_KEY = "default"

# The dtypes the CUDA kernels take.
KERNEL_DTYPES = (torch.float32, torch.bfloat16)

# Launches of each CUDA kernel: a wrapper adds one where it launches its
# kernel and nowhere else, so a run can show which kernels its path used.
LAUNCHES: Dict[str, int] = {
    "transpose": 0,
    "matmul_nn": 0,
    "matmul_nt": 0,
    "attention_fused": 0,
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def config_key(config: Optional[TileConfig]) -> str:
    """Stable string form used in dispatch reports."""
    if config is None:
        return DEFAULT_CONFIG_KEY
    return "x".join(str(int(b)) for b in config)


def parse_config_key(key: str, arity: int = 3):
    """Inverse of ``config_key``; ``'default'`` maps to None."""
    if key == DEFAULT_CONFIG_KEY:
        return None
    try:
        parts = tuple(int(p) for p in key.split("x"))
    except ValueError:
        raise ValueError(f"malformed tile-config key {key!r}") from None
    if len(parts) != arity or any(p <= 0 for p in parts):
        raise ValueError(f"malformed tile-config key {key!r}")
    return parts


def validate_config(config: Sequence[int], arity: int = 3) -> TileConfig:
    """A well-formed tile tuple of positive ints, or ValueError.  Arity 3
    is a GEMM's (bm, bn, bk), arity 2 the attention (bq, bk) or the
    transpose (b_rows, b_cols)."""
    config = tuple(config)
    if len(config) != arity:
        kinds = {2: "(bq, bk)", 3: "(bm, bn, bk)"}.get(arity, f"{arity} ints")
        raise ValueError(f"tile config {config} must be {kinds}")
    for b in config:
        if not isinstance(b, int) or isinstance(b, bool) or b <= 0:
            raise ValueError(f"tile config {config} must be positive ints")
    return config


def check_operand(name: str, x, ndim: int) -> None:
    """Raise on an operand a kernel does not take: not a tensor, wrong
    rank, a dtype other than f32/bf16, or a non-contiguous layout."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(x).__name__}")
    if x.ndim != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape {tuple(x.shape)}")
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"{name} has dtype {x.dtype}; kernels take {KERNEL_DTYPES}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous (row-major)")


def route(*tensors: torch.Tensor) -> str:
    """``"plain"`` for CPU operands, ``"kernel"`` for CUDA operands; raises
    on mixed devices or any other device type."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"operands lie on different devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        return "plain"
    if dev.type == "cuda":
        if dev.index is not None and dev.index != torch.cuda.current_device():
            raise RuntimeError(
                f"operands lie on {dev}, but kernels launch on the current "
                f"device cuda:{torch.cuda.current_device()}"
            )
        return "kernel"
    raise RuntimeError(f"no kernel for device {dev}")
