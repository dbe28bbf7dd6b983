"""Shared helpers of the port's kernel wrappers: tile-config keys and
plan lookup, operand checks, routing by device, the launch counters, the
card's SM count, and the f32 and FMA GEMMs of ``csrc/matmul.cu`` that the
NN and NT wrappers share (``f32_plans``, ``launch_matmul_f32``,
``launch_matmul``).

Routing rule of every wrapper: an operand on the CPU runs the kernel's
plain PyTorch version (``ref.py``); an operand on a CUDA device launches
the CUDA kernel or raises; anything else raises.  The checks on dtype,
rank and contiguity run first on both routes, so the CPU tests see the
same rejections as the card.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Sequence, Tuple

import torch

from . import _build

__all__ = [
    "cdiv",
    "sm_count",
    "launch_matmul",
    "launch_matmul_f32",
    "fma_tile",
    "f32_plans",
    "f32_split",
    "H100_SMS",
    "DEFAULT_CONFIG_KEY",
    "config_key",
    "parse_config_key",
    "validate_config",
    "TileConfigError",
    "split_choices",
    "pick_plan",
    "KERNEL_DTYPES",
    "check_operand",
    "route",
    "LAUNCHES",
    "ATTENTION_ROUTES",
    "GEMM_ROUTES",
    "CONFIG_LAUNCHES",
    "count_launch",
    "reset_launches",
]

TileConfig = Tuple[int, ...]

# Cache/report key for "the candidate ran its own plan" -- every non-tunable
# candidate, and a tunable one given no config (its wrapper's cost model).
DEFAULT_CONFIG_KEY = "default"

# An H100 SXM's SM count: the cost models' default where no card is asked.
H100_SMS = 132

# The dtypes the CUDA kernels take.
KERNEL_DTYPES = (torch.float32, torch.bfloat16)

# Launches of each CUDA kernel: a wrapper adds one where it launches its
# kernel and nowhere else, so a run can show which kernels its path used.
LAUNCHES: Dict[str, int] = {
    "transpose": 0,
    "matmul_nn": 0,
    "matmul_nt": 0,
    "attention_fused": 0,
    "matmul_tnn_fused": 0,
    "matmul_bnt": 0,
    "matmul_bnn": 0,
}


# Launches of the attention kernel by route and head dim, e.g.
# ("decode_split", 256): the wrapper adds one beside its LAUNCHES count.
ATTENTION_ROUTES: Dict[Tuple[str, int], int] = {}


# Launches of the NN, NT and fused TNN wrappers by route and dtype, e.g.
# ("matmul_nn", "tiled", "float32") or ("matmul_tnn_fused", "f32_skinny",
# "float32"): the wrapper adds one beside its LAUNCHES count.
GEMM_ROUTES: Dict[Tuple[str, str, str], int] = {}


# Launches of each CUDA kernel by the tile config its wrapper was given,
# e.g. ("matmul_nn", "128x192x512") or ("transpose", "default"): a run can
# show that a tuned config reached its kernel.
CONFIG_LAUNCHES: Dict[Tuple[str, str], int] = {}


def count_launch(name: str, block=None,
                 gemm_route: Optional[Tuple[str, torch.dtype]] = None) -> None:
    """Count one launch of kernel ``name`` at config ``block`` (None: the
    wrapper's own plan), and for the GEMM wrappers under ``gemm_route``
    (route, dtype); wrappers call it where they launch, nowhere else."""
    LAUNCHES[name] += 1
    key = (name, config_key(block))
    CONFIG_LAUNCHES[key] = CONFIG_LAUNCHES.get(key, 0) + 1
    if gemm_route is not None:
        rkey = (name, gemm_route[0], str(gemm_route[1]).split(".")[-1])
        GEMM_ROUTES[rkey] = GEMM_ROUTES.get(rkey, 0) + 1


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    ATTENTION_ROUTES.clear()
    GEMM_ROUTES.clear()
    CONFIG_LAUNCHES.clear()


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The SM count of CUDA device ``index`` (132 on an H100 SXM)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


_FMA_MAX_M = 65535 * 16  # csrc/matmul.cu: gridDim.y of the smallest row tile


def fma_tile(m: int) -> Tuple[int, int, int]:
    """The one tile of the FMA kernels (``csrc/matmul.cu``, and the batched
    FMA kernel of ``csrc/matmul_batched.cu``): 16 or 64 rows as m asks, 64
    columns, 32 of k per stage."""
    return (16 if m <= 16 else 64, 64, 32)


def launch_matmul(a: torch.Tensor, b: torch.Tensor, m: int, n: int, k: int,
                  b_stored_nk: bool) -> torch.Tensor:
    """Allocate C and launch the FMA kernel of ``csrc/matmul.cu``
    (``repro_matmul``): NN, or NT with ``b_stored_nk``, in f32 or bf16.
    The NN and NT wrappers route to it; it counts no launch itself."""
    if m > _FMA_MAX_M:
        raise ValueError(f"matmul kernel takes at most {_FMA_MAX_M} rows, got {m}")
    c = torch.empty((m, n), dtype=a.dtype, device=a.device)
    if c.numel():
        _build.launch(
            "matmul", "repro_matmul", _build.ptr(a), _build.ptr(b), _build.ptr(c),
            m, n, k, int(b_stored_nk), _build.dtype_code(a.dtype), _build.stream_of(a),
        )
    return c


# The f32 kernel of csrc/matmul.cu (gemm_f32): its tiles (bm, bn) by route,
# its k-step (the unit of a split), and the most splits its reduce sums.
_F32_TILED = (128, 128)
_F32_SKINNY_ROWS = (16, 128)  # m <= 16: B, the long operand, streamed once
_F32_SKINNY_COLS = (128, 16)  # n <= 64: A streamed once
_F32_BK = 16
_F32_MAX_SPLITS = 32
_F32_MAX_M_TILES = 65535  # gridDim.y
# The split's cost model, in us on an H100: a 16-deep k-step of one block
# alone on its SM, at 60 % of its share of the f32 FMA rate or at its share
# of ~3 TB/s, whichever is slower; a split's reduce launch and the partials'
# bytes (written, read back) at ~3 TB/s.
_F32_FLOPS_PER_US = 0.6 * 67e6
_BYTES_PER_US = 3.0e6
_US_REDUCE = 3.0


def f32_route(m: int, n: int, k: int, nt: bool, aligned: bool) -> str:
    """``"tiled"``, ``"skinny"`` or ``"fma"`` for f32 operands: the first
    two need k (and NN's n, B's row length) a multiple of 4 floats and A
    and B 16-byte aligned (``aligned``)."""
    if not (aligned and k > 0 and k % 4 == 0 and (nt or n % 4 == 0)):
        return "fma"
    return "skinny" if m <= 16 or n <= 64 else "tiled"


def _f32_tile(m: int, n: int, variant: str) -> Tuple[int, int]:
    if variant == "tiled":
        return _F32_TILED
    return _F32_SKINNY_ROWS if m <= 16 else _F32_SKINNY_COLS


@functools.lru_cache(maxsize=None)  # a model repeats a few shapes on every step
def f32_split(m: int, n: int, k: int, bm: int, bn: int, sms: int) -> Tuple[int, int]:
    """(splits, 16-deep k-steps per split) of the f32 kernel at tile (bm,
    bn): the pair whose waves of (tile, split) blocks over ``sms`` SMs,
    plus the split's reduce and partials, cost least; at most 32 splits,
    none empty.  A pure function of the shape (k > 0) and the SM count."""
    steps = cdiv(k, _F32_BK)
    tiles = cdiv(m, bm) * cdiv(n, bn)
    step_us = max(2.0 * bm * bn * _F32_BK / (_F32_FLOPS_PER_US / sms),
                  4.0 * (bm + bn) * _F32_BK / (_BYTES_PER_US / sms))
    best = None
    for want in range(1, min(steps, _F32_MAX_SPLITS) + 1):
        per = cdiv(steps, want)
        splits = cdiv(steps, per)
        us = cdiv(tiles * splits, sms) * per * step_us
        if splits > 1:
            us += _US_REDUCE + (8 * splits + 4) * m * n / _BYTES_PER_US
        if best is None or us < best[0]:
            best = (us, splits, per)
    return best[1:]


@functools.lru_cache(maxsize=None)
def f32_plans(m: int, n: int, k: int, nt: bool, aligned: bool = True, sms: int = H100_SMS):
    """The (config, plan) pairs of an f32 NT (``nt``) or NN shape's route,
    the cost model's first.  A plan is ``(variant, (bm, bn), splits,
    k-steps per split)`` -- ``"tiled"`` or ``"skinny"`` (``gemm_f32``) --
    or ``("fma", None, 1, 1)``.  A config is (bm, bn, bk): the route's one
    tile and the k of a split (the cost model's, and that of 1, 2, 4, ...
    up to 32 splits)."""
    variant = f32_route(m, n, k, nt, aligned)
    if variant == "fma":
        return ((fma_tile(m), ("fma", None, 1, 1)),)
    bm, bn = _f32_tile(m, n, variant)
    steps = cdiv(k, _F32_BK)
    pers = (f32_split(m, n, k, bm, bn, sms)[1],) + split_choices(steps, _F32_MAX_SPLITS)
    plans = {(bm, bn, per * _F32_BK): (variant, (bm, bn), cdiv(steps, per), per)
             for per in pers}
    return tuple(plans.items())


def launch_matmul_f32(a: torch.Tensor, b: torch.Tensor, m: int, n: int, k: int,
                      b_stored_nk: bool, plan: tuple) -> torch.Tensor:
    """Allocate C (and the split's f32 partials) and launch ``gemm_f32``
    of ``csrc/matmul.cu`` (``repro_matmul_f32``) at an f32 plan of
    ``f32_plans``.  The NN and NT wrappers route to it; it counts no launch
    itself."""
    _, (bm, bn), splits, per = plan
    if cdiv(m, bm) > _F32_MAX_M_TILES:
        raise ValueError(f"f32 matmul kernel takes at most {_F32_MAX_M_TILES * bm} rows, got {m}")
    c = torch.empty((m, n), dtype=a.dtype, device=a.device)
    if c.numel():
        ws = (torch.empty((splits, m, n), dtype=torch.float32, device=a.device)
              if splits > 1 else None)
        _build.launch(
            "matmul", "repro_matmul_f32", _build.ptr(a), _build.ptr(b), _build.ptr(c),
            _build.ptr(ws) if ws is not None else ctypes.c_void_p(None), m, n, k,
            int(b_stored_nk), bm, bn, splits, per, _build.stream_of(a),
        )
    return c


def config_key(config: Optional[TileConfig]) -> str:
    """Stable string form used in measurement-cache entries and reports."""
    if config is None:
        return DEFAULT_CONFIG_KEY
    return "x".join(str(int(b)) for b in config)


def parse_config_key(key: str, arity: int = 3):
    """Inverse of ``config_key``; ``'default'`` maps to None.  ``arity`` is
    the expected tuple length -- 3 for the GEMM tiles, 2 for the transpose
    kernel's (b_rows, b_cols) and the attention kernel's (bq, bk)."""
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
        kinds = "(bq, bk)" if arity == 2 else "(bm, bn, bk)"
        raise ValueError(f"tile config {config} must be {kinds}")
    for b in config:
        if not isinstance(b, int) or isinstance(b, bool) or b <= 0:
            raise ValueError(f"tile config {config} must be positive ints")
    return config


def split_choices(steps: int, max_splits: Optional[int] = None) -> Tuple[int, ...]:
    """Units per split for 1, 2, 4, 8, ... splits of ``steps`` units (at
    most ``max_splits``), deepest first and without repeats."""
    pers, s = [], 1
    while s <= max(1, steps) and (max_splits is None or s <= max_splits):
        per = cdiv(max(1, steps), s)
        if per not in pers:
            pers.append(per)
        s *= 2
    return tuple(pers)


class TileConfigError(ValueError):
    """A tile config that is not a plan of the route a call takes (or, for
    the transpose, not one of its instances).  Raised before any launch;
    the dispatch engine's fallback chain sheds the tile and runs the
    candidate's own plan instead."""


def pick_plan(plans: Tuple[Tuple[TileConfig, tuple], ...], block: Optional[TileConfig],
              what: str) -> tuple:
    """The plan of ``block`` in a route's ``(config, plan)`` pairs, the
    cost model's first (a plan's first item names the route): None picks
    that one; a config the route has no plan for raises ``ValueError``
    naming the route and its configs (``TileConfigError``)."""
    if block is None:
        return plans[0][1]
    for config, plan in plans:
        if config == block:
            return plan
    raise TileConfigError(f"{what}, {plans[0][1][0]} route, has no plan for tile {tuple(block)}; "
                     f"its configs: {[c for c, _ in plans]}")


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
