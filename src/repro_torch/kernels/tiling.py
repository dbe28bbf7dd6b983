"""Tile-config space of the port's CUDA kernels: the selector's tile
dimension on Hopper.

The JAX package's ``kernels/tiling.py`` enumerates (bm, bn, bk) VMEM tiles
for Pallas kernels that take any MXU-aligned tile.  A CUDA kernel here is
compiled for a few tiles only, and each wrapper already chooses among its
compiled instances and plans with a cost model of its own when it is given
no config.  So a config of the port is a tile tuple that one of those
instances or plans launches, and a kernel's space at a shape is the plans
that the route of that shape can launch:

  kernel            route (dtype, shape)      config            knob
  transpose         any                       (b_rows, b_cols)  instance: {32, 64}^2
  matmul_nt         bf16 (swap-AB mma.sync)   (MA, 128, bk)     bk: k per split, 64 | bk
  matmul_nt, _nn    f32 aligned, m <= 16 or   (16, 128, bk) or  bk: k per split, 16 | bk
                    n <= 64 (skinny)          (128, 16, bk)
                    f32 aligned (tiled)       (128, 128, bk)    bk: k per split, 16 | bk
                    f32 other (FMA)           (16|64, 64, 32)   none
  matmul_nn         bf16, m > 64 (wgmma)      (128, BN, bk)     BN: 64/128/192/256; bk: k per split
                    bf16, m <= 64 (skinny)    (MA, 128, bk)     bk: k per split, 64 | bk
                    bf16 unaligned (FMA)      (16|64, 64, 32)   none
  matmul_tnn_fused  bf16, k % 8 == 0 (wgmma)  (128, BN, 64)     BN: 64/96/192/256
                    bf16 other (mma.sync)     (64, 64, 32)      none
                    f32 aligned, m <= 16 or   (16, 128, bk) or  bk: k per split, 16 | bk
                    n <= 64 (f32_skinny)      (128, 16, bk)
                    f32 aligned (f32_tiled)   (128, 128, bk)    bk: k per split, 16 | bk
                    f32 other (FMA)           (64, 64, 32)      none
  matmul_bnt/bnn    f32 aligned (tiled)       (64, 64, bk)      bk: k per split, 16 | bk
                    bf16 aligned (mma.sync)   (64, 64, 64)      none
                    other (FMA)               (16|64, 64, 32)   none
  attention_fused   m <= 16 (decode_split)    (MR, bk)          bk: keys per split, 16 | bk, >= 32
                    flash_mma                 (64, 64)          none
                    flash_f32                 (64, 64), or      none
                                              (64, 32) above
                                              d_head 64
                    fma                       (16, 32)          none

MA is the A-row instance (8, 16, 32 or 64) that min(m, 64) takes; MR the
split kernel's row instance (4 for m <= 4, else 16).  Each wrapper has one
function that lists its route's plans at a shape as (config, plan) pairs,
the plan of its cost model first (``nt_plans``, ``nn_plans``,
``tnn_fused_plans``, ``batched_plans``, ``attention_plans``): the
instances and, for a split knob, the cost model's split and 1, 2, 4, 8,
... splits that the k (or key) extent allows.  ``tile_plans`` reaches them
by kernel name; the space, the default and feasibility all come from that
list, and the wrapper raises ``ValueError`` on a config it does not hold.
Nothing falls back to the default.  Every compiled instance fits the
227 KB of shared memory one Hopper block may hold: ``wgmma_smem_bytes``
states the footprint of the wgmma instances, which hold the most (the
block sweep, ``benchmarks/beyond_paper.py``, reports it beside each
config, and the contract pass, ``analysis/contracts.py``, holds every
enumerated plan to ``SMEM_PER_BLOCK``).

The route depends on the operands' alignment as well as on the shape.
The spaces here are those of 16-byte aligned operands, as a fresh
allocation is; ``aligned=False`` gives the route of operands that are not.
``shortlist_tile_configs`` / ``attn_config_space`` rank a space by the
port's roofline (``core/simulate.py``, the H100 spec by default) and
leave out the default plan: measurement times that one under
``"default"``.  ``transpose_config_space`` ranks all four transpose
instances: (32, 32) is the one a call with no config launches.

Config keys keep the JAX package's ``BMxBNxBK`` / ``BQxBK`` form, so
measurement caches and selector artifacts of both packages share them.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from . import attention_fused, matmul_batched, matmul_nn, matmul_nt, matmul_tnn_fused
from .common import (
    DEFAULT_CONFIG_KEY,
    H100_SMS,
    config_key,
    parse_config_key,
    validate_config,
)
from .transpose import TRANSPOSE_INSTANCES, check_transpose_config

__all__ = [
    "TileConfig",
    "TransposeConfig",
    "AttnConfig",
    "DEFAULT_CONFIG_KEY",
    "H100_SMS",
    "TUNABLE_KERNELS",
    "config_key",
    "parse_config_key",
    "validate_config",
    "tile_plans",
    "enumerate_tile_configs",
    "default_config",
    "config_feasible",
    "shortlist_tile_configs",
    "attn_config_space",
    "TRANSPOSE_INSTANCES",
    "check_transpose_config",
    "transpose_config_space",
    "SMEM_PER_BLOCK",
    "wgmma_smem_bytes",
]

TileConfig = Tuple[int, int, int]
TransposeConfig = Tuple[int, int]
AttnConfig = Tuple[int, int]

# The kernels whose wrappers take a tile config other than the transpose's.
TUNABLE_KERNELS = ("matmul_nt", "matmul_nn", "matmul_tnn_fused", "matmul_bnt", "matmul_bnn",
                   "attention_fused")

_DTYPES = {2: torch.bfloat16, 4: torch.float32}

# The most shared memory one block may hold on Hopper (sm_90: 227 KB of
# the SM's 228 KB).
SMEM_PER_BLOCK = 227 * 1024


def wgmma_smem_bytes(bn: int) -> int:
    """Shared memory of one block of the NN and fused TNN kernels' wgmma
    instance of width ``bn`` (csrc ``WgCfg``): the TMA ring of 128 x 64 A
    and bn x 64 B bf16 stages (3 at bn 256, else 4), the two warpgroups'
    64 x (bn + 8) epilogue tiles, a 1 KiB alignment pad and the ring's
    barriers."""
    stages = 3 if bn == 256 else 4
    return 1024 + stages * (128 * 64 + bn * 64) * 2 + 2 * 64 * (bn + 8) * 2 + 2 * stages * 8


def tile_plans(kernel: str, m: int, n: int, k: int, dsize: int = 4, g: int = 1,
               aligned: bool = True, sms: int = H100_SMS):
    """``kernel``'s (config, plan) pairs at this shape and element size,
    the plan a call with no config launches first.  For the attention
    kernel (m, n, k) are (queries, keys, head dim)."""
    dt = _DTYPES[int(dsize)]
    if kernel == "matmul_nt":
        return matmul_nt.nt_plans(m, n, k, dt, aligned, sms)
    if kernel == "matmul_nn":
        return matmul_nn.nn_plans(m, n, k, dt, aligned, sms)
    if kernel == "matmul_tnn_fused":
        return matmul_tnn_fused.tnn_fused_plans(m, n, k, dt, aligned, sms)
    if kernel in ("matmul_bnt", "matmul_bnn"):
        return matmul_batched.batched_plans(dt, g, m, n, k, kernel == "matmul_bnt", aligned, sms)
    if kernel == "attention_fused":
        return attention_fused.attention_plans(dt, g, m, n, k, aligned, sms)
    raise ValueError(f"no tile space for kernel {kernel!r}; have {TUNABLE_KERNELS}")


def enumerate_tile_configs(kernel: str, m: int, n: int, k: int, dsize: int = 4, g: int = 1,
                           aligned: bool = True) -> Tuple[Tuple[int, ...], ...]:
    """Every config of ``kernel``'s space at this shape, the default
    plan's included, sorted."""
    return tuple(sorted(c for c, _ in tile_plans(kernel, m, n, k, dsize, g, aligned)))


def default_config(kernel: str, m: int, n: int, k: int, dsize: int = 4, g: int = 1,
                   sms: int = H100_SMS) -> Tuple[int, ...]:
    """The config of the plan ``kernel``'s cost model launches with none."""
    return tile_plans(kernel, m, n, k, dsize, g, sms=sms)[0][0]


def config_feasible(kernel: str, config: Sequence[int], m: int, n: int, k: int,
                    dsize: int = 4, g: int = 1, aligned: bool = True) -> bool:
    """Whether ``kernel``'s wrapper launches ``config`` at this shape for
    operands that are (or with ``aligned=False`` are not) 16-byte
    aligned; it raises ``ValueError`` on the configs this says no to."""
    if kernel == "transpose":
        return tuple(config) in TRANSPOSE_INSTANCES
    return tuple(config) in dict(tile_plans(kernel, m, n, k, dsize, g, aligned))


def _ranked(configs, default, time_of, max_configs: int):
    ranked = sorted((c for c in configs if c != default), key=time_of)
    if max_configs > 0:
        ranked = ranked[:max_configs]
    return tuple(ranked)


def shortlist_tile_configs(kernel: str, m: int, n: int, k: int, dsize: int = 4, g: int = 1,
                           max_configs: int = 4, hardware=None) -> Tuple[TileConfig, ...]:
    """The autotune sweep list of a GEMM ``kernel`` at this shape: its
    space without the default plan (timed under ``"default"``), ranked by
    the roofline of ``hardware`` (default the H100 spec) and cut to
    ``max_configs`` (``<= 0``: no cut)."""
    from repro_torch.core.hardware import H100
    from repro_torch.core.simulate import gemm_plan_time

    hw = hardware or H100
    plans = dict(tile_plans(kernel, m, n, k, dsize, g, sms=hw.num_cores))
    dflt = next(iter(plans))
    return _ranked(plans, dflt, lambda c: gemm_plan_time(hw, m, n, k, dsize, c[:2],
                                                         splits=plans[c][2], g=g),
                   max_configs)


def attn_config_space(m: int, n: int, dh: int, dsize: int = 4, max_configs: int = 4,
                      hardware=None, g: int = 1) -> Tuple[AttnConfig, ...]:
    """The fused-attention autotune sweep list: the route's (bq, bk) plans
    other than the default, ranked by the roofline attention model
    (``simulate.attn_plan_time``) and cut to ``max_configs``."""
    from repro_torch.core.hardware import H100
    from repro_torch.core.simulate import attn_plan_time

    hw = hardware or H100
    plans = tile_plans("attention_fused", m, n, dh, dsize, g, sms=hw.num_cores)
    return _ranked([c for c, _ in plans], plans[0][0],
                   lambda c: attn_plan_time(hw, g, m, n, dh, dsize, c), max_configs)


def transpose_config_space(rows: int, cols: int, dsize: int = 4, max_configs: int = 4,
                           hardware=None) -> Tuple[TransposeConfig, ...]:
    """The transpose autotune sweep list: every instance, (32, 32) (the
    default's) included, ranked by the roofline transpose model
    (``simulate.transpose_tile_time``) and cut to ``max_configs``."""
    from repro_torch.core.hardware import H100
    from repro_torch.core.simulate import transpose_tile_time

    hw = hardware or H100
    return _ranked(TRANSPOSE_INSTANCES, None,
                   lambda c: transpose_tile_time(hw, rows, cols, dsize, c), max_configs)
