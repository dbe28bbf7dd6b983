"""Analytic cost model of the candidate algorithms — a roofline fed by
datasheet peaks, not a measurement of any card.

It is the zero-shot answer when no measured dataset exists for a device:
``AnalyticPolicy`` takes the argmin of its times, ``collect_analytic``
labels the paper grid with it, and the fallback selector trains on that
dataset.  The formulas and constants are the JAX package's, so both
packages give the same times for the same ``HardwareSpec``; measured times
on the H100 come from ``core/measure.py``.

Mechanics modelled:

  NT_DIRECT   one blocked kernel over grid (m/bm, n/bn, k/bk).  Every B
              block must be re-oriented for the matrix unit *inside* the
              kernel; because the k-strip of B is re-read for every
              m-tile, the per-block transpose cost is paid ceil(m/bm)
              times.  The matrix unit also runs at reduced efficiency for
              thin k.
  TNN         one out-of-place transpose kernel (bandwidth bound at
              ``transpose_bw_frac`` of peak, cf. Ruetsch & Micikevicius)
              + allocation overhead + a clean NN matmul kernel.
  TNN_FUSED   NT kernel whose in-kernel re-orientation is vectorised:
              cheaper per element than NT_DIRECT's naive path but still
              paid per m-tile.  (beyond-paper)
  XLA_DOT     what frameworks do today: the library picks a layout;
              modelled as NT_DIRECT with a modest constant improvement.

Timings include a deterministic multiplicative log-normal noise term
(sigma ~ 3%) keyed on (chip, algo, m, n, k) so that repeated dataset
builds are reproducible.
"""

from __future__ import annotations

import hashlib
import math
from typing import Tuple


from .hardware import HardwareSpec

__all__ = [
    "matmul_flops",
    "blocked_matmul_bytes",
    "tile_efficiency",
    "simulate_time",
    "fits_memory",
    "SIM_ALGOS",
    "OP_SIM_ALGOS",
    "gemm_plan_time",
    "transpose_tile_time",
    "attn_plan_time",
]

SIM_ALGOS = ("NT_DIRECT", "TNN", "TNN_FUSED", "XLA_DOT")

# Arms for the backward ops (opkey.OPS): the data-gradient NN is
# layout-clean; the weight-gradient TN either feeds the matrix unit with an
# in-kernel re-orientation of A (direct) or materialises A^T first (the
# paper's TNN move applied to the gradient).  The batched BNT/BNN arms
# model the attention contractions: ``g`` independent slices sharing one
# kernel launch, each slice with its op's per-slice mechanics.
# ``simulate_time`` accepts these in addition to SIM_ALGOS; the
# paper-grid dataset (collect_analytic) keeps sweeping only the NT arms.  The ATTN
# arms price the whole attention subgraph (Q K^T -> softmax -> probs V)
# at per-slice extents (m queries, n keys, k head-dim): FUSED streams
# k/v blocks through on-chip memory without materialising the (m, n)
# logits in HBM; UNFUSED is the two batched GEMMs plus an HBM round-trip
# of the logits for the softmax.
OP_SIM_ALGOS = (
    "NN_DIRECT",
    "TN_DIRECT",
    "TN_VIA_NN",
    "BNT_DIRECT",
    "BNN_DIRECT",
    "ATTN_FUSED",
    "ATTN_UNFUSED",
)

_TILE_EDGE = 128  # edge of the modelled matrix-unit tile
_BLOCK = (512, 512, 512)  # bm, bn, bk of the modelled blocked kernel


def matmul_flops(m: int, n: int, k: int) -> float:
    return 2.0 * m * n * k


def blocked_matmul_bytes(
    m: int, n: int, k: int, dsize: int, block: Tuple[int, int, int]
) -> float:
    """HBM traffic of a blocked matmul: A re-read per n-tile, B per m-tile."""
    bm, bn, _ = block
    n_tiles_m = math.ceil(m / bm)
    n_tiles_n = math.ceil(n / bn)
    return dsize * (m * k * n_tiles_n + n * k * n_tiles_m + m * n)


def tile_efficiency(m: int, n: int, k: int) -> float:
    """Fraction of the matrix unit's peak achievable for this problem
    shape.

    Thin dimensions (< the tile edge) waste lanes; ragged dimensions
    (not multiples of 128) waste the last tile.
    """
    eff = 1.0
    for dim in (m, n, k):
        if dim < _TILE_EDGE:
            eff *= dim / _TILE_EDGE
        else:
            full = dim // _TILE_EDGE
            eff *= dim / ((full + (1 if dim % _TILE_EDGE else 0)) * _TILE_EDGE)
    # deep-k pipelines amortise weight-load bubbles
    pipeline = min(1.0, 0.7 + 0.3 * min(k, 2048) / 2048.0)
    return eff * pipeline


def _noise(chip: str, algo: str, m: int, n: int, k: int, sigma: float) -> float:
    key = f"{chip}|{algo}|{m}|{n}|{k}".encode()
    h = int.from_bytes(hashlib.sha256(key).digest()[:8], "little")
    u = (h / 2**64) * 2.0 - 1.0  # uniform (-1, 1)
    return math.exp(sigma * u)


def _matmul_time(
    hw: HardwareSpec, m: int, n: int, k: int, dsize: int, eff_scale: float = 1.0
) -> float:
    peak = (hw.peak_tflops_bf16 if dsize <= 2 else hw.peak_tflops_f32) * 1e12
    t_compute = matmul_flops(m, n, k) / (peak * tile_efficiency(m, n, k) * eff_scale)
    t_memory = blocked_matmul_bytes(m, n, k, dsize, _BLOCK) / (
        hw.mem_bw_gbps * 1e9
    )
    return max(t_compute, t_memory) + hw.launch_overhead_us * 1e-6


def simulate_time(
    hw: HardwareSpec,
    algo: str,
    m: int,
    n: int,
    k: int,
    dsize: int = 2,
    sigma: float = 0.03,
    g: int = 1,
) -> float:
    """Modelled wall time (seconds) of one GEMM op at per-slice extents
    (m, n, k).  For the batched BNT/BNN arms ``g`` is the batch extent:
    ``g`` slices run back-to-back sharing one kernel launch."""
    bm, bn, bk = _BLOCK
    bw = hw.mem_bw_gbps * 1e9

    if algo in ("BNT_DIRECT", "BNN_DIRECT"):
        # g independent slices amortising one launch: per-slice cost is the
        # corresponding unbatched arm's, minus its launch overhead.
        overhead = hw.launch_overhead_us * 1e-6
        if algo == "BNT_DIRECT":
            # the NT kernel's per-slice in-kernel re-orientation of B, paid
            # once per m-tile of each slice (same mechanics as NT_DIRECT)
            n_tiles_m = math.ceil(m / bm)
            t_tr = (n * k * n_tiles_m) * dsize / (bw * 0.25)
            eff_scale = 0.85 if k < 512 else 0.95
            per_slice = _matmul_time(hw, m, n, k, dsize, eff_scale) + t_tr
        else:  # BNN_DIRECT: layout-clean per slice
            per_slice = _matmul_time(hw, m, n, k, dsize, 0.97)
        t = g * (per_slice - overhead) + overhead
        return t * _noise(hw.name, f"{algo}|g{g}", m, n, k, sigma)

    if algo in ("ATTN_FUSED", "ATTN_UNFUSED"):
        # whole attention subgraph per slice: (m, k) queries x (n, k)
        # keys -> (m, n) probs -> (m, k) out, g slices per launch.
        overhead = hw.launch_overhead_us * 1e-6
        flops = matmul_flops(m, n, k) * 2.0  # QK^T and probs@V
        peak = (hw.peak_tflops_bf16 if dsize <= 2 else hw.peak_tflops_f32) * 1e12
        t_compute = flops / (peak * tile_efficiency(m, n, k) * 0.9)
        if algo == "ATTN_FUSED":
            # one kernel: q/k/v/out through HBM once; logits stay on chip.
            # The online-softmax rescale adds a vector term per logit.
            traffic = (m * k + 2 * n * k + m * k) * dsize
            t_softmax = (m * n * 4) / (bw * 0.9)
            t = max(t_compute, traffic / bw) + t_softmax + overhead
        else:
            # three kernels: the two batched GEMMs plus an f32 HBM
            # round-trip of the (m, n) logits for the softmax.
            traffic = (m * k + 2 * n * k + m * k + 2 * m * n) * dsize
            t_softmax = (2.0 * m * n * 4) / bw
            t = max(t_compute, traffic / bw) + t_softmax + 3 * overhead
        t = g * (t - overhead) + overhead
        return t * _noise(hw.name, f"{algo}|g{g}", m, n, k, sigma)

    if algo == "TNN":
        # out-of-place transpose: read + write n*k at transpose_bw_frac of
        # peak, plus an allocation overhead that grows weakly with size.
        t_tr = (2.0 * n * k * dsize) / (bw * hw.transpose_bw_frac)
        t_alloc = 5e-6 + (n * k * dsize) * 2e-15
        return (t_tr + t_alloc + _matmul_time(hw, m, n, k, dsize)) * _noise(
            hw.name, algo, m, n, k, sigma
        )

    if algo == "NN_DIRECT":
        # layout-clean matmul: both operands feed the matrix unit in native
        # orientation, no re-orientation term at all.
        return _matmul_time(hw, m, n, k, dsize, 0.97) * _noise(
            hw.name, algo, m, n, k, sigma
        )

    if algo == "TN_DIRECT":
        # A:(k,m) is re-oriented in-kernel; its k-strip is re-read (and
        # re-shuffled) once per n-tile — the NT_DIRECT inefficiency with
        # the roles of the operands swapped.
        n_tiles_n = math.ceil(n / bn)
        t_tr = (m * k * n_tiles_n) * dsize / (bw * 0.25)
        eff_scale = 0.85 if k < 512 else 0.95
        return (_matmul_time(hw, m, n, k, dsize, eff_scale) + t_tr) * _noise(
            hw.name, algo, m, n, k, sigma
        )

    if algo == "TN_VIA_NN":
        # materialise A^T (m*k elements through HBM), then a clean NN —
        # the TNN schedule applied to the weight-gradient GEMM.
        t_tr = (2.0 * m * k * dsize) / (bw * hw.transpose_bw_frac)
        t_alloc = 5e-6 + (m * k * dsize) * 2e-15
        return (t_tr + t_alloc + _matmul_time(hw, m, n, k, dsize, 0.97)) * _noise(
            hw.name, algo, m, n, k, sigma
        )

    if algo in ("NT_DIRECT", "TNN_FUSED", "XLA_DOT"):
        # per-B-block in-kernel re-orientation, paid once per m-tile.
        n_tiles_m = math.ceil(m / bm)
        elems = n * k * n_tiles_m
        if algo == "NT_DIRECT":
            # naive in-kernel path: ~1 element/cycle/lane-group -> model as
            # 1/4 of HBM bandwidth equivalent
            t_tr = elems * dsize / (bw * 0.25)
            eff_scale = 0.85 if k < 512 else 0.95  # layout-hostile matrix-unit feed
        elif algo == "TNN_FUSED":
            # vectorised shuffle path: ~bandwidth-speed re-orientation
            t_tr = elems * dsize / (bw * 0.9)
            eff_scale = 0.97
        else:  # XLA_DOT: the library's choice, a bit better than naive NT
            t_tr = elems * dsize / (bw * 0.35)
            eff_scale = 0.90 if k < 512 else 0.95
        t = _matmul_time(hw, m, n, k, dsize, eff_scale) + t_tr
        return t * _noise(hw.name, algo, m, n, k, sigma)

    raise ValueError(f"unknown simulated algorithm: {algo!r}")


def fits_memory(hw: HardwareSpec, m: int, n: int, k: int, dsize: int, tnn: bool) -> bool:
    """Mirror of the paper's OOM filter (B^T needs extra memory for TNN)."""
    total = (m * k + n * k + m * n) * dsize
    if tnn:
        total += n * k * dsize
    return total <= hw.mem_gib * (1024**3) * 0.9


# -- plan models of the port's CUDA kernels (kernels/tiling.py) ---------------
#
# Rank the plans of one kernel at one shape; nothing trains on them.  A plan
# runs its tiles (times splits of k) in waves over the card's SMs, each
# tile at the SM's share of the peak, and moves at least its operands' bytes
# (A re-read per column tile, B per row tile, split partials written and
# read back in f32).


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def gemm_plan_time(
    hw: HardwareSpec,
    m: int,
    n: int,
    k: int,
    dsize: int,
    tile: Tuple[int, int],
    splits: int = 1,
    g: int = 1,
) -> float:
    """Modelled seconds of a GEMM plan with ``tile`` = (bm, bn) output
    tiles and k split ``splits`` ways, over ``g`` slices."""
    bm, bn = tile
    peak = (hw.peak_tflops_bf16 if dsize <= 2 else hw.peak_tflops_f32) * 1e12
    sms = max(1, hw.num_cores)
    units = g * _cdiv(m, bm) * _cdiv(n, bn) * splits
    t_compute = _cdiv(units, sms) * 2.0 * bm * bn * _cdiv(k, splits) / (peak / sms)
    nbytes = dsize * g * (m * k * _cdiv(n, bn) + n * k * _cdiv(m, bm) + m * n)
    if splits > 1:
        nbytes += 8 * splits * g * m * n
    launches = 2 if splits > 1 else 1
    return max(t_compute, nbytes / (hw.mem_bw_gbps * 1e9)) + launches * hw.launch_overhead_us * 1e-6


def transpose_tile_time(
    hw: HardwareSpec, rows: int, cols: int, dsize: int, block: Tuple[int, int]
) -> float:
    """Modelled seconds of an out-of-place transpose with (b_rows, b_cols)
    tiles: the padded tiles' bytes at ``transpose_bw_frac`` of the memory
    rate, plus a wave term for the blocks (about 8 resident per SM)."""
    br, bc = block
    padded = _cdiv(rows, br) * br * _cdiv(cols, bc) * bc
    blocks = _cdiv(rows, br) * _cdiv(cols, bc)
    waves = _cdiv(blocks, 8 * max(1, hw.num_cores))
    t = 2.0 * padded * dsize / (hw.mem_bw_gbps * 1e9 * hw.transpose_bw_frac)
    return t + waves * 0.5e-6 + hw.launch_overhead_us * 1e-6


def attn_plan_time(
    hw: HardwareSpec, g: int, m: int, n: int, dh: int, dsize: int, block: Tuple[int, int]
) -> float:
    """Modelled seconds of a fused-attention plan: for the split-KV
    route's (rows, keys per split), K and V read once by g x splits blocks
    in waves, plus the f32 partials and the combine; a route with one tile
    is one plan, priced by its bytes."""
    bw = hw.mem_bw_gbps * 1e9
    sms = max(1, hw.num_cores)
    rows, per = block
    kv = 2.0 * g * n * dh * dsize
    if rows > 16:  # the flash and FMA routes: one plan each
        return (kv + 2.0 * g * m * dh * dsize) / bw + hw.launch_overhead_us * 1e-6
    splits = _cdiv(n, per)
    t_block = 2.0 * per * dh * dsize / (bw / sms)
    t = max(kv / bw, _cdiv(g * splits, 2 * sms) * t_block)
    if splits > 1:
        t += 2.0 * g * splits * m * (dh + 2) * 4 / bw + hw.launch_overhead_us * 1e-6
    return t + hw.launch_overhead_us * 1e-6
