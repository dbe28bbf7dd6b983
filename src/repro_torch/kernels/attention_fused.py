"""Fused masked attention: the whole ``Q K^T -> softmax -> probs V``
subgraph as one kernel.

  attention_fused   q:(g, m, dh)  k:(g, n, dh)  v:(g, n, dh) -> (g, m, dh)

Replaces the Pallas kernel ``repro/kernels/attention_fused.py:338``.  On
CUDA tensors the wrapper launches one of four kernels of
``csrc/attention_fused.cu``, picked before the launch by
``attention_variant`` from dtype, shape and alignment:

- ``decode_split`` (m <= 16: decode, one kv head's GQA group of rows;
  both dtypes, any dh up to 256): split-KV.  The grid is (g, splits), with
  ``decode_split_plan`` choosing the splits from n and the SM count so that
  g x splits fills the card, never from ``lengths`` (the host reads no
  device tensor).  Each split writes f32 partials (max, sum, acc) to a
  workspace this wrapper allocates, and a second kernel combines them in
  split order.  Bound by the bytes of the live K and V, and at decode's
  size by launch latency.
- ``flash_mma`` (bf16, dh 64, 112, 120, 128 or 256, m > 16: prefill and
  training): a flash-attention forward on the tensor cores (``wgmma``, one
  warpgroup per 64 query rows, 64-key K/V tiles through a ``cp.async`` ring
  in the 128-byte swizzle, online softmax in registers, P fed to P V from
  registers).  dh 112 and 120 run the 128-wide instance with the true row
  stride, the pieces from dh to 127 landing as zeros and never stored (the
  Pallas kernel pads every dh to the 128 edge); dh 256 has an instance of
  its own (161 KiB of shared memory, P V as one ``m64n256k16``).  Bound by
  bytes.
- ``flash_f32`` (f32, dh 64, 112, 120, 128 or 256, 16-byte aligned, m >
  16: f32 prefill and training): a flash-attention forward in exact FFMA.
  A block of 256 threads takes 64 query rows; K/V tiles (64 keys, 32 at
  dh 256) come through a ``cp.async`` ring as stored, each thread scores
  4 rows x 4 keys (2 at 256) from float4 runs along dh, the online softmax
  runs in registers (a row's max over its 16 lanes by shuffles, exp2 of
  log2e-scaled differences), and P goes through shared memory into O += P
  V.  112 and 120 run the 128-wide instance.  Where the q-blocks fill less
  than two waves of the card, each block's live key tiles split into 2 to
  4 runs (``flash_f32_splits``, from the shape and the SM count), whose f32
  partials a second kernel adds in split order.  Bound by operations.
- ``fma`` (everything else: unaligned operands and other dh up to 256 at
  m > 16): one block per (slice, 16 query rows) over the 32-key tiles the
  mask leaves live, f32 staged in shared memory.

The split and FMA kernels are built twice, for head dims up to 128 and up
to 256; a call takes the smaller instance that holds its dh.  Above 256
the wrapper raises (the Pallas kernel pads any dh to the 128 edge).

Tile configs (``kernels/tiling.py``): ``attention_plans`` lists the
plans of a shape's route as (config, plan) pairs, the route's own first,
and ``block=None`` launches that one.  On the ``decode_split`` route a
config (bq, bk) names a split of the keys: bq the kernel's row instance
(4 for m <= 4, else 16), bk the keys of one split (``decode_split_plan``'s,
and those of 1, 2, 4, ... 64 splits: a multiple of 16, at least 32).  The
``flash_mma`` route runs one tile, (64, 64), the ``flash_f32`` route one,
(64, 64) or at dh 256 (64, 32), and the ``fma`` route (16, 32).  Any other
config raises, on both routes.

``attention_grid_specs`` declares each route's launches
(``kernels/gridspec.py``): block (x, y, z) takes slice x, the q-block
``flash_block_row`` gives rank y (on the flash routes; the FMA kernel's
in order) and split z; the split kernels' second launch combines the f32
partials.  The GQA fold makes a kv head's query group rows of one slice,
so a slice's k and v are its own.

Each kernel keeps the live key range of the mask and never reads K or V
beyond ``lengths``.  Each call counts one launch, split or not, in
``LAUNCHES`` and under its (route, dh) in ``ATTENTION_ROUTES``.  On CPU
tensors the wrapper runs the dense plain version in ``ref.py``.

Masking follows ``MaskParams`` plus the per-slice ``lengths``: query row
``r`` of a slice sits at ``q_start + r % q_seg`` (``q_seg`` is the GQA
fold width; 0 means no fold), key column ``c`` at ``k_start + c``.
Masked logits use a finite ``NEG_INF`` so ``exp`` gives an exact 0 and
never ``inf - inf``; V rows beyond ``lengths`` are zeroed before the mix.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from . import _build, ref
from .common import (
    ATTENTION_ROUTES,
    H100_SMS,
    cdiv,
    check_operand,
    count_launch,
    pick_plan,
    route,
    sm_count,
    validate_config,
)
from .gridspec import MAX_GRID_Y, BlockMap, check_launch, dense_spec

__all__ = ["MaskParams", "NEG_INF", "DH_MAX", "attention_fused", "attention_variant",
           "decode_split_plan", "flash_f32_splits", "attention_plans", "attention_grid_specs",
           "flash_block_row"]

NEG_INF = -1e30  # finite: exp(NEG_INF - finite_max) == 0.0 exactly, no nan

DH_MAX = 256  # largest head dim the kernels take (csrc kDhMax)
_FMA_ROWS = 16  # csrc kBQ: query rows per FMA block
_FLASH_ROWS = 64  # csrc kFlashRows: query rows per flash block
_FLASH_DH = (64, 112, 120, 128, 256)  # the head dims the flash kernel takes
_DECODE_MAX_M = 16  # csrc kDecodeMaxRows: the split kernel's rows
_DECODE_MIN_KEYS = 32  # a split walks at least this many keys
_DECODE_KEY_STEP = 16  # splits hold a multiple of 16 keys (one step of 4 warps)
_DECODE_BLOCKS_PER_SM = 2  # the split count aims for this many blocks per SM
_DECODE_MAX_SPLITS = 64  # csrc kCombineMaxSplits: the combine's scales per row
_DECODE_WARPS = 4  # csrc kDecodeWarps
_FMA_KEYS = 32  # csrc kBKV: keys per FMA tile
_FLASH_KEYS = 64  # csrc kFlashKeys
_FLASH_F32_ROWS = 64  # csrc kF32Rows
_FLASH_F32_MAX_SPLITS = 4
_DH_SMALL = 128  # csrc kDhSmall: the smaller instance of the split and FMA kernels
_COMBINE_THREADS = 256  # csrc kCombineThreads: attention_flash_combine's block, 4 floats each


def attention_variant(dtype: torch.dtype, g: int, m: int, n: int, dh: int,
                      aligned: bool = True) -> str:
    """The kernel a CUDA call launches: ``"decode_split"`` (m <= 16),
    ``"flash_mma"`` (bf16) or ``"flash_f32"`` (f32) at dh 64, 112, 120, 128
    or 256 with q, k and v 16-byte aligned, or ``"fma"``.  A pure function
    of dtype and shape (and of the operands' alignment, which the flash
    kernels' 16-byte copies need), decided before the launch."""
    if m <= _DECODE_MAX_M:
        return "decode_split"
    if dh in _FLASH_DH and aligned:
        return "flash_mma" if dtype == torch.bfloat16 else "flash_f32"
    return "fma"


@functools.lru_cache(maxsize=None)  # decode repeats one shape every step
def decode_split_plan(g: int, n: int, sms: int) -> Tuple[int, int]:
    """(splits, keys per split) of the split-KV kernel: a pure function of
    g, n and the card's SM count, never of ``lengths``.  The keys split
    until g x splits gives every SM about two blocks, into at most 64
    splits of at least 32 keys, a multiple of 16; splits x per covers n
    and no split is empty."""
    want = min(cdiv(_DECODE_BLOCKS_PER_SM * sms, max(1, g)), _DECODE_MAX_SPLITS)
    per = cdiv(cdiv(n, want), _DECODE_KEY_STEP) * _DECODE_KEY_STEP
    per = max(_DECODE_MIN_KEYS, per)
    return cdiv(n, per), per


def _flash_f32_keys(dh: int) -> int:
    """Keys per K/V tile of the f32 flash instance dh runs on (csrc
    FlashF32Cfg::kKeys)."""
    return 32 if dh > 128 else 64


@functools.lru_cache(maxsize=None)
def flash_f32_splits(g: int, m: int, n: int, dh: int, sms: int) -> int:
    """Runs of each q-block's key tiles the f32 flash kernel takes: a
    pure function of the shape and the card's SM count, never of
    ``lengths``.  Blocks that fill at least two waves (one block an SM at
    dh above 64, two at 64) run whole; fewer split into as many runs as
    bring the grid to about two waves, at most 4, and at most half the
    key tiles of n."""
    blocks = g * cdiv(m, _FLASH_F32_ROWS)
    per_sm = 2 if dh <= 64 else 1
    want = (2 * sms * per_sm) // max(1, blocks)
    return max(1, min(_FLASH_F32_MAX_SPLITS, want, cdiv(n, _flash_f32_keys(dh)) // 2))


def _decode_rows(m: int) -> int:
    """The split kernel's row instance for m (csrc launch_decode)."""
    return 4 if m <= 4 else _DECODE_MAX_M


@functools.lru_cache(maxsize=None)
def attention_plans(dtype: torch.dtype, g: int, m: int, n: int, dh: int, aligned: bool = True,
                    sms: int = H100_SMS):
    """The (config, plan) pairs of this shape's route (``aligned``: q, k
    and v 16-byte aligned), the route's own first.  A plan is
    ``(variant, splits, keys per split)``; ``flash_f32`` splits each
    q-block's own live tiles, so its plan names no keys per split (None)."""
    variant = attention_variant(dtype, g, m, n, dh, aligned)
    if variant == "flash_f32":
        tile = (_FLASH_F32_ROWS, _flash_f32_keys(dh))
        return ((tile, (variant, flash_f32_splits(g, m, n, dh, sms), None)),)
    if variant != "decode_split":
        tile = (_FLASH_ROWS, _FLASH_KEYS) if variant == "flash_mma" else (_FMA_ROWS, _FMA_KEYS)
        return ((tile, (variant, 1, 1)),)
    pers = [decode_split_plan(g, n, sms)[1]]
    for s in (1, 2, 4, 8, 16, 32, _DECODE_MAX_SPLITS):
        pers.append(max(_DECODE_MIN_KEYS,
                        cdiv(cdiv(n, s), _DECODE_KEY_STEP) * _DECODE_KEY_STEP))
    plans = {(_decode_rows(m), per): (variant, cdiv(n, per), per) for per in pers}
    return tuple(plans.items())


@dataclass(frozen=True)
class MaskParams:
    """Static mask description for one fused-attention call.

    Visibility is ``valid(c) AND causal AND window``, OR'd with
    ``valid(c) AND prefix``, where ``valid(c) = c < lengths[slice]``.
    The default instance masks nothing beyond validity."""

    causal: bool = False
    window: int = 0  # 0 => no sliding window
    q_start: int = 0
    k_start: int = 0
    prefix_len: int = 0
    q_seg: int = 0  # 0 => q_seg = full query extent (no group fold)
    softcap: float = 0.0


def flash_block_row(rank, blocks: int, rows: int, m: int, seg: int, causal: bool):
    """The first row of the q-block that block ``rank`` of ``blocks`` takes
    (csrc ``flash_block_row``): under a causal mask the latest blocks go
    first -- the latest in each fold segment when whole blocks tile the
    segments -- else in order.  ``rank`` is an int or an integer array."""
    if not causal:
        return rank * rows
    if seg < m and seg % rows == 0 and m % seg == 0:
        per_seg, segs = seg // rows, m // seg
        return ((rank % segs) * per_seg + per_seg - 1 - rank // segs) * rows
    return (blocks - 1 - rank) * rows


@functools.lru_cache(maxsize=None)  # built once a shape: a wrapper runs it every call
def attention_grid_specs(g: int, m: int, n: int, dh: int, plan: tuple,
                         mask: MaskParams = MaskParams()) -> tuple:
    """The launches of an ``attention_plans`` plan under ``mask``.

    ``decode_split``: block (x, y) = (slice, split of ``per`` keys); with
    splits, f32 partials (g, splits, m (dh + 2)) and ``attention_combine``,
    a block a slice.  ``flash_mma`` / ``flash_f32``: block (x, y, z) =
    (slice, rank of the q-block in ``flash_block_row``'s order, split of
    the block's live key tiles); with splits, partials (g, splits, m, dh +
    2) -- each row's O and its (max, sum) -- and ``attention_flash_combine``,
    block (x, y) = 1024 floats x of slice y.  ``fma``: block (x, y) =
    (slice, 16-row q-block y).  K and V are read whole (the flash split's
    run of key tiles depends on ``lengths``), except by a decode split."""
    variant, splits, per = plan
    qkv = lambda rows: BlockMap((1, rows, dh), lambda x, y, z: (x, y, 0), (g, m, dh))  # noqa: E731
    kv = BlockMap((1, n, dh), lambda x, y, z: (x, 0, 0), (g, n, dh))
    lengths = BlockMap((1,), lambda x, y, z: (x,), (g,))
    if variant == "decode_split":
        q = BlockMap((1, m, dh), lambda x, y, z: (x, 0, 0), (g, m, dh))
        kv = BlockMap((1, per, dh), lambda x, y, z: (x, y, 0), (g, n, dh))
        out = BlockMap((1, m, dh), lambda x, y, z: (x, 0, 0), (g, m, dh))
        if splits == 1:
            return (dense_spec("attention_decode_split", (g, 1), (q, kv, kv, lengths), out),)
        part = m * (dh + 2)
        ws = BlockMap((1, 1, part), lambda x, y, z: (x, y, 0), (g, splits, part))
        return (dense_spec("attention_decode_split", (g, splits), (q, kv, kv, lengths), ws),
                dense_spec("attention_combine", (g,),
                           (BlockMap((1, splits, part), lambda x, y, z: (x, 0, 0),
                                     (g, splits, part)),), out))
    if variant == "fma":
        return (dense_spec("attention_fma", (g, cdiv(m, _FMA_ROWS)),
                           (qkv(_FMA_ROWS), kv, kv, lengths), qkv(_FMA_ROWS)),)
    rows = _FLASH_ROWS if variant == "flash_mma" else _FLASH_F32_ROWS
    blocks = cdiv(m, rows)
    seg = mask.q_seg if mask.q_seg > 0 else m

    def rank(y):
        return flash_block_row(y, blocks, rows, m, seg, bool(mask.causal)) // rows

    q = BlockMap((1, rows, dh), lambda x, y, z: (x, rank(y), 0), (g, m, dh))
    name = "attention_flash" if variant == "flash_mma" else "attention_flash_f32"
    if splits == 1:
        return (dense_spec(name, (g, blocks), (q, kv, kv, lengths),
                           BlockMap((1, rows, dh), lambda x, y, z: (x, rank(y), 0),
                                    (g, m, dh))),)
    ws = BlockMap((1, 1, rows, dh + 2), lambda x, y, z: (x, z, rank(y), 0),
                  (g, splits, m, dh + 2))
    piece = 4 * _COMBINE_THREADS
    return (dense_spec(name, (g, blocks, splits), (q, kv, kv, lengths), ws),
            dense_spec("attention_flash_combine", (cdiv(m * dh, piece), g),
                       (BlockMap((1, splits, m, dh + 2), lambda x, y, z: (y, 0, 0, 0),
                                 (g, splits, m, dh + 2)),),
                       BlockMap((1, piece), lambda x, y, z: (y, x), (g, m * dh))))


def attention_fused(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
    *,
    mask: MaskParams = MaskParams(),
    block: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """softmax(mask(Q K^T)) V per batch slice, in q's dtype.

    ``lengths`` (g,) marks each slice's valid key count (None => all n).
    Queries come pre-scaled by ``d_head**-0.5``.  ``block`` is a (bq, bk)
    tile config of ``attention_plans`` (None: the route's own); any other
    raises on both routes."""
    if block is not None:
        block = validate_config(block, arity=2)
    for name, x in (("q", q), ("k", k), ("v", v)):
        check_operand(name, x, 3)
    g, m, dh = q.shape
    n = k.shape[1]
    if k.shape != v.shape or k.shape[0] != g or k.shape[2] != dh:
        raise ValueError(f"attention operand mismatch: {tuple(q.shape)} vs "
                         f"{tuple(k.shape)} vs {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"attention operands differ in dtype: {q.dtype}, {k.dtype}, {v.dtype}")
    if dh > DH_MAX:
        raise ValueError(f"attention kernel takes head dims up to {DH_MAX}, got {dh}")
    if n < 1:
        raise ValueError("attention needs at least one key")
    if lengths is None:
        lengths = torch.full((g,), n, dtype=torch.int32, device=q.device)
    else:
        lengths = lengths.reshape(g).to(device=q.device, dtype=torch.int32).contiguous()
    aligned = all(t.data_ptr() % 16 == 0 for t in (q, k, v))
    r = route(q, k, v, lengths)
    sms = H100_SMS if r != "kernel" else sm_count(torch.cuda.current_device())
    variant, splits, per = pick_plan(attention_plans(q.dtype, g, m, n, dh, aligned, sms), block,
                                     f"attention kernel at g={g} m={m} n={n} dh={dh} {q.dtype}")
    if r == "plain":
        return ref.attention_fused(q, k, v, lengths, mask)
    if r == "meta":
        return torch.empty_like(q)
    specs = attention_grid_specs(g, m, n, dh, (variant, splits, per), mask)
    rows = _FMA_ROWS if variant == "fma" else _FLASH_ROWS
    check_launch(specs, f"attention kernel takes at most {MAX_GRID_Y * rows} query rows")
    out = torch.empty_like(q)
    if not out.numel():
        return out
    head = (_build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(lengths), _build.ptr(out))
    geometry = (g, m, n, dh, int(mask.causal), int(mask.window), int(mask.q_start),
                int(mask.k_start), int(mask.prefix_len), int(mask.q_seg), float(mask.softcap))
    ws = (torch.empty(specs[0].out_spec.extent, dtype=torch.float32, device=q.device)
          if splits > 1 else None)
    ws_ptr = _build.ptr(ws) if ws is not None else ctypes.c_void_p(None)
    second = specs[1].launch if splits > 1 else (0, 0, 0)
    if variant == "decode_split":
        _build.launch("attention_fused", "repro_attention_fused_decode", *head, ws_ptr,
                      *geometry, splits, per, _build.dtype_code(q.dtype), *specs[0].launch,
                      *second, _build.stream_of(q))
    elif variant == "flash_mma":
        _build.launch("attention_fused", "repro_attention_fused_flash", *head, *geometry,
                      *specs[0].launch, _build.stream_of(q))
    elif variant == "flash_f32":
        _build.launch("attention_fused", "repro_attention_fused_flash_f32", *head, ws_ptr,
                      *geometry, splits, *specs[0].launch, *second, _build.stream_of(q))
    else:
        _build.launch("attention_fused", "repro_attention_fused_fma", *head, *geometry,
                      _build.dtype_code(q.dtype), *specs[0].launch, _build.stream_of(q))
    count_launch("attention_fused", block)
    ATTENTION_ROUTES[(variant, dh)] = ATTENTION_ROUTES.get((variant, dh), 0) + 1
    return out
