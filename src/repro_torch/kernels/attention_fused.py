"""Fused masked attention: the whole ``Q K^T -> softmax -> probs V``
subgraph as one kernel.

  attention_fused   q:(g, m, dh)  k:(g, n, dh)  v:(g, n, dh) -> (g, m, dh)

Replaces the Pallas kernel ``repro/kernels/attention_fused.py:338``.  On
CUDA tensors the wrapper launches one of three kernels of
``csrc/attention_fused.cu``, picked before the launch by
``attention_variant`` from dtype and shape:

- ``decode_split`` (m <= 16: decode, one kv head's GQA group of rows;
  both dtypes, any dh up to 256): split-KV.  The grid is (g, splits), with
  ``decode_split_plan`` choosing the splits from n and the SM count so that
  g x splits fills the card, never from ``lengths`` (the host reads no
  device tensor).  Each split writes f32 partials (max, sum, acc) to a
  workspace this wrapper allocates, and a second kernel combines them in
  split order.  Bound by the bytes of the live K and V, and at decode's
  size by launch latency.
- ``flash_mma`` (bf16, dh 64 or 128, m > 16: prefill and training): a
  flash-attention forward on the tensor cores (``wgmma``, one warpgroup
  per 64 query rows, 64-key K/V tiles through a ``cp.async`` ring in the
  128-byte swizzle, online softmax in registers, P fed to P V from
  registers).  Bound by bytes.
- ``fma`` (everything else: f32 at m > 16, other dh up to 256): one
  block per (slice, 16 query rows) over the 32-key tiles the mask leaves
  live, f32 staged in shared memory.

The split and FMA kernels are built twice, for head dims up to 128 and up
to 256; a call takes the smaller instance that holds its dh.  Above 256
the wrapper raises (the Pallas kernel pads any dh to the 128 edge).

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
    LAUNCHES,
    cdiv,
    check_operand,
    route,
    sm_count,
    validate_config,
)

__all__ = ["MaskParams", "NEG_INF", "DH_MAX", "attention_fused", "attention_variant",
           "decode_split_plan"]

NEG_INF = -1e30  # finite: exp(NEG_INF - finite_max) == 0.0 exactly, no nan

DH_MAX = 256  # largest head dim the kernels take (csrc kDhMax)
_MAX_GRID_Y = 65535  # gridDim.y: the q-blocks of the flash and FMA kernels
_FMA_ROWS = 16  # csrc kBQ: query rows per FMA block
_FLASH_ROWS = 64  # csrc kFlashRows: query rows per flash block
_FLASH_DH = (64, 128)  # the head dims the flash kernel is built for
_DECODE_MAX_M = 16  # csrc kDecodeMaxRows: the split kernel's rows
_DECODE_MIN_KEYS = 32  # a split walks at least this many keys
_DECODE_KEY_STEP = 16  # splits hold a multiple of 16 keys (one step of 4 warps)
_DECODE_BLOCKS_PER_SM = 2  # the split count aims for this many blocks per SM
_DECODE_MAX_SPLITS = 64  # csrc kCombineMaxSplits: the combine's scales per row


def attention_variant(dtype: torch.dtype, g: int, m: int, n: int, dh: int,
                      aligned: bool = True) -> str:
    """The kernel a CUDA call launches: ``"decode_split"`` (m <= 16),
    ``"flash_mma"`` (bf16, dh 64 or 128, q, k and v 16-byte aligned) or
    ``"fma"``.  A pure function of dtype and shape (and of the operands'
    alignment, which the flash kernel's 16-byte copies need), decided
    before the launch."""
    if m <= _DECODE_MAX_M:
        return "decode_split"
    if dtype == torch.bfloat16 and dh in _FLASH_DH and aligned:
        return "flash_mma"
    return "fma"


@functools.lru_cache(maxsize=None)  # decode repeats one shape every step
def decode_split_plan(g: int, n: int, sms: int) -> Tuple[int, int]:
    """(splits, keys per split) of the split-KV kernel: a pure function of
    g, n and the card's SM count, never of ``lengths``.  The keys split
    until g x splits gives every SM about two blocks, into at most 64
    splits of at least 32 keys, a multiple of 16; splits x per covers n
    and no split is empty."""
    want = min(cdiv(_DECODE_BLOCKS_PER_SM * sms, g), _DECODE_MAX_SPLITS)
    per = cdiv(cdiv(n, want), _DECODE_KEY_STEP) * _DECODE_KEY_STEP
    per = max(_DECODE_MIN_KEYS, per)
    return cdiv(n, per), per


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
    Queries come pre-scaled by ``d_head**-0.5``.  ``block`` is validated
    as a (bq, bk) tile config; the CUDA kernels' tiles are fixed."""
    if block is not None:
        validate_config(block, arity=2)
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
    if route(q, k, v, lengths) == "plain":
        return ref.attention_fused(q, k, v, lengths, mask)
    aligned = all(t.data_ptr() % 16 == 0 for t in (q, k, v))
    variant = attention_variant(q.dtype, g, m, n, dh, aligned)
    if variant != "decode_split":
        rows = _FLASH_ROWS if variant == "flash_mma" else _FMA_ROWS
        if cdiv(m, rows) > _MAX_GRID_Y:
            raise ValueError(f"attention kernel takes at most {_MAX_GRID_Y * rows} query rows")
    out = torch.empty_like(q)
    if not out.numel():
        return out
    head = (_build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(lengths), _build.ptr(out))
    geometry = (g, m, n, dh, int(mask.causal), int(mask.window), int(mask.q_start),
                int(mask.k_start), int(mask.prefix_len), int(mask.q_seg), float(mask.softcap))
    if variant == "decode_split":
        splits, per = decode_split_plan(g, n, sm_count(torch.cuda.current_device()))
        ws = (torch.empty((g, splits, m * (dh + 2)), dtype=torch.float32, device=q.device)
              if splits > 1 else None)
        _build.launch("attention_fused", "repro_attention_fused_decode", *head,
                      _build.ptr(ws) if ws is not None else ctypes.c_void_p(None),
                      *geometry, splits, per, _build.dtype_code(q.dtype), _build.stream_of(q))
    elif variant == "flash_mma":
        _build.launch("attention_fused", "repro_attention_fused_flash", *head, *geometry,
                      _build.stream_of(q))
    else:
        _build.launch("attention_fused", "repro_attention_fused_fma", *head, *geometry,
                      _build.dtype_code(q.dtype), _build.stream_of(q))
    LAUNCHES["attention_fused"] += 1
    ATTENTION_ROUTES[(variant, dh)] = ATTENTION_ROUTES.get((variant, dh), 0) + 1
    return out
