"""The decoder-only LM for token models.  The layer stack is a Python loop
over each config segment's stacked block params (the JAX package scans
them).  Entry points:

  init_lm        seeded random params, the JAX package's tree and
                 distributions (weights differ: torch.Generator is not
                 jax.random; ``repro_torch.convert`` carries JAX weights over)
  lm_forward     full-sequence logits
  lm_prefill     forward that also emits the decode cache
  lm_decode      one-token step against a cache, updated in place
  init_lm_cache  zero cache with the tree lm_prefill produces
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch import resolve_device

from .blocks import (
    apply_block,
    decode_block,
    init_block,
    init_block_cache,
    prefill_block,
)
from .layers import Param, embed, init_embedding, init_rmsnorm, rmsnorm, softcap, unembed

__all__ = ["init_lm", "lm_forward", "lm_prefill", "lm_decode", "init_lm_cache"]


def _dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def init_lm(gen, cfg, *, device="cuda") -> Param:
    """Random params for ``cfg`` on ``device``.  ``gen`` is a
    ``torch.Generator`` or an int seed (for a CPU generator, so a seed
    gives the same weights on every device).  Raises ``RuntimeError`` if
    CUDA is asked for and there is no card."""
    dev = resolve_device(device)
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator().manual_seed(int(gen))
    if cfg.input_mode != "tokens":
        raise NotImplementedError(
            f"input_mode {cfg.input_mode!r} is not ported (this slice serves token LMs)"
        )
    dt = _dtype(cfg)
    params: Param = {
        "embed": init_embedding(gen, cfg.vocab_padded, cfg.d_model, dt, dev),
        "final_norm": init_rmsnorm(cfg.d_model, dt, dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = init_embedding(gen, cfg.vocab_padded, cfg.d_model, dt, dev)
    segs = []
    for count, blocks in cfg.segments:
        slot_params = []
        for b in blocks:
            layers = [init_block(gen, b, cfg, dt, dev) for _ in range(count)]
            slot_params.append(_stack(layers))
        segs.append(tuple(slot_params))
    params["segments"] = segs
    return params


def _stack(trees):
    """Stack a list of same-structure dicts of tensors along a new axis 0."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _index(tree, i: int):
    """Layer ``i`` of a stacked tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _embed_input(params: Param, cfg, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    if cfg.input_mode != "tokens":
        raise NotImplementedError(f"input_mode {cfg.input_mode!r} is not ported")
    return embed(params["embed"], batch["tokens"], cfg.emb_scale)


def _logits(params: Param, cfg, x: torch.Tensor) -> torch.Tensor:
    x = rmsnorm(params["final_norm"], x)
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return softcap(unembed(head, x), cfg.final_softcap)


def lm_forward(params: Param, cfg, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    x = _embed_input(params, cfg, batch)
    for (count, blocks), slot_params in zip(cfg.segments, params["segments"]):
        for i in range(count):
            for b, sp in zip(blocks, slot_params):
                x = apply_block(_index(sp, i), x, b, cfg)
    return _logits(params, cfg, x)


# -- prefill ------------------------------------------------------------------


def lm_prefill(
    params: Param,
    cfg,
    batch: Dict[str, torch.Tensor],
    max_seq: int,
    cache_dtype=torch.bfloat16,
    true_len=None,
):
    """Returns (last-position logits, cache).

    ``true_len`` (int or ``(B,)`` tensor) marks a right-padded prefill:
    logits come from each row's real last position and the cache's
    ``pos`` starts at ``true_len``."""
    x = _embed_input(params, cfg, batch)
    caches = []
    for (count, blocks), slot_params in zip(cfg.segments, params["segments"]):
        per_slot = [[] for _ in blocks]
        for i in range(count):
            for j, (b, sp) in enumerate(zip(blocks, slot_params)):
                x, c = prefill_block(
                    _index(sp, i), x, b, cfg, max_seq,
                    cache_dtype=cache_dtype, true_len=true_len,
                )
                per_slot[j].append(c)
        caches.append(tuple(_stack(cs) for cs in per_slot))
    B, S = x.shape[:2]
    if true_len is None:
        logits = _logits(params, cfg, x[:, -1:])
        pos_next = torch.tensor(S, dtype=torch.int32, device=x.device)
    else:
        pos_next = torch.as_tensor(true_len, device=x.device).to(torch.int32)
        idx = (pos_next.long() - 1).clamp(0, S - 1).reshape(-1).expand(B)
        x_last = x[torch.arange(B, device=x.device), idx][:, None]
        logits = _logits(params, cfg, x_last)
    return logits, {"segments": caches, "pos": pos_next}


# -- decode -------------------------------------------------------------------


def init_lm_cache(cfg, batch: int, max_seq: int, dtype=torch.bfloat16,
                  per_seq_pos: bool = False, device="cuda"):
    """Zero cache on ``device`` with the tree lm_prefill produces: per
    segment, one ``{"k", "v"}`` dict per block slot with leaves (layers,
    batch, slots, kv, dh).  ``per_seq_pos`` makes ``pos`` a ``(batch,)``
    vector."""
    device = resolve_device(device)
    caches = []
    for count, blocks in cfg.segments:
        seg = []
        for b in blocks:
            one = init_block_cache(b, cfg, batch, max_seq, dtype, device)
            seg.append({k: torch.zeros((count,) + v.shape, dtype=v.dtype, device=device)
                        for k, v in one.items()})
        caches.append(tuple(seg))
    pos = torch.zeros((batch,) if per_seq_pos else (), dtype=torch.int32, device=device)
    return {"segments": caches, "pos": pos}


def lm_decode(params: Param, cfg, cache, batch: Dict[str, torch.Tensor]):
    """One-token step.  batch: {'tokens': (B, 1)}.

    Returns (logits (B, 1, V), cache with pos + 1).  ``cache['pos']`` may
    be a scalar (uniform batch) or a ``(B,)`` vector (each row decodes at
    its own position).  The cache tensors are updated in place: the
    returned cache holds the same tensors."""
    pos = cache["pos"]
    x = _embed_input(params, cfg, batch)
    for (count, blocks), slot_params, seg_cache in zip(
        cfg.segments, params["segments"], cache["segments"]
    ):
        for i in range(count):
            for b, sp, sc in zip(blocks, slot_params, seg_cache):
                x, _ = decode_block(_index(sp, i), x, b, cfg, _index(sc, i), pos)
    logits = _logits(params, cfg, x)
    return logits, {"segments": cache["segments"], "pos": pos + 1}
