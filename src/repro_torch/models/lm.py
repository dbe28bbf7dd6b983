"""The decoder-only LM of all ten architectures: attention, Mamba-2 and
Zamba-style shared-attention mixers, gated-MLP and MoE FFNs, and the
muP multipliers of ``PortArchConfig`` (``configs/arch.py``: the
embeddings times ``emb_mult``, each block's outputs times
``residual_mult``, the logits over ``logits_div``).  The layer
stack is a Python loop over each config segment's stacked block params
(the JAX package scans them); shared-attention blocks read the one
unstacked ``params["shared"]["attn"]``.  Modalities, as in the JAX package:
``tokens`` (LMs), ``frames`` (musicgen: stub EnCodec frame embeddings
enter directly) and ``vlm`` (paligemma: stub SigLIP patch embeddings
prepended to the text as a bidirectional prefix of ``cfg.prefix_len``).
Entry points:

  init_lm        seeded random params, the JAX package's tree and
                 distributions (weights differ: torch.Generator is not
                 jax.random; ``repro_torch.convert`` carries JAX weights over)
  lm_forward     full-sequence logits; ``cfg.remat == "full"`` checkpoints
                 each layer unit, so its forward GEMMs run again in the
                 backward (``jax.checkpoint`` in the JAX package);
                 ``"dots"`` checkpoints it too but keeps the outputs of
                 its non-batched GEMMs (NT/NN/TN dispatches), which the
                 recompute reuses instead of launching again, as the JAX
                 package's ``dots_with_no_batch_dims_saveable`` policy
                 saves them; the batched GEMMs, attention and every
                 elementwise op are recomputed
  lm_loss        mean next-token cross-entropy of ``lm_forward`` (text
                 positions only under ``vlm``)
  lm_prefill     forward that also emits the decode cache
  lm_decode      one-token step against a cache, updated in place
                 (attention writes its K/V row, a Mamba block copies its
                 new conv and SSM state over the old)
  init_lm_cache  zero cache with the tree lm_prefill produces
  gather_logits  the whole vocabulary's logits from this rank's slice

Under a mesh (``distributed.context.use_mesh``) every entry point is one
rank's program on its pieces of the params (``distributed.sharding``):
the ``model`` axis splits the layers (``layers.dense_tp``,
``attention.py``, ``ssm.py``, ``moe.py``; zamba2's shared attention
block like any other: its one set of weights takes the gradients of
every unit that reads it), the data axes split the MoE experts' second
dim (FSDP) and a vocab-split embedding splits the logits, which
``lm_forward``, ``lm_prefill`` and ``lm_decode`` return as this rank's
vocabulary slice (``gather_logits`` joins them).
"""

from __future__ import annotations

import contextlib
from typing import Dict

import torch
import torch.utils.checkpoint

from repro_torch import resolve_device
from repro_torch.core.engine import remat_record, remat_replay
from repro_torch.core.policy import current_scope, resume_scope
from repro_torch.distributed.collectives import all_gather
from repro_torch.distributed.context import current_mesh

from .attention import init_attention
from .blocks import (
    _attn_cfg,
    apply_block,
    decode_block,
    init_block,
    init_block_cache,
    prefill_block,
)
from .layers import (
    Param,
    cross_entropy_loss,
    embed,
    init_embedding,
    init_rmsnorm,
    rmsnorm,
    softcap,
    unembed,
    weight_dim,
)

__all__ = ["init_lm", "lm_forward", "lm_loss", "lm_prefill", "lm_decode", "init_lm_cache",
           "gather_logits", "vocab_split"]


def _dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def _shared_block(cfg):
    """The first shared-attention block of ``cfg``, or None."""
    return next((b for _, bl in cfg.segments for b in bl if b.mixer == "shared_attn"), None)


def init_lm(gen, cfg, *, device="cuda") -> Param:
    """Random params for ``cfg`` on ``device``.  ``gen`` is a
    ``torch.Generator`` (drawing on its own device) or an int seed (for a
    CPU generator, so a seed gives the same weights on every device).
    The router weights and the Mamba blocks' ``A_log``, ``D`` and
    ``dt_bias`` are f32 whatever ``cfg.param_dtype`` is.  On the ``meta``
    device nothing is drawn.  Raises ``RuntimeError`` if CUDA is asked for
    and there is no card."""
    dev = resolve_device(device)
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator().manual_seed(int(gen))
    dt = _dtype(cfg)
    params: Param = {
        "embed": init_embedding(gen, cfg.vocab_padded, cfg.d_model, dt, dev),
        "final_norm": init_rmsnorm(cfg.d_model, dt, dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = init_embedding(gen, cfg.vocab_padded, cfg.d_model, dt, dev)
    shared_b = _shared_block(cfg)
    if shared_b is not None:
        params["shared"] = {"attn": init_attention(gen, _attn_cfg(shared_b, cfg), dt, dev)}
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
    """Stack a list of same-structure dicts of tensors along a new axis 0,
    emptying the dicts as it goes, so each leaf's layers are freed once
    stacked (a single layer becomes a view, no copy): the peak stays near
    one copy of the tree."""
    if isinstance(trees[0], dict):
        return {k: _stack([t.pop(k) for t in trees]) for k in list(trees[0])}
    return trees[0].unsqueeze(0) if len(trees) == 1 else torch.stack(trees)


def _index(tree, i: int):
    """Layer ``i`` of a stacked tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _unstack(tree, count: int):
    """The ``count`` layers of a stacked tree, as one tree per layer; a
    single ``unbind`` per leaf, whose backward stacks the layer gradients
    in one op."""
    if isinstance(tree, dict):
        per_key = {k: _unstack(v, count) for k, v in tree.items()}
        return [{k: v[i] for k, v in per_key.items()} for i in range(count)]
    return list(torch.unbind(tree))


def _remat_contexts():
    """Checkpoint contexts: nothing around the forward; around the
    recompute, the policy scope the forward ran under (the recompute runs
    in the backward, on the autograd engine's thread)."""
    return contextlib.nullcontext(), resume_scope(current_scope())


@contextlib.contextmanager
def _replaying(scope, records):
    with resume_scope(scope), remat_replay(records):
        yield


def _dots_contexts():
    """``remat="dots"`` checkpoint contexts: the forward records its
    NT/NN/TN outputs, and the recompute replays them under the forward's
    policy scope."""
    records: list = []
    return remat_record(records), _replaying(current_scope(), records)


def _remat_wrap(fn, cfg):
    if cfg.remat == "none":
        return fn
    if cfg.remat not in ("full", "dots"):
        raise ValueError(f"unknown remat {cfg.remat!r}")
    contexts = _remat_contexts if cfg.remat == "full" else _dots_contexts

    def wrapped(x, *args):
        # save only unit boundaries (and under 'dots' the unit's non-batched
        # GEMM outputs); the model draws no random numbers
        return torch.utils.checkpoint.checkpoint(
            fn, x, *args, use_reentrant=False, preserve_rng_state=False,
            context_fn=contexts,
        )

    return wrapped


def vocab_split(cfg) -> bool:
    """Whether the current mesh's ``model`` axis splits the embedding (and
    the LM head) over the vocabulary."""
    return weight_dim(("embed", "emb"), (cfg.vocab_padded, cfg.d_model)) == 0


def gather_logits(cfg, logits: torch.Tensor) -> torch.Tensor:
    """The whole vocabulary's logits from this rank's slice (as they are
    without a vocab split)."""
    return all_gather(logits, "model", dim=-1) if vocab_split(cfg) else logits


def _embed_tokens(params: Param, cfg, tokens: torch.Tensor) -> torch.Tensor:
    x = embed(params["embed"], tokens, cfg.emb_scale, vocab_split=vocab_split(cfg))
    return x if cfg.emb_mult == 1.0 else x * cfg.emb_mult


def _embed_input(params: Param, cfg, batch: Dict[str, torch.Tensor]):
    """(x, prefix_len): the embedded input and the length of its
    bidirectional prefix (the patches under ``vlm``, else 0)."""
    if cfg.input_mode == "tokens":
        return _embed_tokens(params, cfg, batch["tokens"]), 0
    if cfg.input_mode == "frames":
        return batch["frames"].to(_dtype(cfg)), 0
    if cfg.input_mode == "vlm":
        patches = batch["patches"].to(_dtype(cfg))
        text = _embed_tokens(params, cfg, batch["tokens"])
        return torch.cat([patches, text], dim=1), patches.shape[1]
    raise ValueError(f"unknown input_mode {cfg.input_mode!r}")


def _logits(params: Param, cfg, x: torch.Tensor) -> torch.Tensor:
    x = rmsnorm(params["final_norm"], x, eps=cfg.rms_eps)
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    logits = unembed(head, x, vocab_split(cfg))
    if cfg.logits_div != 1.0:
        logits = logits / cfg.logits_div
    return softcap(logits, cfg.final_softcap)


def lm_forward(params: Param, cfg, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    x, prefix_len = _embed_input(params, cfg, batch)
    shared = params.get("shared")
    for (count, blocks), slot_params in zip(cfg.segments, params["segments"]):
        def unit(h, unit_params, shared, _blocks=blocks):
            for b, bp in zip(_blocks, unit_params):
                h = apply_block(bp, h, b, cfg, shared, prefix_len=prefix_len)
            return h

        body = _remat_wrap(unit, cfg)
        layers = [_unstack(sp, count) for sp in slot_params]
        for i in range(count):
            x = body(x, tuple(per_slot[i] for per_slot in layers), shared)
    return _logits(params, cfg, x)


def lm_loss(params: Param, cfg, batch: Dict[str, torch.Tensor]):
    """(mean next-token cross-entropy, {"loss": it}); ``batch`` holds the
    input (``tokens``, ``frames``, or ``patches`` and ``tokens``) and
    ``labels``, and may hold a ``loss_mask``.  Under ``vlm`` only the text
    positions are scored."""
    logits = lm_forward(params, cfg, batch)
    if cfg.input_mode == "vlm":
        logits = logits[:, cfg.prefix_len:]  # loss on text positions only
    loss = cross_entropy_loss(logits, batch["labels"], batch.get("loss_mask"),
                              vocab_split=vocab_split(cfg))
    return loss, {"loss": loss}


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
    x, prefix_len = _embed_input(params, cfg, batch)
    shared = params.get("shared")
    caches = []
    for (count, blocks), slot_params in zip(cfg.segments, params["segments"]):
        per_slot = [[] for _ in blocks]
        for i in range(count):
            for j, (b, sp) in enumerate(zip(blocks, slot_params)):
                x, c = prefill_block(
                    _index(sp, i), x, b, cfg, max_seq, shared, prefix_len=prefix_len,
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
    segment, one dict per block slot, ``{"k", "v"}`` with leaves (layers,
    batch, slots, kv, dh) for attention or ``{"conv", "ssm"}`` with leaves
    (layers, batch, d_conv - 1, conv_width) and (layers, batch, heads,
    head_dim, d_state) for Mamba (``SSMConfig.conv_width``).  ``per_seq_pos`` makes ``pos`` a
    ``(batch,)`` vector."""
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


def lm_decode(params: Param, cfg, cache, batch: Dict[str, torch.Tensor], cache_specs=None):
    """One-token step.  batch: {'tokens': (B, 1)} or {'frames': (B, 1, d)}.

    Returns (logits (B, 1, V), cache with pos + 1).  ``cache['pos']`` may
    be a scalar (uniform batch) or a ``(B,)`` vector (each row decodes at
    its own position).  The cache tensors are updated in place, a Mamba
    block's new state copied over its old: the returned cache holds the
    same tensors.  Under a mesh of more than one rank ``cache_specs`` (the
    cache's ``cache_specs_tree``, its ``pos`` entry unread) must say how
    its leaves are split (``attention_decode``)."""
    mesh = current_mesh()
    if cache_specs is None and mesh is not None and mesh.size > 1:
        raise ValueError("decode on a mesh needs cache_specs: the cache's specs tell "
                         "which slots this rank holds")
    pos = cache["pos"]
    if cfg.input_mode == "frames":
        x = batch["frames"].to(_dtype(cfg))
    else:
        x = _embed_tokens(params, cfg, batch["tokens"])
    shared = params.get("shared")
    seg_specs = cache_specs["segments"] if cache_specs is not None else [None] * len(cfg.segments)
    for (count, blocks), slot_params, seg_cache, seg_spec in zip(
        cfg.segments, params["segments"], cache["segments"], seg_specs
    ):
        cspecs = [s.get("k") for s in seg_spec] if seg_spec is not None else [None] * len(blocks)
        for i in range(count):
            for b, sp, sc, cspec in zip(blocks, slot_params, seg_cache, cspecs):
                old = _index(sc, i)
                x, new = decode_block(_index(sp, i), x, b, cfg, old, pos, shared, cspec)
                if new is not old:  # a Mamba block's new state
                    for k, leaf in new.items():
                        old[k].copy_(leaf)
    logits = _logits(params, cfg, x)
    return logits, {"segments": cache["segments"], "pos": pos + 1}
