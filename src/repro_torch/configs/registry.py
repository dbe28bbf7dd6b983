"""Architecture registry: ``--arch <id>`` resolution + smoke reductions.

The port has the JAX package's ten architectures: the attention-only
``smollm-135m``, ``gemma3-4b``, ``gemma2-27b``, ``h2o-danube-3-4b``,
``paligemma-3b`` (``vlm``) and ``musicgen-large`` (``frames``); the MoE
``grok-1-314b`` and ``kimi-k2-1t-a32b``; the Mamba-2 ``mamba2-2.7b``; and
the hybrid ``zamba2-7b``.  ``PORT_ARCHS`` holds the port's own beyond
them, which the JAX package does not have: the hybrid
``granite-4.0-h-small`` (Mamba-2 with the xBC conv, a dropless MoE with
a shared expert, NoPE attention, muP multipliers).  ``get_config`` and
``smoke_config`` take both; ``list_archs`` and ``ARCHS`` are the ten.
``smoke_config`` shrinks a full config to a CPU-runnable one of the
same structure, with the JAX package's reductions.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

from . import (
    gemma2_27b,
    gemma3_4b,
    granite_4_0_h_small,
    grok_1_314b,
    h2o_danube3_4b,
    kimi_k2_1t,
    mamba2_2p7b,
    musicgen_large,
    paligemma_3b,
    smollm_135m,
    zamba2_7b,
)
from .arch import ArchConfig, MoEConfig, SSMConfig

__all__ = ["ARCHS", "PORT_ARCHS", "get_config", "list_archs", "smoke_config"]

ARCHS: Dict[str, ArchConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (gemma2_27b, gemma3_4b, h2o_danube3_4b, smollm_135m, kimi_k2_1t, grok_1_314b,
              zamba2_7b, musicgen_large, paligemma_3b, mamba2_2p7b)
}
PORT_ARCHS: Dict[str, ArchConfig] = {m.CONFIG.name: m.CONFIG for m in (granite_4_0_h_small,)}


def get_config(name: str) -> ArchConfig:
    if name in ARCHS:
        return ARCHS[name]
    if name in PORT_ARCHS:
        return PORT_ARCHS[name]
    raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS) + sorted(PORT_ARCHS)}")


def list_archs() -> List[str]:
    return sorted(ARCHS)


def _shrink_segments(segments, max_units: int = 1):
    """Keep the segment structure, shrink repeats."""
    out = []
    for count, blocks in segments:
        shrunk = [
            dataclasses.replace(b, window=8 if b.window is not None else None)
            for b in blocks
        ]
        out.append((min(count, max_units), tuple(shrunk)))
    return tuple(out)


def smoke_config(name: str) -> ArchConfig:
    """Tiny same-family config: one forward or train step must run on the
    CPU."""
    full = get_config(name)
    kw = dict(
        d_model=64,
        d_ff=128 if full.d_ff else 0,
        vocab=97,  # deliberately ragged: exercises vocab padding
        vocab_pad=16,
        segments=_shrink_segments(full.segments),
        attn_chunk=16,
        param_dtype="float32",
        remat="none",
        optimizer="adamw",
    )
    if full.n_heads:
        if full.n_kv == 1:
            kw.update(n_heads=4, n_kv=1, d_head=16)  # keep MQA
        elif full.n_kv == full.n_heads:
            kw.update(n_heads=4, n_kv=4, d_head=16)  # keep MHA
        else:
            kw.update(n_heads=4, n_kv=2, d_head=16)  # keep GQA
    if full.moe is not None:
        kw["moe"] = MoEConfig(
            d_model=64, d_ff=32, n_experts=4, top_k=min(full.moe.top_k, 2), group=16,
            capacity_factor=2.0 if full.moe.capacity_factor is not None else None,
            shard=full.moe.shard, shared_d_ff=64 if full.moe.shared_d_ff else 0,
        )
    if full.ssm is not None:
        kw["ssm"] = SSMConfig(d_model=64, d_state=16, d_conv=4, expand=2, head_dim=16, chunk=8,
                              conv_xbc=full.ssm.conv_xbc)
    if full.input_mode == "vlm":
        kw["prefix_len"] = 4
    return full.replace(**kw)
