"""Architecture registry: ``--arch <id>`` resolution + smoke reductions.

This slice ports ``smollm-135m``; the JAX package's other architectures
need MoE, SSM or multimodal support and raise ``KeyError`` naming the
ROADMAP item.  ``smoke_config`` shrinks a full config to a CPU-runnable
one of the same structure, with the JAX package's reductions.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

from . import smollm_135m
from .arch import ArchConfig

__all__ = ["ARCHS", "get_config", "list_archs", "smoke_config"]

ARCHS: Dict[str, ArchConfig] = {smollm_135m.CONFIG.name: smollm_135m.CONFIG}


def get_config(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(
            f"arch {name!r} is not ported; have {sorted(ARCHS)} (the other "
            "architectures wait on ROADMAP.md queue A, 'MoE and SSM')"
        )
    return ARCHS[name]


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
    """Tiny same-family config: one step must run on the CPU."""
    full = get_config(name)
    kw = dict(
        d_model=64,
        d_ff=128,
        vocab=97,  # deliberately ragged: exercises vocab padding
        vocab_pad=16,
        segments=_shrink_segments(full.segments),
        attn_chunk=16,
        param_dtype="float32",
    )
    if full.n_kv == 1:
        kw.update(n_heads=4, n_kv=1, d_head=16)  # keep MQA
    elif full.n_kv == full.n_heads:
        kw.update(n_heads=4, n_kv=4, d_head=16)  # keep MHA
    else:
        kw.update(n_heads=4, n_kv=2, d_head=16)  # keep GQA
    return full.replace(**kw)
