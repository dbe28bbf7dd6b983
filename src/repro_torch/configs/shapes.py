"""The assigned input-shape set and meta-tensor ``input_specs``.

Every cell of the (arch x shape) grid is defined here, as in the JAX
package; ``launch/dryrun.py`` runs one rank's train, prefill or decode
step per the shape's kind on ``meta`` tensors, which carry a shape and a
dtype and no storage (the JAX package's ``ShapeDtypeStruct`` stand-ins).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch

__all__ = ["ShapeCell", "SHAPES", "input_specs", "cache_specs", "cell_applicable"]


@dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def cell_applicable(cfg, shape: ShapeCell) -> Tuple[bool, str]:
    """The assignment's skip rule: long_500k only for sub-quadratic archs."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "SKIP(full-attn): 512k dense KV outside design envelope"
    return True, ""


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _tok(b: int, s: int) -> torch.Tensor:
    return _meta((b, s), torch.int32)


def input_specs(cfg, shape: ShapeCell) -> Dict[str, torch.Tensor]:
    """Model inputs for one step of this cell (no labels for serve kinds),
    as meta tensors.  Float inputs are in the compute dtype (the port's
    ``param_dtype``: activations follow the params)."""
    B, S = shape.global_batch, shape.seq_len
    emb = getattr(torch, cfg.param_dtype)
    if shape.kind == "train" or shape.kind == "prefill":
        if cfg.input_mode == "tokens":
            d = {"tokens": _tok(B, S)}
        elif cfg.input_mode == "frames":
            d = {"frames": _meta((B, S, cfg.d_model), emb)}
        else:  # vlm: S = prefix patches + text
            st = S - cfg.prefix_len
            d = {"patches": _meta((B, cfg.prefix_len, cfg.d_model), emb), "tokens": _tok(B, st)}
        if shape.kind == "train":
            lab = S - cfg.prefix_len if cfg.input_mode == "vlm" else S
            d["labels"] = _tok(B, lab)
        return d
    # decode: one new token against a cache of S
    if cfg.input_mode == "frames":
        return {"frames": _meta((B, 1, cfg.d_model), emb)}
    return {"tokens": _tok(B, 1)}


def cache_specs(cfg, shape: ShapeCell, dtype=torch.bfloat16):
    """The decode cache of this cell as a tree of meta tensors."""
    from repro_torch.models.lm import init_lm_cache

    return init_lm_cache(cfg, shape.global_batch, shape.seq_len, dtype, device="meta")
