"""The port's granite-4.0-h-small (``granitemoehybrid``) built from a
configuration file, its seeded weights, and the reference's view of
them.  Import this only after ``harness.prepare_environment``.

The layer pattern of ``layer_types`` becomes one segment of its
shortest period (``mamba`` layers a Mamba-2 mixer, ``attention`` ones
NoPE GQA; every layer's FFN the dropless MoE with its shared expert).

Weights (``params``): the program's tree read from its own initialiser
on the ``meta`` device, the values the benchmark's, drawn on the device
from the seed in each leaf's own dtype (one draw a dtype): a dense
weight ``(out, in)`` N(0, 1/in), the embedding N(0, 0.002^2), the
conv's taps and bias N(0, 1/d_conv), norm scales zero; ``A_log``, ``dt_bias``
and ``D`` as Mamba-2's reference initialises them (``A`` uniform over
[1, 16], ``dt`` log-uniform over [0.001, 0.1] through the inverse
softplus, ``D`` one), so that the state's memory spans chunks.  The
embedding is a tenth of Hugging Face's 0.02: the head is tied, and at
0.02 a token's own logit (``embedding_multiplier`` times its squared
norm) stands about eight spreads above the rest, so a random model
repeats its last token whatever its layers compute, which would hide
them from the served-token check.  The
same seed on the same device gives the same values, so the reference
draws them again instead of reading the program's.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from repro_torch.configs.arch import BlockCfg, MoEConfig, PortArchConfig, SSMConfig
from repro_torch.models import lm

from . import weights
from .traffic import derive

__all__ = ["arch_config", "params", "reference_params", "MIXERS"]

MIXERS = {"mamba": "mamba", "attention": "attn"}
DT_RANGE = (0.001, 0.1)
A_RANGE = (1.0, 16.0)
EMB_STD = 0.002


def _period(kinds: List[str]) -> int:
    n = len(kinds)
    return next(p for p in range(1, n + 1) if n % p == 0 and kinds == kinds[:p] * (n // p))


def arch_config(cfg: Dict) -> PortArchConfig:
    """The port's config of a ``granitemoehybrid`` configuration file."""
    if cfg["hidden_act"] != "silu" or cfg["position_embedding_type"] != "nope":
        raise ValueError("a granitemoehybrid file here is SiLU-gated with NoPE attention")
    if cfg["mamba_n_groups"] != 1 or cfg["mamba_proj_bias"] or not cfg["mamba_conv_bias"]:
        raise ValueError("the port's Mamba-2 layer has one group, no projection bias and a "
                         "conv bias")
    d, H = int(cfg["hidden_size"]), int(cfg["num_attention_heads"])
    kinds = list(cfg["layer_types"])
    if len(kinds) != cfg["num_hidden_layers"]:
        raise ValueError("layer_types must list every layer")
    p = _period(kinds)
    unit = tuple(BlockCfg(MIXERS[k], "moe") for k in kinds[:p])
    ssm = SSMConfig(d_model=d, d_state=int(cfg["mamba_d_state"]), d_conv=int(cfg["mamba_d_conv"]),
                    expand=int(cfg["mamba_expand"]), head_dim=int(cfg["mamba_d_head"]),
                    chunk=int(cfg["mamba_chunk_size"]), conv_xbc=True)
    if ssm.n_heads != cfg["mamba_n_heads"]:
        raise ValueError("mamba_n_heads must be expand * hidden_size / mamba_d_head")
    return PortArchConfig(
        name=cfg["name"],
        family="hybrid",
        d_model=d,
        n_heads=H,
        n_kv=int(cfg["num_key_value_heads"]),
        d_head=d // H,
        d_ff=int(cfg["intermediate_size"]),
        vocab=int(cfg["vocab_size"]),
        segments=((len(kinds) // p, unit),),
        moe=MoEConfig(d_model=d, d_ff=int(cfg["intermediate_size"]),
                      n_experts=int(cfg["num_local_experts"]),
                      top_k=int(cfg["num_experts_per_tok"]), capacity_factor=None,
                      shared_d_ff=int(cfg["shared_intermediate_size"])),
        ssm=ssm,
        tie_embeddings=bool(cfg["tie_word_embeddings"]),
        activation="silu",
        param_dtype=cfg["torch_dtype"],
        remat="none",
        emb_mult=float(cfg["embedding_multiplier"]),
        residual_mult=float(cfg["residual_multiplier"]),
        logits_div=float(cfg["logits_scaling"]),
        rms_eps=float(cfg["rms_norm_eps"]),
        attn_rope=False,
        attn_scale=float(cfg["attention_multiplier"]),
    )


def _normal_std(path, shape, d_conv: int) -> float:
    """The std of a normal leaf; 0.0 for a zero one."""
    name = path[-1]
    if name == "scale":
        return 0.0
    if name == "emb":
        return EMB_STD
    if name in ("conv_w", "conv_b"):
        return 1.0 / math.sqrt(d_conv)
    return 1.0 / math.sqrt(shape[-1])


def _ssm_vector(name: str, t: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """``A_log``, ``dt_bias`` or ``D`` as Mamba-2's reference initialises
    them, in float32."""
    if name == "D":
        return torch.ones(t.shape, dtype=t.dtype, device=gen.device)
    u = torch.rand(t.shape, generator=gen, device=gen.device, dtype=torch.float32)
    if name == "A_log":
        return torch.log(A_RANGE[0] + u * (A_RANGE[1] - A_RANGE[0])).to(t.dtype)
    lo, hi = (math.log(x) for x in DT_RANGE)
    dt = torch.exp(lo + u * (hi - lo))
    return (dt + torch.log(-torch.expm1(-dt))).to(t.dtype)  # softplus^-1(dt)


def params(cfg: Dict, seed: int, device):
    """The benchmark's weights in the program's tree (the module
    docstring)."""
    arch = arch_config(cfg)
    if arch.vocab_padded != arch.vocab:
        raise ValueError("the vocabulary must be a multiple of the port's padding (256)")
    shapes = lm.init_lm(0, arch, device="meta")
    items = list(weights.tree_items(shapes))
    d_conv = arch.ssm.d_conv
    views: Dict = {}
    for dtype in sorted({t.dtype for _, t in items}, key=str):
        normal = [(p, t) for p, t in items if t.dtype == dtype
                  and p[-1] not in ("A_log", "dt_bias", "D") and _normal_std(p, t.shape, d_conv)]
        gen = torch.Generator(device=device).manual_seed(derive(seed, "weights", str(dtype)))
        flat = torch.randn(sum(t.numel() for _, t in normal), generator=gen, device=device,
                           dtype=dtype)
        at = 0
        for p, t in normal:
            views[p] = flat[at:at + t.numel()].view(t.shape).mul_(_normal_std(p, t.shape, d_conv))
            at += t.numel()
    gen = torch.Generator(device=device).manual_seed(derive(seed, "ssm"))
    for p, t in items:
        if p[-1] in ("A_log", "dt_bias", "D"):
            views[p] = _ssm_vector(p[-1], t, gen)

    def leaf(path, t):
        if path in views:
            return views[path]
        return torch.zeros(t.shape, dtype=t.dtype, device=device)

    return weights.tree_build(shapes, leaf)


def reference_params(tree, cfg: Dict) -> Dict:
    """The reference's view of the program's tree (no copies): ``embed``,
    ``final_norm`` and one dict a layer, in order."""
    arch = arch_config(cfg)
    (count, unit), = arch.segments
    slots = tree["segments"][0]
    layers = []
    for rep in range(count):
        for b, sp in zip(unit, slots):
            layer = {"ln1": sp["ln1"]["scale"][rep], "ln2": sp["ln2"]["scale"][rep]}
            if b.mixer == "mamba":
                s = sp["ssm"]
                for n in ("wz", "wx", "wB", "wC", "wdt", "out"):
                    layer[n] = s[n]["w"][rep]
                for n in ("conv_w", "conv_b", "A_log", "D", "dt_bias"):
                    layer[n] = s[n][rep]
                layer["norm"] = s["norm"]["scale"][rep]
            else:
                for n in ("wq", "wk", "wv", "wo"):
                    layer[n] = sp["attn"][n]["w"][rep]
            m = sp["moe"]
            layer["router"] = m["router"]["w"][rep]
            for n in ("gate", "up", "down"):
                layer[n] = m[n][rep]
                layer["shared_" + n] = m["shared"][n]["w"][rep]
            layers.append(layer)
    return {"embed": tree["embed"]["emb"], "final_norm": tree["final_norm"]["scale"],
            "layers": layers}
