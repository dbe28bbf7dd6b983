"""The system under test, built from a configuration file: the port's
config objects, its parameter tree filled with the benchmark's weights.
Import this only after ``harness.prepare_environment``: the port reads
its build directory from the environment.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.arch import ArchConfig, BlockCfg
from repro_torch.models import fcn as fcn_model
from repro_torch.models import lm

from . import weights

__all__ = ["fcn_config", "arch_config", "fcn_params", "lm_params", "dtype_of"]

# the port's RMSNorm (models/layers.py::rmsnorm) has this epsilon and no option
PORT_RMS_EPS = 1e-6


def dtype_of(cfg: Dict) -> torch.dtype:
    return getattr(torch, cfg["torch_dtype"])


def fcn_config(cfg: Dict) -> fcn_model.FCNConfig:
    return fcn_model.FCNConfig(cfg["name"], int(cfg["input_dim"]), int(cfg["output_dim"]),
                               tuple(int(h) for h in cfg["hidden"]))


def arch_config(cfg: Dict) -> ArchConfig:
    """The port's ``ArchConfig`` of a dense decoder configuration file."""
    if cfg["rms_norm_eps"] != PORT_RMS_EPS:
        raise ValueError(f"the port's RMSNorm runs eps {PORT_RMS_EPS}, the file states "
                         f"{cfg['rms_norm_eps']}")
    if cfg["hidden_act"] != "silu":
        raise ValueError("a dense decoder file here is SiLU-gated")
    window = cfg.get("sliding_window") or None
    return ArchConfig(
        name=cfg["name"],
        family="dense",
        d_model=int(cfg["hidden_size"]),
        n_heads=int(cfg["num_attention_heads"]),
        n_kv=int(cfg["num_key_value_heads"]),
        d_head=int(cfg["head_dim"]),
        d_ff=int(cfg["intermediate_size"]),
        vocab=int(cfg["vocab_size"]),
        segments=((int(cfg["num_hidden_layers"]), (BlockCfg("attn", "mlp", window=window),)),),
        rope_theta=float(cfg["rope_theta"]),
        tie_embeddings=bool(cfg["tie_word_embeddings"]),
        activation="silu",
        param_dtype=cfg["torch_dtype"],
        remat=cfg.get("remat", "full"),
    )


def fcn_params(cfg: Dict, seed: int, device):
    shapes = fcn_model.init_fcn(0, fcn_config(cfg), dtype_of(cfg), device="meta")
    return weights.fill(shapes, seed, device, dtype_of(cfg))


def lm_params(cfg: Dict, seed: int, device):
    arch = arch_config(cfg)
    if arch.vocab_padded != arch.vocab:
        raise ValueError("the vocabulary must be a multiple of the port's padding (256)")
    shapes = lm.init_lm(0, arch, device="meta")
    return weights.fill(shapes, seed, device, dtype_of(cfg))
