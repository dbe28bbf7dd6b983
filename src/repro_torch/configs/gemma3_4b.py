"""gemma3-4b [dense] -- 34L, d_model 2560, 8H GQA(kv=4), d_ff 10240,
vocab 262144; 5:1 local:global, 128k context, QK-norm.
[hf:google/gemma-3-*-pt; unverified]

34 layers = 5 x (5 local + 1 global) + 4 local tail.  Single rope theta
(simplification: gemma3 uses 1M for globals; DESIGN.md §4)."""

from .arch import ArchConfig, BlockCfg

_L = BlockCfg("attn", "mlp", window=1024)
_G = BlockCfg("attn", "mlp")

CONFIG = ArchConfig(
    name="gemma3-4b",
    family="dense",
    d_model=2560,
    n_heads=8,
    n_kv=4,
    d_head=256,
    d_ff=10240,
    vocab=262144,
    segments=(
        (5, (_L, _L, _L, _L, _L, _G)),
        (1, (_L, _L, _L, _L)),
    ),
    qk_norm=True,
    post_norm=True,
    tie_embeddings=True,
    emb_scale=True,
    activation="gelu",
    sub_quadratic=True,
)
