"""kimi-k2-1t-a32b [moe] — 61L, d_model 7168, 64H GQA(kv=8), per-expert
d_ff 2048, vocab 163840; MoE 384 experts top-8 (trillion-param).
[arXiv:2501.kimi2; unverified]

Per the assignment spec we implement GQA (kv=8), not MLA (DESIGN.md §4).
Adafactor optimizer: AdamW f32 state for 1T params exceeds a 512-chip
v5e pod's aggregate HBM."""

from .arch import ArchConfig, BlockCfg, MoEConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    d_model=7168,
    n_heads=64,
    n_kv=8,
    d_head=128,
    d_ff=2048,  # per-expert hidden
    vocab=163840,
    segments=((61, (BlockCfg("attn", "moe"),)),),
    moe=MoEConfig(
        d_model=7168, d_ff=2048, n_experts=384, top_k=8,
        group=256, capacity_factor=2.0, shard="expert",
    ),
    tie_embeddings=False,
    activation="silu",
    optimizer="adafactor",
    sub_quadratic=False,
)
