"""grok-1-314b [moe] — 64L, d_model 6144, 48H GQA(kv=8), d_ff 32768,
vocab 131072; MoE 8 experts top-2.  [hf:xai-org/grok-1; unverified]

8 experts < model-axis(16), so EP is impossible on this mesh; experts use
TP-within-expert on d_ff instead (``shard='ffn'``, DESIGN.md §5)."""

from .arch import ArchConfig, BlockCfg, MoEConfig

CONFIG = ArchConfig(
    name="grok-1-314b",
    family="moe",
    d_model=6144,
    n_heads=48,
    n_kv=8,
    d_head=128,
    d_ff=32768,
    vocab=131072,
    segments=((64, (BlockCfg("attn", "moe"),)),),
    moe=MoEConfig(
        d_model=6144, d_ff=32768, n_experts=8, top_k=2,
        group=256, capacity_factor=2.0, shard="ffn",
    ),
    tie_embeddings=False,
    activation="gelu",
    optimizer="adafactor",
    sub_quadratic=False,
)
