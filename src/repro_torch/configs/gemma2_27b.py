"""gemma2-27b [dense] -- 46L, d_model 4608, 32H GQA(kv=16), d_ff 36864,
vocab 256000; 1:1 local:global alternation, logit soft-capping.
[arXiv:2408.00118; hf]"""

from .arch import ArchConfig, BlockCfg

CONFIG = ArchConfig(
    name="gemma2-27b",
    family="dense",
    d_model=4608,
    n_heads=32,
    n_kv=16,
    d_head=128,
    d_ff=36864,
    vocab=256000,
    # 46 layers = 23 scanned (local, global) pairs
    segments=(
        (23, (BlockCfg("attn", "mlp", window=4096), BlockCfg("attn", "mlp"))),
    ),
    attn_softcap=50.0,
    final_softcap=30.0,
    post_norm=True,
    tie_embeddings=True,
    emb_scale=True,
    activation="gelu",
    # windowed locals + linear-at-decode globals => long_500k eligible
    sub_quadratic=True,
)
