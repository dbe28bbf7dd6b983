"""h2o-danube-3-4b [dense] -- 24L, d_model 3840, 32H GQA(kv=8), d_ff 10240,
vocab 32000; llama+mistral mix with sliding-window attention.
[arXiv:2401.16818; unverified]"""

from .arch import ArchConfig, BlockCfg

CONFIG = ArchConfig(
    name="h2o-danube-3-4b",
    family="dense",
    d_model=3840,
    n_heads=32,
    n_kv=8,
    d_head=120,  # d_model / n_heads
    d_ff=10240,
    vocab=32000,
    segments=((24, (BlockCfg("attn", "mlp", window=4096),)),),
    tie_embeddings=True,
    activation="silu",
    sub_quadratic=True,  # pure SWA: bounded KV at any context
)
