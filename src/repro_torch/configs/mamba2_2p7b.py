"""mamba2-2.7b [ssm] — 64L, d_model 2560, attention-free, vocab 50280,
ssm_state 128; SSD (state-space duality).  [arXiv:2405.21060; unverified]

vocab padded 50280 -> 50432 so the embedding shards over the 16-way model
axis."""

from .arch import ArchConfig, BlockCfg, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b",
    family="ssm",
    d_model=2560,
    n_heads=0,  # attention-free
    n_kv=0,
    d_head=0,
    d_ff=0,
    vocab=50280,
    segments=((64, (BlockCfg("mamba", "none"),)),),
    ssm=SSMConfig(d_model=2560, d_state=128, d_conv=4, expand=2, head_dim=64),
    tie_embeddings=True,
    activation="silu",
    sub_quadratic=True,
)
