"""zamba2-7b [hybrid] — 81 blocks, d_model 3584, 32H MHA(kv=32), d_ff 14336,
vocab 32000, ssm_state 64; Mamba2 backbone + *shared-weight* attention
blocks (Zamba2's defining trick).  [arXiv:2411.15242; unverified]

81 = 13 x (5 mamba + 1 shared-attn+MLP) + 3 mamba tail."""

from .arch import ArchConfig, BlockCfg, SSMConfig

_M = BlockCfg("mamba", "none")
_A = BlockCfg("shared_attn", "mlp")

CONFIG = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    d_model=3584,
    n_heads=32,
    n_kv=32,
    d_head=112,  # d_model / n_heads
    d_ff=14336,
    vocab=32000,
    segments=(
        (13, (_M, _M, _M, _M, _M, _A)),
        (1, (_M, _M, _M)),
    ),
    ssm=SSMConfig(d_model=3584, d_state=64, d_conv=4, expand=2, head_dim=64),
    tie_embeddings=True,
    activation="gelu",
    sub_quadratic=True,  # SSM backbone: O(1) decode state
)
