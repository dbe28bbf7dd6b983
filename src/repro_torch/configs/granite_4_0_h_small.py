"""granite-4.0-h-small [hybrid] -- IBM Granite 4.0-H Small (32B-A9B),
``granitemoehybrid``: 40 layers at d_model 4096, vocab 100352, tied
embeddings.  [hf:ibm-granite/granite-4.0-h-small, config.json]

40 = 4 x (5 mamba + 1 attention + 4 mamba): attention at layers 5, 15,
25 and 35.  Mamba-2: 128 heads of 64 (expand 2), d_state 128, one group,
conv 4 over x, B and C with a bias, chunk 256.  Attention: GQA 32/8
heads of 128, no rotary positions (NoPE), query scale 1/128.  Every
layer's FFN: a dropless MoE of 72 experts of width 768, top-10, and a
shared SiLU-gated expert of width 1536.  muP: embeddings times 12, each
block's outputs times 0.22, logits over 16; RMSNorm epsilon 1e-5."""

from .arch import BlockCfg, MoEConfig, PortArchConfig, SSMConfig

_M = BlockCfg("mamba", "moe")
_A = BlockCfg("attn", "moe")

CONFIG = PortArchConfig(
    name="granite-4.0-h-small",
    family="hybrid",
    d_model=4096,
    n_heads=32,
    n_kv=8,
    d_head=128,  # hidden_size / num_attention_heads
    d_ff=768,  # per-expert hidden
    vocab=100352,
    segments=((4, (_M, _M, _M, _M, _M, _A, _M, _M, _M, _M)),),
    moe=MoEConfig(d_model=4096, d_ff=768, n_experts=72, top_k=10, capacity_factor=None,
                  shared_d_ff=1536),
    ssm=SSMConfig(d_model=4096, d_state=128, d_conv=4, expand=2, head_dim=64, chunk=256,
                  conv_xbc=True),
    tie_embeddings=True,
    activation="silu",
    emb_mult=12.0,
    residual_mult=0.22,
    logits_div=16.0,
    rms_eps=1e-5,
    attn_rope=False,
    attn_scale=0.0078125,
    sub_quadratic=False,
)
