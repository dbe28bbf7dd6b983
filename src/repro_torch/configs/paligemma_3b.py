"""paligemma-3b [vlm] -- 18L, d_model 2048, 8H MQA(kv=1), d_ff 16384,
vocab 257216; SigLIP + gemma backbone.  [arXiv:2407.07726; hf]

Backbone only: the SigLIP tower is a stub -- ``input_specs()`` supplies 256
precomputed patch embeddings prepended as a bidirectional prefix
(prefix-LM masking)."""

from .arch import ArchConfig, BlockCfg

CONFIG = ArchConfig(
    name="paligemma-3b",
    family="vlm",
    d_model=2048,
    n_heads=8,
    n_kv=1,
    d_head=256,
    d_ff=16384,
    vocab=257216,
    segments=((18, (BlockCfg("attn", "mlp"),)),),
    input_mode="vlm",
    prefix_len=256,
    tie_embeddings=True,
    emb_scale=True,
    activation="gelu",
    sub_quadratic=False,
)
