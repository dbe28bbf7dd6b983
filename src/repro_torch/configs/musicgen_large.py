"""musicgen-large [audio] -- 48L, d_model 2048, 32H MHA(kv=32), d_ff 8192,
vocab 2048; decoder-only over EnCodec tokens.  [arXiv:2306.05284; hf]

Backbone only: the EnCodec frontend is a stub -- ``input_specs()`` supplies
precomputed frame embeddings (B, S, d_model)."""

from .arch import ArchConfig, BlockCfg

CONFIG = ArchConfig(
    name="musicgen-large",
    family="audio",
    d_model=2048,
    n_heads=32,
    n_kv=32,
    d_head=64,
    d_ff=8192,
    vocab=2048,
    segments=((48, (BlockCfg("attn", "mlp"),)),),
    input_mode="frames",
    tie_embeddings=True,  # embed table doubles as the 2048-way codec head
    activation="gelu",
    vocab_pad=128,  # vocab is only 2048; pad to 128-multiples
    sub_quadratic=False,
)
