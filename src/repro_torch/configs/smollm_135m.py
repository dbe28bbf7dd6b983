"""smollm-135m [dense] -- 30L, d_model 576, 9H GQA(kv=3), d_ff 1536,
vocab 49152; llama-arch small.  [hf:HuggingFaceTB/SmolLM-135M; hf]"""

from .arch import ArchConfig, BlockCfg

CONFIG = ArchConfig(
    name="smollm-135m",
    family="dense",
    d_model=576,
    n_heads=9,
    n_kv=3,
    d_head=64,
    d_ff=1536,
    vocab=49152,
    segments=((30, (BlockCfg("attn", "mlp"),)),),
    tie_embeddings=True,
    activation="silu",
)
