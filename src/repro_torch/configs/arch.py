"""ArchConfig -- the declarative description every subsystem reads.

``segments`` is a tuple of ``(repeat, (BlockCfg, ...))``: the layer stack
loops over each segment, one iteration applying the unit's blocks in
order.  The fields are the JAX package's that the ported architectures
set (MoE, SSM and sharding fields come with their subsystems).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

from repro_torch.models.blocks import BlockCfg

__all__ = ["ArchConfig", "BlockCfg"]


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | audio | vlm
    d_model: int
    n_heads: int
    n_kv: int
    d_head: int
    d_ff: int
    vocab: int
    segments: Tuple[Tuple[int, Tuple[BlockCfg, ...]], ...]
    # attention details
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    qk_norm: bool = False
    rope_theta: float = 10000.0
    attn_chunk: int = 1024
    post_norm: bool = False
    # embedding / head
    tie_embeddings: bool = True
    emb_scale: bool = False
    vocab_pad: int = 256
    # modality
    input_mode: str = "tokens"  # tokens | frames (audio stub) | vlm (patch stub)
    prefix_len: int = 0  # vlm: bidirectional patch prefix
    activation: str = "gelu"
    # numerics: params in param_dtype, and activations follow them
    param_dtype: str = "bfloat16"
    # training: rematerialisation per layer unit and the optimizer
    remat: str = "full"  # none | full ('dots' is not ported)
    optimizer: str = "adamw"  # adamw ('adafactor' is not ported)
    # capability flags
    sub_quadratic: bool = False  # eligible for long_500k

    @property
    def vocab_padded(self) -> int:
        return _round_up(self.vocab, self.vocab_pad)

    @property
    def n_layers(self) -> int:
        return sum(c * len(blocks) for c, blocks in self.segments)

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)
