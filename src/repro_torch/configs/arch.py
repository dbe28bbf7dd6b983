"""ArchConfig -- the declarative description every subsystem reads.

``segments`` is a tuple of ``(repeat, (BlockCfg, ...))``: the layer stack
loops over each segment, one iteration applying the unit's blocks in
order.  The fields are the JAX package's that the architectures set
(its sharding and accounting fields have no counterpart on one device).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

from repro_torch.models.blocks import BlockCfg
from repro_torch.models.moe import MoEConfig
from repro_torch.models.ssm import SSMConfig

__all__ = ["ArchConfig", "BlockCfg", "MoEConfig", "SSMConfig"]


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
    # sub-layers
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # modality
    input_mode: str = "tokens"  # tokens | frames (audio stub) | vlm (patch stub)
    prefix_len: int = 0  # vlm: bidirectional patch prefix
    activation: str = "gelu"
    # numerics: params in param_dtype, and activations follow them
    param_dtype: str = "bfloat16"
    # training: rematerialisation per layer unit and the optimizer
    remat: str = "full"  # none | full ('dots' is not ported)
    optimizer: str = "adamw"  # adamw | adafactor (the MoE giants)
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
