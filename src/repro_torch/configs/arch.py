"""ArchConfig -- the declarative description every subsystem reads.

``segments`` is a tuple of ``(repeat, (BlockCfg, ...))``: the layer stack
loops over each segment, one iteration applying the unit's blocks in
order.  The fields are the JAX package's that the architectures set,
``sp_attention`` among them (sequence-parallel attention under a mesh,
``models/attention.py``); its ``unroll_segments`` has no counterpart
here (the port's layer stack is a Python loop, which the dry run's
accounting counts whole).  ``param_count`` and ``active_param_count``
are the JAX package's formulas, with the port's xBC conv, NoPE and
shared expert counted where a config sets them.

Settings the JAX package's ten architectures do not have stay off its
field list (the port-vs-JAX tests build one ``ArchConfig`` from the
other field by field): they are fields of the subclass
``PortArchConfig``, which a config that needs them (granite-4.0-h-small)
is built from, and class attributes of ``ArchConfig`` at the same
defaults, which change nothing:

  emb_mult       the token embeddings multiplied by it (muP's
                 ``embedding_multiplier``)
  residual_mult  every block's mixer and FFN outputs multiplied by it
                 before the residual add (``residual_multiplier``)
  logits_div     the logits divided by it (``logits_scaling``)
  rms_eps        the epsilon of the blocks' and the final RMSNorm and of
                 the Mamba gated norm (the QK-norms keep 1e-6)
  attn_rope      False: no rotary positions (NoPE)
  attn_scale     the query scale (None: ``d_head ** -0.5``)
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

from repro_torch.models.blocks import BlockCfg
from repro_torch.models.moe import MoEConfig
from repro_torch.models.ssm import SSMConfig

__all__ = ["ArchConfig", "PortArchConfig", "BlockCfg", "MoEConfig", "SSMConfig"]


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
    # beyond-paper: the attention block split over ``model`` along the
    # query rows where the heads do not divide it (the dry run's optimized
    # variant turns it on)
    sp_attention: bool = False
    activation: str = "gelu"
    # numerics: params in param_dtype, and activations follow them
    param_dtype: str = "bfloat16"
    # training: rematerialisation per layer unit and the optimizer
    remat: str = "full"  # none | dots | full
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

    def param_count(self) -> int:
        """Exact parameter count (the number of elements ``init_lm`` makes)."""
        d, dh = self.d_model, self.d_head
        n = self.vocab_padded * d  # embedding
        if not self.tie_embeddings:
            n += self.vocab_padded * d
        n += d  # final norm
        attn = (self.n_heads * dh + 2 * self.n_kv * dh) * d + d * self.n_heads * dh
        if self.qk_norm:
            attn += 2 * dh
        mlp = 3 * d * self.d_ff
        for count, blocks in self.segments:
            for b in blocks:
                per = d  # ln1
                if b.mixer == "attn":
                    per += attn
                elif b.mixer == "mamba":
                    s = self.ssm
                    di, N, H = s.d_inner, s.d_state, s.n_heads
                    per += 2 * di * d + 2 * N * d + H * d  # z,x,B,C,dt proj
                    conv = s.conv_width
                    per += s.d_conv * conv + conv  # conv
                    per += 3 * H  # A_log, D, dt_bias
                    per += di + d * di  # norm + out proj
                if self.post_norm:
                    per += d
                if b.ffn == "mlp":
                    per += d + mlp + (d if self.post_norm else 0)
                elif b.ffn == "moe":
                    m = self.moe
                    per += d + m.n_experts * (3 * d * m.d_ff) + m.n_experts * d
                    per += 3 * d * m.shared_d_ff
                    per += d if self.post_norm else 0
                n += count * per
        if any(b.mixer == "shared_attn" for _, bl in self.segments for b in bl):
            n += attn  # one shared set
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k of n_experts)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        total = self.param_count()
        moe_blocks = sum(
            c * sum(1 for b in bl if b.ffn == "moe") for c, bl in self.segments
        )
        all_experts = moe_blocks * m.n_experts * 3 * self.d_model * m.d_ff
        active = moe_blocks * m.top_k * 3 * self.d_model * m.d_ff
        return total - all_experts + active


@dataclass(frozen=True)
class PortArchConfig(ArchConfig):
    """An ``ArchConfig`` with the port's settings beyond the JAX package's
    (the module docstring) as fields."""

    emb_mult: float = 1.0
    residual_mult: float = 1.0
    logits_div: float = 1.0
    rms_eps: float = 1e-6
    attn_rope: bool = True
    attn_scale: Optional[float] = None


# ... which ``ArchConfig`` reads at their defaults, as class attributes
_BASE = {f.name for f in dataclasses.fields(ArchConfig)}
for _f in dataclasses.fields(PortArchConfig):
    if _f.name not in _BASE:
        setattr(ArchConfig, _f.name, _f.default)
del _BASE, _f
