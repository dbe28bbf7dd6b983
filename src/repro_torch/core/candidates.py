"""Registry of candidate implementations of the dispatched ops.

Candidates are added with a registration decorator, as in the JAX
package:

    @register_candidate("MY_NT", ops=("NT",), platforms=("gpu",))
    def my_nt(a, b):
        ...

Built-in candidates, by op kind (layouts in ``core/opkey.py``):

  NT    XLA_NT      cuBLAS through torch.matmul -- the "cuBLAS NT" arm
        XLA_TNN     materialised B^T (torch), then torch.matmul
        PALLAS_NT   the direct NT CUDA kernel (csrc/matmul.cu)
        PALLAS_TNN  the transpose kernel + the NN kernel (the paper's TNN)
  NN    XLA_NN      torch.matmul
        PALLAS_NN   the NN CUDA kernel
  TN    XLA_TN      torch.matmul on A^T, no materialised transpose
        PALLAS_TN   the transpose kernel + the NN kernel
  BNT   XLA_BNT     torch.bmm with B^T
  BNN   XLA_BNN     torch.bmm
  ATTN  UNFUSED_ATTN  batched logits, f32 softmax, batched mix (torch)
        FUSED_ATTN    the fused attention CUDA kernel

The ``XLA_*`` names and ``UNFUSED_ATTN`` keep the JAX package's names for
its non-kernel references; here they are plain PyTorch calls, which is
cuBLAS on the card.  The ``PALLAS_*`` names and ``FUSED_ATTN`` are the
ported kernels: each launches its CUDA kernel for a CUDA operand, runs
its plain version for a CPU operand, and raises on anything else.
``PALLAS_TNN_FUSED``, ``PALLAS_BNT`` and ``PALLAS_BNN`` are not
registered until their kernels are ported (ROADMAP queue B), so a spec
naming them fails with the unknown-candidate error.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch

from .opkey import BATCHED_OPS, OPS, check_op

__all__ = [
    "Candidate",
    "CANDIDATES",
    "register_candidate",
    "unregister_candidate",
    "get_candidate",
    "current_platform",
    "PAPER_PAIR",
    "DEFAULT_BY_OP",
    "BINARY_PAIRS_BY_OP",
]

ALL_PLATFORMS: Tuple[str, ...] = ("cpu", "gpu")


@dataclass(frozen=True)
class Candidate:
    name: str
    fn: Callable[..., torch.Tensor]
    platforms: Tuple[str, ...] = ALL_PLATFORMS  # devices it may run on
    tunable: bool = False  # fn accepts a block=... tile config keyword
    ops: Tuple[str, ...] = ("NT",)  # op kinds the fn implements (opkey.OPS)
    arity: int = 2  # operand count (2 for the GEMMs, 3 for attention q/k/v)
    config_arity: int = 3  # tile-tuple length ((bm,bn,bk) GEMM, (bq,bk) attn)

    def supports(self, platform: Optional[str] = None, op: Optional[str] = None) -> bool:
        """Platform and op bounds."""
        if op is not None and op not in self.ops:
            return False
        return platform is None or platform in self.platforms

    def run(self, *args, config=None) -> torch.Tensor:
        """Execute the candidate, at an explicit tile config when one is
        given (tunable candidates only)."""
        if len(args) != self.arity:
            raise TypeError(
                f"candidate {self.name!r} takes {self.arity} operands, got {len(args)}"
            )
        if config is None or not self.tunable:
            return self.fn(*args)
        return self.fn(*args, block=tuple(config))


_REGISTRY: Dict[str, Candidate] = {}
CANDIDATES = _REGISTRY


def register_candidate(
    name: str,
    *,
    platforms: Tuple[str, ...] = ALL_PLATFORMS,
    tunable: bool = False,
    ops: Tuple[str, ...] = ("NT",),
    arity: int = 2,
    config_arity: int = 3,
):
    """Decorator registering ``fn(*operands) -> out`` as a dispatch
    candidate for the op kinds in ``ops``.  ``tunable=True`` declares a
    ``block=`` tile-config keyword.  A duplicate name raises: candidates
    are identified by name in specs and reports."""

    def deco(fn: Callable[..., torch.Tensor]):
        if name in _REGISTRY:
            raise ValueError(
                f"candidate {name!r} is already registered; "
                "unregister_candidate() it first if replacement is intended"
            )
        _REGISTRY[name] = Candidate(
            name=name,
            fn=fn,
            platforms=tuple(platforms),
            tunable=tunable,
            ops=tuple(check_op(o) for o in ops),
            arity=int(arity),
            config_arity=int(config_arity),
        )
        return fn

    return deco


def unregister_candidate(name: str) -> None:
    """Remove a candidate (tests / plugin teardown)."""
    _REGISTRY.pop(name, None)


def get_candidate(name: str) -> Candidate:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown candidate {name!r}; have {sorted(_REGISTRY)}"
        ) from None


def current_platform(x: torch.Tensor) -> str:
    """The platform of an operand, read from its device: ``"gpu"`` for a
    CUDA tensor, else the device type (``"cpu"``)."""
    return "gpu" if x.device.type == "cuda" else x.device.type


# -- library arms: plain torch calls (cuBLAS on the card) ---------------------


@register_candidate("XLA_NT")
def xla_nt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Direct NT: contract the trailing dim of both operands."""
    return torch.matmul(a, b.transpose(-1, -2))


@register_candidate("XLA_TNN")
def xla_tnn(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """TNN: materialise B^T, then an NN product."""
    return torch.matmul(a, b.transpose(-1, -2).contiguous())


@register_candidate("XLA_NN", ops=("NN",))
def xla_nn(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a, b)


@register_candidate("XLA_TN", ops=("TN",))
def xla_tn(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A:(k,m)^T @ B:(k,n) with no materialised A^T."""
    return torch.matmul(a.t(), b)


@register_candidate("XLA_BNT", ops=("BNT",))
def xla_bnt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched NT: per slice A_i @ B_i^T -- the Q @ K^T reference."""
    return torch.bmm(a, b.transpose(1, 2))


@register_candidate("XLA_BNN", ops=("BNN",))
def xla_bnn(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched NN: per slice A_i @ B_i -- the probs @ V reference."""
    return torch.bmm(a, b)


@register_candidate("UNFUSED_ATTN", ops=("ATTN",), arity=3)
def unfused_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Unfused reference: batched NT logits in f32, f32 softmax, batched
    NN mix, with no dispatch re-entry.  q:(g,m,dh), k/v:(g,n,dh)."""
    s = torch.bmm(q.float(), k.float().transpose(1, 2))
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.bmm(p.float(), v.float()).to(q.dtype)


# -- kernel arms: the ported CUDA kernels (plain versions on the CPU) ---------


@register_candidate("PALLAS_NT", tunable=True)
def _pallas_nt(a, b, block=None):
    from repro_torch.kernels import ops

    return ops.matmul_nt(a, b, block=block)


@register_candidate("PALLAS_TNN", tunable=True)
def _pallas_tnn(a, b, block=None):
    from repro_torch.kernels import ops

    return ops.matmul_tnn(a, b, block=block)


@register_candidate("PALLAS_NN", tunable=True, ops=("NN",))
def _pallas_nn(a, b, block=None):
    from repro_torch.kernels import ops

    return ops.matmul_nn(a, b, block=block)


@register_candidate("PALLAS_TN", tunable=True, ops=("TN",))
def _pallas_tn(a, b, block=None):
    from repro_torch.kernels import ops

    return ops.matmul_tn(a, b, block=block)


@register_candidate(
    "FUSED_ATTN", tunable=True, ops=("ATTN",), arity=3, config_arity=2
)
def _fused_attn(q, k, v, block=None):
    from repro_torch.kernels.attention_fused import attention_fused

    return attention_fused(q, k, v, block=block)


# the paper's binary setting (the forward op)
PAPER_PAIR: Tuple[str, str] = ("XLA_NT", "XLA_TNN")

# Per-op binary pairs (direct arm, alternative arm), restricted to the
# registered names: BNT and BNN have no registered kernel arm yet.
BINARY_PAIRS_BY_OP: Dict[str, Tuple[str, str]] = {
    "NT": PAPER_PAIR,
    "NN": ("XLA_NN", "PALLAS_NN"),
    "TN": ("XLA_TN", "PALLAS_TN"),
    "ATTN": ("UNFUSED_ATTN", "FUSED_ATTN"),
}

# The always-runnable reference candidate per op -- what an op that a
# FixedPolicy does not name runs.
DEFAULT_BY_OP: Dict[str, str] = {
    "NT": "XLA_NT",
    "NN": "XLA_NN",
    "TN": "XLA_TN",
    "BNT": "XLA_BNT",
    "BNN": "XLA_BNN",
    "ATTN": "UNFUSED_ATTN",
}
assert set(DEFAULT_BY_OP) == set(OPS)
assert set(BATCHED_OPS) <= set(DEFAULT_BY_OP)
assert all(n in _REGISTRY for pair in BINARY_PAIRS_BY_OP.values() for n in pair)
