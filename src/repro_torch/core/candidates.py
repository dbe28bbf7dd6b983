"""Registry of candidate implementations of the dispatched ops.

Candidates are added with a registration decorator, as in the JAX
package:

    @register_candidate("MY_NT", sim_algo="NT_DIRECT", ops=("NT",),
                        platforms=("gpu",))
    def my_nt(a, b):
        ...

``sim_algo`` names the analytic-cost-model arm that describes the
candidate (``core/simulate.py``), ``extra_memory`` marks the ones that
materialise a transpose (the paper's OOM guard) and ``distributed_safe``
the ones the JAX package may run inside a partitioned program; the values
are the JAX registry's.

Built-in candidates, by op kind (layouts in ``core/opkey.py``):

  NT    XLA_NT      cuBLAS through torch.matmul -- the "cuBLAS NT" arm
        XLA_TNN     materialised B^T (torch), then torch.matmul
        PALLAS_NT   the direct NT CUDA kernel (csrc/matmul_nt.cu)
        PALLAS_TNN  the transpose kernel + the NN kernel (the paper's TNN)
        PALLAS_TNN_FUSED  one kernel reading B in its stored layout
                    (csrc/matmul_tnn_fused.cu)
  NN    XLA_NN      torch.matmul
        PALLAS_NN   the NN CUDA kernel (csrc/matmul_nn.cu)
  TN    XLA_TN      torch.matmul on A^T, no materialised transpose
        PALLAS_TN   the transpose kernel + the NN kernel
  BNT   XLA_BNT     torch.bmm with B^T
        PALLAS_BNT  the batched NT CUDA kernel (csrc/matmul_batched.cu)
  BNN   XLA_BNN     torch.bmm
        PALLAS_BNN  the batched NN CUDA kernel
  ATTN  UNFUSED_ATTN  batched logits, f32 softmax, batched mix (torch)
        FUSED_ATTN    the fused attention CUDA kernel

The ``XLA_*`` names and ``UNFUSED_ATTN`` keep the JAX package's names for
its non-kernel references; here they are plain PyTorch calls, which is
cuBLAS on the card.  The ``PALLAS_*`` names and ``FUSED_ATTN`` are the
ported kernels: each launches its CUDA kernel for a CUDA operand, runs
its plain version for a CPU operand, and raises on anything else.

Every candidate here runs on both platforms (``ALL_PLATFORMS``), so the
selectors' per-key memos need no platform in their key.

Tile space: each tunable candidate names the kernel whose tile configs
its ``block=`` reaches (``kernel``; the two-kernel TNN/TN schedules pass
it to their NN kernel).  ``config=None`` runs the plan of that wrapper's
cost model, the first of its route's plans (``nt_plans``, ``nn_plans``,
``tnn_fused_plans``, ``batched_plans``, ``attention_plans``); a config
names another plan of the same route (``kernels/tiling.py``) and any
other raises.
``Candidate.config_space`` is the autotune sweep list at one (op, g, m,
n, k, dsize): the route's other plans, ranked by the roofline; measurement
times it beside ``"default"``, and the learned and autotune policies
attach the tuned config.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch

from . import faults
from .opkey import BATCHED_OPS, OPS, check_op

__all__ = [
    "Candidate",
    "CANDIDATES",
    "register_candidate",
    "unregister_candidate",
    "get_candidate",
    "current_platform",
    "candidate_fits_memory",
    "candidate_allowed",
    "fallback_chain",
    "PAPER_PAIR",
    "DEFAULT_BY_OP",
    "BINARY_PAIRS_BY_OP",
]

ALL_PLATFORMS: Tuple[str, ...] = ("cpu", "gpu")


@dataclass(frozen=True)
class Candidate:
    name: str
    fn: Callable[..., torch.Tensor]
    sim_algo: str  # which analytic-cost-model arm describes it
    distributed_safe: bool = False  # usable directly in a partitioned program
    extra_memory: bool = False  # needs room for a materialised transpose
    platforms: Tuple[str, ...] = ALL_PLATFORMS  # devices it may run on
    tunable: bool = False  # fn accepts a block=... tile config keyword
    ops: Tuple[str, ...] = ("NT",)  # op kinds the fn implements (opkey.OPS)
    arity: int = 2  # operand count (2 for the GEMMs, 3 for attention q/k/v)
    config_arity: int = 3  # tile-tuple length ((bm,bn,bk) GEMM, (bq,bk) attn)
    kernel: Optional[str] = None  # the kernel a tile config reaches (tunable only)

    def supports(self, platform: Optional[str] = None, op: Optional[str] = None,
                 config=None, shape: Optional[Tuple[int, ...]] = None,
                 aligned: bool = True) -> bool:
        """Platform and op bounds, and -- config-aware -- whether this
        candidate can run ``config`` at all (None, its own plan, always
        can): a tunable candidate, a well-formed tuple, and with ``shape``
        = (g, m, n, k, dsize) a plan of the route that shape takes for
        16-byte aligned operands (``aligned=False``: for operands that are
        not)."""
        if op is not None and op not in self.ops:
            return False
        if platform is not None and platform not in self.platforms:
            return False
        if config is None:
            return True
        if not self.tunable:
            return False
        from repro_torch.kernels import tiling

        try:
            tiling.validate_config(config, arity=self.config_arity)
        except ValueError:
            return False
        if shape is None or self.kernel is None:
            return True
        g, m, n, k, dsize = shape
        return tiling.config_feasible(self.kernel, config, m, n, k, dsize, g, aligned)

    def config_space(self, m: int, n: int, k: int, dsize: int = 4, max_configs: int = 4,
                     hardware=None, g: int = 1) -> Tuple[Tuple[int, ...], ...]:
        """The autotune sweep list of this candidate at one shape (empty
        for non-tunable candidates): its kernel route's plans other than
        the default one, ranked by the roofline of ``hardware`` (the
        measuring device's) and cut to ``max_configs``.  Attention
        candidates read (m, n, k) as (queries, keys, head dim)."""
        if not self.tunable or self.kernel is None:
            return ()
        from repro_torch.kernels import tiling

        if self.config_arity == 2:
            return tiling.attn_config_space(m, n, k, dsize, max_configs=max_configs,
                                            hardware=hardware, g=g)
        return tiling.shortlist_tile_configs(self.kernel, m, n, k, dsize, g=g,
                                             max_configs=max_configs, hardware=hardware)

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
    sim_algo: str,
    distributed_safe: bool = False,
    extra_memory: bool = False,
    platforms: Tuple[str, ...] = ALL_PLATFORMS,
    tunable: bool = False,
    ops: Tuple[str, ...] = ("NT",),
    arity: int = 2,
    config_arity: int = 3,
    kernel: Optional[str] = None,
):
    """Decorator registering ``fn(*operands) -> out`` as a dispatch
    candidate for the op kinds in ``ops``.  ``tunable=True`` declares a
    ``block=`` tile-config keyword reaching ``kernel``'s plans.  A
    duplicate name raises: candidates are identified by name in specs and
    reports."""

    def deco(fn: Callable[..., torch.Tensor]):
        if name in _REGISTRY:
            raise ValueError(
                f"candidate {name!r} is already registered; "
                "unregister_candidate() it first if replacement is intended"
            )
        _REGISTRY[name] = Candidate(
            name=name,
            fn=fn,
            sim_algo=sim_algo,
            distributed_safe=distributed_safe,
            extra_memory=extra_memory,
            platforms=tuple(platforms),
            tunable=tunable,
            ops=tuple(check_op(o) for o in ops),
            arity=int(arity),
            config_arity=int(config_arity),
            kernel=kernel,
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


# Shared admissibility guards -- the paper's OOM estimate and the
# distributed/platform filters, used by MTNNSelector, the policies and
# measurement alike, so their decisions cannot drift apart.


def candidate_fits_memory(
    cand: Candidate, m: int, n: int, k: int, dsize: int, mem_gib: float,
    budget_frac: float = 0.9, op: str = "NT", g: int = 1,
) -> bool:
    """The paper's OOM guard, op- and batch-aware: extra-memory candidates
    must fit A, B, C *and* their materialised transpose inside the memory
    budget -- B^T (n*k elements) for the forward NT/TNN schedules, A^T
    (m*k elements) for the TN weight-gradient schedule -- with every term
    multiplied by the batch extent ``g``.  (No tile config enters: a
    plan's workspace is not the transpose this guard is about.)"""
    if not cand.extra_memory:
        return True
    budget = mem_gib * (1024**3) * budget_frac
    transposed = m * k if op == "TN" else n * k
    resident = g * (m * k + n * k + m * n + transposed) * dsize
    return resident <= budget


def candidate_allowed(
    cand: Candidate, distributed: bool, op: Optional[str] = None,
    platform: Optional[str] = None, config=None,
) -> bool:
    """Distributed-safety + platform (+ op) filter, plus the process-wide
    quarantine ledger: an arm that failed at dispatch (``core/faults.py``)
    stops being admissible everywhere -- every policy's selection and the
    autotune measurement sweep route through here.  ``platform`` is the
    operands' (``current_platform``); None checks no platform, which every
    port candidate passes anyway.  ``config`` asks about one tile of the
    candidate: barred if that tile or the candidate's own plan is
    quarantined."""
    if distributed and not cand.distributed_safe:
        return False
    if op is not None and faults.is_quarantined(cand.name, op, config):
        return False
    return cand.supports(platform=platform, op=op)


def fallback_chain(op: str, name: Optional[str] = None) -> Tuple[str, ...]:
    """The ordered candidate names dispatch tries when ``name`` fails on
    ``op``: the selected candidate itself, then its binary-pair partner
    (the paper's other arm), ending at the op's library reference
    (``DEFAULT_BY_OP``: cuBLAS through torch, or the unfused attention
    plan).  Every member implements ``op``; the engine attempts the last
    one even when it is quarantined -- there is nothing beneath it."""
    check_op(op)
    default = DEFAULT_BY_OP[op]
    chain: list = []
    if name is not None and name != default:
        cand = _REGISTRY.get(name)
        if cand is not None and op in cand.ops:
            chain.append(name)
        pair = BINARY_PAIRS_BY_OP.get(op, ())
        if name in pair:
            partner = pair[1] if pair[0] == name else pair[0]
            pc = _REGISTRY.get(partner)
            if (partner != default and partner not in chain
                    and pc is not None and op in pc.ops):
                chain.append(partner)
    chain.append(default)
    return tuple(chain)


# -- library arms: plain torch calls (cuBLAS on the card) ---------------------


@register_candidate("XLA_NT", sim_algo="NT_DIRECT", distributed_safe=True)
def xla_nt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Direct NT: contract the trailing dim of both operands."""
    return torch.matmul(a, b.transpose(-1, -2))


@register_candidate("XLA_TNN", sim_algo="TNN", distributed_safe=True, extra_memory=True)
def xla_tnn(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """TNN: materialise B^T, then an NN product."""
    return torch.matmul(a, b.transpose(-1, -2).contiguous())


@register_candidate("XLA_NN", sim_algo="NN_DIRECT", distributed_safe=True, ops=("NN",))
def xla_nn(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a, b)


@register_candidate("XLA_TN", sim_algo="TN_DIRECT", distributed_safe=True, ops=("TN",))
def xla_tn(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A:(k,m)^T @ B:(k,n) with no materialised A^T."""
    return torch.matmul(a.t(), b)


@register_candidate("XLA_BNT", sim_algo="BNT_DIRECT", distributed_safe=True, ops=("BNT",))
def xla_bnt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched NT: per slice A_i @ B_i^T -- the Q @ K^T reference."""
    return torch.bmm(a, b.transpose(1, 2))


@register_candidate("XLA_BNN", sim_algo="BNN_DIRECT", distributed_safe=True, ops=("BNN",))
def xla_bnn(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched NN: per slice A_i @ B_i -- the probs @ V reference."""
    return torch.bmm(a, b)


@register_candidate("UNFUSED_ATTN", sim_algo="ATTN_UNFUSED", distributed_safe=True,
                    ops=("ATTN",), arity=3)
def unfused_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Unfused reference: batched NT logits in f32, f32 softmax, batched
    NN mix, with no dispatch re-entry.  q:(g,m,dh), k/v:(g,n,dh)."""
    s = torch.bmm(q.float(), k.float().transpose(1, 2))
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.bmm(p.float(), v.float()).to(q.dtype)


# -- kernel arms: the ported CUDA kernels (plain versions on the CPU) ---------


@register_candidate("PALLAS_NT", sim_algo="NT_DIRECT", tunable=True,
                    kernel="matmul_nt")
def _pallas_nt(a, b, block=None):
    from repro_torch.kernels import ops

    return ops.matmul_nt(a, b, block=block)


@register_candidate("PALLAS_TNN", sim_algo="TNN", extra_memory=True, tunable=True,
                    kernel="matmul_nn")
def _pallas_tnn(a, b, block=None):
    from repro_torch.kernels import ops

    return ops.matmul_tnn(a, b, block=block)


@register_candidate("PALLAS_TNN_FUSED", sim_algo="TNN_FUSED", tunable=True,
                    kernel="matmul_tnn_fused")
def _pallas_tnn_fused(a, b, block=None):
    from repro_torch.kernels import ops

    return ops.matmul_tnn_fused(a, b, block=block)


@register_candidate("PALLAS_NN", sim_algo="NN_DIRECT", tunable=True, ops=("NN",),
                    kernel="matmul_nn")
def _pallas_nn(a, b, block=None):
    from repro_torch.kernels import ops

    return ops.matmul_nn(a, b, block=block)


@register_candidate("PALLAS_TN", sim_algo="TN_VIA_NN", extra_memory=True, tunable=True,
                    ops=("TN",), kernel="matmul_nn")
def _pallas_tn(a, b, block=None):
    from repro_torch.kernels import ops

    return ops.matmul_tn(a, b, block=block)


@register_candidate("PALLAS_BNT", sim_algo="BNT_DIRECT", tunable=True, ops=("BNT",),
                    kernel="matmul_bnt")
def _pallas_bnt(a, b, block=None):
    from repro_torch.kernels import ops

    return ops.matmul_bnt(a, b, block=block)


@register_candidate("PALLAS_BNN", sim_algo="BNN_DIRECT", tunable=True, ops=("BNN",),
                    kernel="matmul_bnn")
def _pallas_bnn(a, b, block=None):
    from repro_torch.kernels import ops

    return ops.matmul_bnn(a, b, block=block)


@register_candidate(
    "FUSED_ATTN", sim_algo="ATTN_FUSED", tunable=True, ops=("ATTN",), arity=3,
    config_arity=2, kernel="attention_fused",
)
def _fused_attn(q, k, v, block=None):
    from repro_torch.kernels.attention_fused import attention_fused

    return attention_fused(q, k, v, block=block)


# the paper's binary setting (the forward op)
PAPER_PAIR: Tuple[str, str] = ("XLA_NT", "XLA_TNN")

# Per-op binary pairs (direct arm, alternative arm): the paper's NT-vs-TNN
# dichotomy carried over to the backward GEMMs and the attention
# contractions.
BINARY_PAIRS_BY_OP: Dict[str, Tuple[str, str]] = {
    "NT": PAPER_PAIR,
    "NN": ("XLA_NN", "PALLAS_NN"),
    "TN": ("XLA_TN", "PALLAS_TN"),
    "BNT": ("XLA_BNT", "PALLAS_BNT"),
    "BNN": ("XLA_BNN", "PALLAS_BNN"),
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
