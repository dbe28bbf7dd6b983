"""The op-space selection key: *(op kind x batch x shape x dtype width)*.

The paper's 28% end-to-end speedup comes from routing the *training*
GEMMs — the forward NT plus the backward data/weight gradients — through
learned selection.  Those three matmuls of a dense layer are distinct
*operations*, not just distinct shapes:

  NT   C = A @ B^T    A:(m, k)  B:(n, k)   forward of a (out, in) dense
  NN   C = A @ B      A:(m, k)  B:(k, n)   data gradient  dX = dY @ W
  TN   C = A^T @ B    A:(k, m)  B:(k, n)   weight gradient dW = dY^T @ X

The attention contractions widen the space to *batched* GEMMs — cuDNN's
canonical attention primitive (batched-strided GEMM) — with one extra
extent ``g``, the collapsed product of the leading batch/head axes:

  BNT  C_i = A_i @ B_i^T  A:(g, m, k)  B:(g, n, k)   Q @ K^T logits
  BNN  C_i = A_i @ B_i    A:(g, m, k)  B:(g, k, n)   probs @ V

``OpKey`` names one dispatch decision point: which op, at which batch
extent ``g`` (1 for the unbatched ops), at which logical (m, n, k) —
m/n are the per-slice output extents, k the contraction — and at which
element size.  Every ``SelectionPolicy.select`` takes an ``OpKey`` and the
whole persistence stack (measurement caches, selector artifacts, dispatch
reports) is keyed by it, so the selection space is genuinely
*(op x batch x shape x tile config)* — the same generalization AutoTVM
made from per-kernel to per-operator learned cost models.

The legacy positional ``select(m, n, k, dsize)`` form was removed after
its one-release deprecation cycle: ``coerce_key`` now accepts only an
``OpKey`` and raises a clean ``TypeError`` otherwise.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

__all__ = [
    "OPS",
    "BATCHED_OPS",
    "GROUPED_OPS",
    "OpKey",
    "check_op",
    "coerce_key",
    "shape_key",
    "parse_shape_key",
]

# The op kinds of the dense layer's training GEMMs plus the batched
# attention contractions.  Closed under differentiation:
# d(NT) -> {NN, TN}, d(NN) -> {NT, TN}, d(TN) -> {NT, NN}, and — with an
# explicit transpose of one operand — d(BNT) -> {BNN}, d(BNN) -> {BNT,
# BNN}; this is what lets the dispatch engine's custom_vjp re-enter
# itself for both the 2-D and the batched entry points.
#
# ATTN is the first *subgraph* op: the whole ``softmax(Q K^T) V`` chain
# as one decision point (the ROADMAP's stepping stone from per-op
# Decisions to whole-block Plans).  Its extents read per slice: m
# queries, n keys, k the head dim; ``g`` the collapsed (batch x kv-head)
# axis.  d(ATTN) -> {BNT, BNN}: the flash backward recomputes the
# softmax and re-enters dispatch through the batched GEMM ops.
OPS: Tuple[str, ...] = ("NT", "NN", "TN", "BNT", "BNN", "ATTN")

# The subset with a leading batch axis (attention contractions).
BATCHED_OPS: Tuple[str, ...] = ("BNT", "BNN")

# The ops whose OpKey carries a meaningful batch extent g: the batched
# GEMMs plus the attention subgraph op (three (g, ., .) operands).
GROUPED_OPS: Tuple[str, ...] = BATCHED_OPS + ("ATTN",)


def check_op(op: str) -> str:
    if op not in OPS:
        raise ValueError(f"unknown op kind {op!r}; expected one of {OPS}")
    return op


class OpKey(NamedTuple):
    """One dispatch decision point: op kind, per-slice output/contraction
    extents, element size, and — for the batched BNT/BNN ops — the
    collapsed batch extent ``g``.  ``m``/``n`` are the *output* dims and
    ``k`` the contraction regardless of op, so (m, n, k) reads the same
    way for every op (the storage layouts differ, see module docstring).
    ``g`` is 1 for the unbatched NT/NN/TN ops."""

    op: str
    m: int
    n: int
    k: int
    dsize: int = 4
    g: int = 1

    def mnk(self) -> Tuple[int, int, int]:
        return (self.m, self.n, self.k)


def coerce_key(key) -> OpKey:
    """Normalise a ``select`` argument to a validated ``OpKey``.

    Only the op-space API is accepted; the legacy positional
    ``select(m, n, k[, dsize])`` form was removed after its deprecation
    release and now raises a clean ``TypeError``.
    """
    if not isinstance(key, OpKey):
        raise TypeError(
            "select() takes an OpKey(op, m, n, k, dsize, g); the legacy "
            "positional (m, n, k[, dsize]) form was removed — build an "
            "OpKey('NT', m, n, k, dsize) instead"
        )
    op = check_op(key.op)
    g = int(key.g)
    if g < 1:
        raise ValueError(f"OpKey batch extent g={g} must be >= 1")
    if g != 1 and op not in GROUPED_OPS:
        # an unbatched op measured/labelled under g>1 would poison the
        # cache and the selector's training rows with an extent the GEMM
        # never ran at
        raise ValueError(
            f"OpKey op {op!r} is unbatched; batch extent g={g} is only "
            f"meaningful for {GROUPED_OPS}"
        )
    return OpKey(op, int(key.m), int(key.n), int(key.k), int(key.dsize), g)


def shape_key(mnk: Sequence[int]) -> str:
    """Stable string form of an (m, n, k) shape — the per-shape tile-table
    key in v3+ selector artifacts (same ``x``-joined style as tile-config
    keys).  Batched ops key their per-slice shape: the tile space tiles
    one slice, so ``g`` does not enter."""
    m, n, k = mnk
    return f"{int(m)}x{int(n)}x{int(k)}"


def parse_shape_key(key: str) -> Tuple[int, int, int]:
    """Inverse of ``shape_key``; raises ``ValueError`` on malformed keys."""
    try:
        parts = tuple(int(p) for p in key.split("x"))
    except ValueError:
        raise ValueError(f"malformed shape key {key!r}") from None
    if len(parts) != 3 or any(p <= 0 for p in parts):
        raise ValueError(f"malformed shape key {key!r}")
    return parts
