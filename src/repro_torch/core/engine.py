"""The dispatch engine: every GEMM and attention block of the model lands
here, forward only.

``dispatch(op, a, b)`` computes one dense-layer GEMM -- ``"NT"``
(``a @ b^T``), ``"NN"`` (``a @ b``) or ``"TN"`` (``a^T @ b``) -- through
whichever (candidate, tile config) the scoped policy picks for the
``OpKey``.  ``dispatch_batched(op, a, b)`` does the same for the batched
attention contractions ``"BNT"`` and ``"BNN"``.  ``dispatch_attention``
answers the whole ``softmax(mask(Q K^T)) V`` subgraph with one plan: the
fused kernel (``FUSED_ATTN``) or the unfused plan, whose BNT and BNN
sub-GEMMs dispatch under their own keys.

PyTorch runs eagerly, so the policy selects on every call (the JAX
engine selects once per key at trace time); ``dispatch_report`` counts
calls.  A failing candidate raises: the JAX engine's fault-fallback
chain is not in this slice (ROADMAP queue A, item 4, with ``faults.py``),
so a kernel fault on the card can never hide behind a fallback.
Gradients are not in this slice either (ROADMAP queue A, item 1).
"""

from __future__ import annotations

import warnings
from typing import Optional

import torch

from repro_torch.kernels.attention_fused import NEG_INF, MaskParams
from repro_torch.kernels.ref import attention_visibility

from .candidates import DEFAULT_BY_OP, current_platform, get_candidate
from .opkey import BATCHED_OPS, OPS, OpKey, check_op
from .policy import (
    Decision,
    FixedPolicy,
    SelectionPolicy,
    current_policy,
    use_policy,
)

__all__ = [
    "dispatch",
    "dispatch_attention",
    "dispatch_batched",
    "dispatch_report",
    "run_decision",
    "policy_select",
    "policy_from_spec",
    "add_policy_argument",
    "use_policy",
    "current_policy",
    "POLICY_SPEC_HELP",
]

POLICY_SPEC_HELP = (
    "dispatch policy: model[:artifact.json] | fixed:<NAME>[@BMxBNxBK] | "
    "fixed:nt=<NAME>[@cfg],nn=...,tn=...,bnt=...,bnn=...,"
    "attn=<fused|unfused>[@BQxBK] | analytic | "
    "cascade:<A,B,...> | autotune[:cache.json]"
)

# ``fixed:attn=...`` accepts the plan-member aliases alongside literal
# candidate names; the fused arm's tile configs are (bq, bk) pairs.
_ATTN_ALIASES = {"fused": "FUSED_ATTN", "unfused": "UNFUSED_ATTN"}

# Spec kinds of the JAX package that need the selector stack.
_NOT_PORTED_KINDS = ("model", "analytic", "cascade", "autotune")

_WARNED: set = set()


def _warn_once(tag: str, msg: str) -> None:
    if tag not in _WARNED:
        _WARNED.add(tag)
        warnings.warn(msg, UserWarning, stacklevel=3)


def _spec_error(msg: str) -> ValueError:
    return ValueError(f"{msg} ({POLICY_SPEC_HELP})")


def policy_select(policy: SelectionPolicy, key: OpKey) -> Decision:
    """Run ``policy.select`` on an ``OpKey`` and validate the decision.  A
    decision naming a candidate that does not implement ``key.op`` runs
    the op's reference instead (warned once: that is a policy bug)."""
    decision = policy.select(key)
    if isinstance(decision, str):
        raise TypeError(
            f"policy {policy!r} returned the bare candidate name "
            f"{decision!r}; policies must return a Decision(name, config)"
        )
    if key.op not in get_candidate(decision.name).ops:
        _warn_once(
            "op-mismatched-decision",
            f"policy {policy!r} returned candidate {decision.name!r} for an "
            "op it does not implement; dispatching the op's reference instead",
        )
        decision = Decision(DEFAULT_BY_OP[key.op], None)
    return decision


def run_decision(key: OpKey, decision: Decision, *operands):
    """Execute a policy decision.  An exception from the candidate
    propagates (no fallback chain in this slice)."""
    cand = get_candidate(decision.name)
    platform = current_platform(operands[0])
    if not cand.supports(platform=platform):
        raise RuntimeError(
            f"candidate {decision.name!r} does not run on {platform!r} "
            f"(runs on {cand.platforms})"
        )
    return cand.run(*operands, config=decision.config)


def _run(op: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Select and execute one 2-D GEMM."""
    if op == "NT":  # a:(m,k) b:(n,k)
        m, k = a.shape
        n = b.shape[0]
    elif op == "NN":  # a:(m,k) b:(k,n)
        m, k = a.shape
        n = b.shape[1]
    else:  # TN: a:(k,m) b:(k,n)
        k, m = a.shape
        n = b.shape[1]
    key = OpKey(op, int(m), int(n), int(k), a.element_size())
    return run_decision(key, policy_select(current_policy(), key), a, b)


def _run3(op: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Select and execute one batched GEMM on (g, ., .) operands."""
    g, m, k = a.shape
    n = b.shape[1] if op == "BNT" else b.shape[2]
    key = OpKey(op, int(m), int(n), int(k), a.element_size(), int(g))
    return run_decision(key, policy_select(current_policy(), key), a, b)


# ---------------------------------------------------------------------------
# The attention plan: one ATTN decision spanning the BNT+BNN pair.
# ---------------------------------------------------------------------------

# Finite masked-logit fill: exp underflows to an exact 0.0, never nan.
_MASK_NEG = NEG_INF

# The (g, m, n) visibility of MaskParams + lengths -- the same function
# the fused kernel's plain version masks with, so both plan arms agree on
# which logits are masked.
_attn_visibility = attention_visibility


def _attn_logits(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Raw f32 logits through the dispatched batched GEMM (a BNT key at
    dsize 4, the model layer's upcast convention)."""
    return _run3("BNT", q.float(), k.float()).float()


def _attn_probs(mask: MaskParams, s_raw: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """f32 probabilities from raw logits: softcap, then the static and
    validity mask at a finite ``_MASK_NEG``, then softmax.  Masked entries
    weigh exactly 0, so a row that sees no key comes out 0, as it does
    from the fused kernel."""
    m, n = s_raw.shape[-2:]
    s = s_raw
    if mask.softcap:
        s = mask.softcap * torch.tanh(s / mask.softcap)
    vis = _attn_visibility(mask, lengths, m, n)
    s = torch.where(vis, s, torch.full_like(s, _MASK_NEG))
    return torch.where(vis, torch.softmax(s, dim=-1), torch.zeros_like(s))


def _zero_invalid_kv(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Zero key/value rows beyond each slice's valid length, as the fused
    kernel does, so junk there (inf, NaN) never meets a 0 probability."""
    n = x.shape[1]
    valid = torch.arange(n, device=x.device)[None, :, None] < lengths.reshape(-1, 1, 1)
    return torch.where(valid, x, torch.zeros_like(x))


def _unfused_attn_plan(mask, q, k, v, lengths):
    """The unfused plan arm: dispatched BNT logits -> softcap/mask/f32
    softmax -> dispatched BNN mix."""
    probs = _attn_probs(mask, _attn_logits(q, k), lengths)
    vz = _zero_invalid_kv(v, lengths)
    out = _run3("BNN", probs.to(v.dtype), vz)
    return out.to(q.dtype)


def _run_attn(mask: MaskParams, q, k, v, lengths):
    """Select and execute the attention plan: ``FUSED_ATTN`` runs the
    fused kernel with the mask inside; every other arm (``UNFUSED_ATTN``
    included) runs the unfused sub-dispatch plan."""
    g, m, dh = q.shape
    n = k.shape[1]
    key = OpKey("ATTN", int(m), int(n), int(dh), q.element_size(), int(g))
    decision = policy_select(current_policy(), key)
    if decision.name == "FUSED_ATTN":
        from repro_torch.kernels.attention_fused import attention_fused

        block = tuple(decision.config) if decision.config is not None else None
        return attention_fused(q, k, v, lengths, mask=mask, block=block)
    return _unfused_attn_plan(mask, q, k, v, lengths)


def dispatch_attention(
    q,
    k,
    v,
    *,
    lengths=None,
    causal: bool = False,
    window: int = 0,
    q_start: int = 0,
    k_start: int = 0,
    prefix_len: int = 0,
    q_seg: int = 0,
    softcap: float = 0.0,
    policy: Optional[SelectionPolicy] = None,
):
    """Compute ``softmax(mask(Q K^T)) V`` through one policy-selected plan.

      dispatch_attention(q, k, v)   q:(..., m, dh) k/v:(..., n, dh) -> (..., m, dh)

    The leading axes of all three operands must match and collapse to one
    batch extent ``g``; the policy sees ``OpKey("ATTN", m, n, dh, dsize,
    g)``.  ``causal``, ``window``, ``prefix_len``, ``q_start``/``k_start``,
    ``q_seg`` (row ``r`` sits at ``q_start + r % q_seg``), per-slice
    ``lengths`` and ``softcap`` are plan parameters.  Queries come
    pre-scaled by ``d_head**-0.5``."""
    if policy is not None:
        with use_policy(policy):
            return dispatch_attention(
                q, k, v, lengths=lengths, causal=causal, window=window,
                q_start=q_start, k_start=k_start, prefix_len=prefix_len,
                q_seg=q_seg, softcap=softcap,
            )
    if q.ndim < 3 or k.ndim != q.ndim or v.ndim != q.ndim:
        raise ValueError(
            "dispatch_attention needs >= 3-D operands with matching "
            f"leading batch axes; got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    lead = q.shape[:-2]
    if k.shape[:-2] != lead or v.shape[:-2] != lead:
        raise ValueError(
            "dispatch_attention leading batch axes differ: "
            f"{tuple(q.shape)} vs {tuple(k.shape)} vs {tuple(v.shape)} -- "
            "broadcast K/V across the GQA group before dispatching"
        )
    if k.shape != v.shape or q.shape[-1] != k.shape[-1]:
        raise ValueError(
            "dispatch_attention operand extents mismatch: "
            f"{tuple(q.shape)} vs {tuple(k.shape)} vs {tuple(v.shape)}"
        )
    q3 = q.reshape((-1,) + q.shape[-2:]).contiguous()
    k3 = k.reshape((-1,) + k.shape[-2:]).contiguous()
    v3 = v.reshape((-1,) + v.shape[-2:]).contiguous()
    g, n = q3.shape[0], k3.shape[1]
    if lengths is None:
        lengths3 = torch.full((g,), n, dtype=torch.int32, device=q.device)
    else:
        lengths3 = torch.as_tensor(lengths, device=q.device).reshape(g).to(torch.int32)
    mask = MaskParams(
        causal=bool(causal),
        window=int(window or 0),
        q_start=int(q_start),
        k_start=int(k_start),
        prefix_len=int(prefix_len or 0),
        q_seg=int(q_seg or 0),
        softcap=float(softcap or 0.0),
    )
    out = _run_attn(mask, q3, k3, v3, lengths3)
    return out.reshape(lead + out.shape[-2:])


def dispatch(op: str, a, b, policy: Optional[SelectionPolicy] = None):
    """Compute one dense-layer GEMM through the policy-selected
    (candidate, tile config).

      dispatch("NT", a, b)   a:(..., m, k) @ b:(n, k)^T -> (..., m, n)
      dispatch("NN", a, b)   a:(..., m, k) @ b:(k, n)   -> (..., m, n)
      dispatch("TN", a, b)   a:(k, m)^T    @ b:(k, n)   -> (m, n)

    For NT, ``b`` is a weight in the (out, in) convention, so a dense
    layer's forward pass is the paper's NT operation.  Leading dims of
    ``a`` flatten for NT/NN.  An explicit ``policy=`` scopes this call."""
    check_op(op)
    if op == "ATTN":
        raise ValueError(
            "op 'ATTN' is the attention plan; call dispatch_attention(q, k, v, ...)"
        )
    if op in BATCHED_OPS:
        raise ValueError(f"op {op!r} is batched; call dispatch_batched({op!r}, a, b)")
    if policy is not None:
        with use_policy(policy):
            return dispatch(op, a, b)
    if op == "TN":
        return _run("TN", a.contiguous(), b.contiguous())
    lead = a.shape[:-1]
    out = _run(op, a.reshape(-1, a.shape[-1]).contiguous(), b.contiguous())
    n = b.shape[0] if op == "NT" else b.shape[1]
    return out.reshape(lead + (n,))


def dispatch_batched(op: str, a, b, policy: Optional[SelectionPolicy] = None):
    """Compute one batched GEMM (the attention contractions) through the
    policy-selected candidate.

      dispatch_batched("BNT", a, b)  a:(..., m, k) @ b:(..., n, k)^T -> (..., m, n)
      dispatch_batched("BNN", a, b)  a:(..., m, k) @ b:(..., k, n)   -> (..., m, n)
    """
    check_op(op)
    if op == "ATTN":
        raise ValueError(
            "op 'ATTN' is the attention plan; call dispatch_attention(q, k, v, ...)"
        )
    if op not in BATCHED_OPS:
        raise ValueError(f"op {op!r} is not batched; call dispatch({op!r}, a, b)")
    if policy is not None:
        with use_policy(policy):
            return dispatch_batched(op, a, b)
    if a.ndim < 3 or b.ndim != a.ndim:
        raise ValueError(
            f"dispatch_batched({op!r}) needs >= 3-D operands with matching "
            f"leading batch axes; got {tuple(a.shape)} and {tuple(b.shape)}"
        )
    lead = a.shape[:-2]
    if b.shape[:-2] != lead:
        raise ValueError(
            f"dispatch_batched({op!r}) leading batch axes differ: "
            f"{tuple(a.shape)} vs {tuple(b.shape)} -- broadcast the operands first"
        )
    a3 = a.reshape((-1,) + a.shape[-2:]).contiguous()
    b3 = b.reshape((-1,) + b.shape[-2:]).contiguous()
    out = _run3(op, a3, b3)
    return out.reshape(lead + out.shape[-2:])


def dispatch_report(policy: Optional[SelectionPolicy] = None) -> str:
    """Render per-(op, candidate, tile-config) call counts of ``policy``
    (default: the scoped policy), grouped by op kind and keyed
    ``NAME@BMxBNxBK`` for decisions with an explicit tile."""
    pol = policy if policy is not None else current_policy()
    stats = pol.stats
    lines = [f"dispatch report — {pol!r}"]
    if not stats.calls:
        lines.append("  (no dispatches recorded)")
        return "\n".join(lines)
    rows = [
        (op, label, count)
        for op, labels in stats.by_op.items()
        for label, count in labels.items()
    ]
    width = max(len("candidate[@tile]"), max(len(label) for _, label, _ in rows))
    lines.append(f"  {'op':<4s} {'candidate[@tile]':<{width}s} {'calls':>8s} {'share':>7s}")
    op_order = {op: i for i, op in enumerate(OPS)}
    rows.sort(key=lambda r: (op_order.get(r[0], 99), -r[2], r[1]))
    for op, label, count in rows:
        lines.append(
            f"  {op:<4s} {label:<{width}s} {count:8d} {100.0 * count / stats.calls:6.1f}%"
        )
    lines.append(f"  {'':<4s} {'total':<{width}s} {stats.calls:8d}")
    return "\n".join(lines)


def _parse_fixed_arg(arg: str) -> FixedPolicy:
    """``fixed:`` spec bodies -- a single candidate or an op-qualified
    table (``nt=XLA_NT,nn=PALLAS_NN@128x128x128,attn=fused@128x256``).
    ``attn=`` accepts the aliases ``fused``/``unfused``; every config
    parses at its candidate's arity (``BQxBK`` for the fused kernel)."""
    from repro_torch.kernels.common import parse_config_key

    def parse_entry(val: str, op: Optional[str] = None):
        name, _, cfg = val.partition("@")
        name = name.strip()
        if op == "ATTN":
            name = _ATTN_ALIASES.get(name.lower(), name)
        config = None
        if cfg.strip():
            try:
                arity = get_candidate(name).config_arity
            except KeyError:
                arity = 3
            try:
                config = parse_config_key(cfg.strip(), arity=arity)
            except ValueError as e:
                raise _spec_error(str(e))
        return name, config

    if "=" not in arg:
        name, config = parse_entry(arg)
        return FixedPolicy(name, config=config)
    by_op = {}
    for part in arg.split(","):
        part = part.strip()
        if not part:
            continue
        op_s, eq, val = part.partition("=")
        op = op_s.strip().upper()
        if not eq or op not in OPS or not val.strip():
            raise _spec_error(
                f"malformed op-qualified fixed entry {part!r}; expected "
                "nt=<NAME>[@BMxBNxBK] with op in nt/nn/tn/bnt/bnn/attn"
            )
        by_op[op] = parse_entry(val, op=op)
    if not by_op:
        raise _spec_error("fixed policy needs at least one op entry")
    return FixedPolicy(by_op=by_op)


def policy_from_spec(spec: str, distributed: bool = False) -> SelectionPolicy:
    """Build a policy from a CLI spec string.

      fixed:XLA_TNN                      FixedPolicy (other ops run each
                                         op's reference)
      fixed:PALLAS_NT@64x64x32           FixedPolicy with a forced tile
      fixed:nt=PALLAS_TNN,attn=fused     op-qualified FixedPolicy
      fixed:attn=fused@16x32             attention plan entry; fused tiles
                                         are (bq, bk)

    ``model``, ``analytic``, ``cascade`` and ``autotune`` parse but raise
    ``NotImplementedError``: they need the selector stack (ROADMAP queue
    A).  ``distributed`` is accepted for the JAX signature; this slice
    runs on one device."""
    kind, _, arg = spec.strip().partition(":")
    kind, arg = kind.strip(), arg.strip()
    if not kind:
        raise _spec_error("empty policy spec")
    if kind == "fixed":
        if not arg:
            raise _spec_error("fixed policy needs a candidate: fixed:<NAME>")
        return _parse_fixed_arg(arg)
    if kind in _NOT_PORTED_KINDS:
        raise NotImplementedError(
            f"policy kind {kind!r} is not ported yet: it needs the selector "
            "stack (ROADMAP.md queue A, 'The selector stack'); use fixed:..."
        )
    raise _spec_error(f"unknown policy spec {spec!r}")


def add_policy_argument(parser) -> None:
    """Attach the shared ``--policy`` option to an argparse parser (the
    JAX package's default string, ``model``, which this slice rejects)."""
    parser.add_argument("--policy", default="model", help=POLICY_SPEC_HELP)
