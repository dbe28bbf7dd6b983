"""The dispatch engine: every GEMM and attention block of the model lands
here, forward and backward.

``dispatch(op, a, b)`` computes one dense-layer GEMM -- ``"NT"``
(``a @ b^T``), ``"NN"`` (``a @ b``) or ``"TN"`` (``a^T @ b``) -- through
whichever (candidate, tile config) the scoped policy picks for the
``OpKey``.  ``dispatch_batched(op, a, b)`` does the same for the batched
attention contractions ``"BNT"`` and ``"BNN"``.  ``dispatch_attention``
answers the whole ``softmax(mask(Q K^T)) V`` subgraph with one plan: the
fused kernel (``FUSED_ATTN``) or the unfused plan, whose BNT and BNN
sub-GEMMs dispatch under their own keys.

All three entry points are differentiable through
``torch.autograd.Function``s that mirror the JAX package's ``custom_vjp``
rules op for op (``_GRADS`` and ``_DispatchAttn``), and every gradient
GEMM re-enters ``_run``/``_run3``, so the policy in scope when the
backward runs selects it and ``dispatch_report`` counts it:

  NT  dA = G @ B (NN),      dB = G^T @ A (TN)
  NN  dA = G @ B^T (NT),    dB = A^T @ G (TN)
  TN  dA = B @ G^T (NT),    dB = A @ G (NN)
  BNT dA = G @ B (BNN),     dB = G^T @ A (BNN of the swapped cotangent)
  BNN dA = G @ B^T (BNT),   dB = A^T @ G (BNN of the swapped operand)
  ATTN  flash backward: q, k, v and lengths are saved, never the
        probabilities; the softmax (softcap included) is recomputed and
        dV, dP, dQ, dK go through four batched dispatches in f32, after
        the recomputed logits' BNT.

Wrap the forward and ``backward()`` in one ``use_policy`` block, as the
JAX package wraps ``value_and_grad``.  The autograd engine runs the
backward of CUDA tensors on a thread of its own, which re-enters the
forward's block while it is open (``policy.resume_scope``); a backward
after its block closed, with no other in scope, raises.  First-order
gradients only, as ``custom_vjp``.

PyTorch runs eagerly, so the policy selects on every call (the JAX
engine selects once per key at trace time; the learned, analytic and
autotune policies memoise per key); ``dispatch_report`` counts calls.
With no ``use_policy`` block open, the default policy (the learned
selector) decides.

Fault tolerance is the JAX engine's: ``run_decision`` walks the
decision's fallback chain -- the selected (candidate, tile), the same
candidate at its own plan, its binary-pair partner, and the op's library
reference (``candidates.fallback_chain``); the attention plan's chain
ends at the unfused plan.  An arm that fails is quarantined for the
process (``core/faults.py``; every policy's admissible set drops it),
the next arm runs, and the fallback is counted (``health_report``).
``DispatchError`` means every arm failed.  The chain degrades through
two failures only: an injected fault (``--chaos``), and a tile that is
not a plan of the call's route (``TileConfigError``), which sheds the
tile for the same candidate's own plan and goes no further.  Anything
else propagates with nothing quarantined -- a kernel that does not build
or does not launch (``KernelBuildError``, ``KernelLaunchError``), a
device allocation failure, a bug: a fault on the card must never hide
behind the cuBLAS arm, and the ledger, keyed by no shape, must not bar a
kernel at every shape for what one shape did.

``remat="dots"`` (``models/lm.py``) saves the outputs of the non-batched
GEMMs of a checkpointed unit and recomputes the rest: inside
``remat_record`` each NT/NN/TN dispatch keeps its output, and inside
``remat_replay`` (the recompute, in the backward) it returns them in
call order instead of selecting and launching again.  ``REMAT_COUNTS``
counts both, and any NT/NN/TN GEMM that ran during a replay.
"""

from __future__ import annotations

import contextlib
import contextvars
import warnings
from typing import Callable, Dict, Iterator, List, Optional

import torch

from repro_torch.kernels.attention_fused import NEG_INF, MaskParams
from repro_torch.kernels.common import TileConfigError
from repro_torch.kernels.ref import attention_visibility

from . import faults
from .candidates import DEFAULT_BY_OP, current_platform, fallback_chain, get_candidate
from .opkey import BATCHED_OPS, OPS, OpKey, check_op
from .policy import (
    AnalyticPolicy,
    AutotunePolicy,
    CascadePolicy,
    Decision,
    FixedPolicy,
    ModelPolicy,
    SelectionPolicy,
    current_policy,
    current_scope,
    default_policy,
    resume_scope,
    use_policy,
)

__all__ = [
    "dispatch",
    "dispatch_attention",
    "dispatch_batched",
    "dispatch_report",
    "health_report",
    "run_decision",
    "DispatchError",
    "REMAT_COUNTS",
    "remat_record",
    "remat_replay",
    "policy_select",
    "policy_from_spec",
    "add_policy_argument",
    "use_policy",
    "current_policy",
    "POLICY_SPEC_HELP",
]


class DispatchError(RuntimeError):
    """Every arm of an OpKey's fallback chain failed -- raised only when
    even the op's library reference cannot run (the chain's last arm is
    always attempted, quarantined or not)."""


# What the fallback chain degrades through (``_degrades``); every other
# exception propagates, a kernel that does not build or launch above all.
_DEGRADABLE = (faults.InjectedFault, TileConfigError)

POLICY_SPEC_HELP = (
    "dispatch policy: model[:artifact.json] | fixed:<NAME>[@BMxBNxBK] | "
    "fixed:nt=<NAME>[@cfg],nn=...,tn=...,bnt=...,bnn=...,"
    "attn=<fused|unfused>[@BQxBK] | analytic | "
    "cascade:<A[@cfg],B,...> | autotune[:cache.json]"
)

# ``fixed:attn=...`` accepts the plan-member aliases alongside literal
# candidate names; the fused arm's tile configs are (bq, bk) pairs.
_ATTN_ALIASES = {"fused": "FUSED_ATTN", "unfused": "UNFUSED_ATTN"}

_WARNED: set = set()


def _warn_once(tag: str, msg: str) -> None:
    if tag not in _WARNED:
        _WARNED.add(tag)
        warnings.warn(msg, UserWarning, stacklevel=3)


def _spec_error(msg: str) -> ValueError:
    return ValueError(f"{msg} ({POLICY_SPEC_HELP})")


def policy_select(policy: SelectionPolicy, key: OpKey, operands=()) -> Decision:
    """Run ``policy.select`` on an ``OpKey`` and validate the decision.  A
    decision naming a candidate that does not implement ``key.op`` runs
    the op's reference instead (warned once: that is a policy bug).

    A tuned tile (the learned, autotune and cascade policies) names a plan
    of the route that 16-byte aligned ``operands`` take, as a fresh
    allocation is; the policies memoise per ``OpKey``, which carries no
    alignment.  Operands that are not aligned (a view at an offset into a
    larger buffer) take another route on some kernels, and where that
    route has no plan at the tile the policy runs the candidate's own plan
    (config None).  A fixed policy's tile is the caller's own and reaches
    the wrapper; where it has no plan, the wrapper's ``TileConfigError``
    sheds it for the candidate's own plan (``_walk_chain``)."""
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
    if (decision.config is not None and not isinstance(policy, FixedPolicy)
            and any(x.data_ptr() % 16 for x in operands)
            and not get_candidate(decision.name).supports(
                config=decision.config, shape=(key.g, key.m, key.n, key.k, key.dsize),
                aligned=False)):
        decision = Decision(decision.name, None)
    return decision


def _decision_chain(op: str, decision: Decision) -> List[Decision]:
    """The decisions dispatch attempts, in order: the selected arm; the
    same candidate at its own plan (an explicit tile is the most fragile
    part of a decision, shed before the algorithm); then the registry's
    fallback chain, ending at the op's library reference."""
    chain = [decision]
    if decision.config is not None:
        chain.append(Decision(decision.name, None))
    for name in fallback_chain(op, decision.name):
        if name != decision.name:
            chain.append(Decision(name, None))
    return chain


def _degrades(dec: Decision, e: BaseException) -> bool:
    """Whether the chain goes on past ``dec`` after ``e`` (one of
    ``_DEGRADABLE``): an injected fault always; a ``TileConfigError`` only
    from an explicit tile, whose next arm is the same candidate's own
    plan -- the own plan is a plan of every route, so a tile error there
    is a bug and raises."""
    return not (isinstance(e, TileConfigError) and dec.config is None)


def _quarantine(op: str, dec: Decision, e: BaseException) -> None:
    faults.quarantine(dec.name, op, dec.config, e)
    _warn_once(
        f"quarantined:{dec.label()}:{op}",
        f"candidate {dec.label()!r} failed on op {op!r} "
        f"({type(e).__name__}: {e}); quarantined for this process, "
        "dispatch degrades down the fallback chain",
    )


def _walk_chain(key: OpKey, decision: Decision, run: Callable[[Decision], torch.Tensor]):
    """Run ``decision`` down its fallback chain: quarantined arms are
    skipped without an attempt (all but the last, which has nothing
    beneath it); an arm that fails with a degradable error (``_degrades``)
    is quarantined, warned once and left for the next; any other error
    raises with nothing quarantined; a fallback taken is counted.  Raises ``DispatchError`` when every arm failed.  The chain
    is built only once the selected arm is quarantined or has failed."""
    last_err: Optional[BaseException] = None
    if not faults.is_quarantined(decision.name, key.op, decision.config):
        try:
            faults.check_candidate_fault(decision.name, key.op)
            return run(decision)
        except _DEGRADABLE as e:
            if not _degrades(decision, e):
                raise
            _quarantine(key.op, decision, e)
            last_err = e
    chain = _decision_chain(key.op, decision)
    for i, dec in enumerate(chain):
        if i == 0 and last_err is not None:
            continue  # the selected arm, just failed
        if i < len(chain) - 1 and faults.is_quarantined(dec.name, key.op, dec.config):
            continue
        try:
            faults.check_candidate_fault(dec.name, key.op)
            out = run(dec)
        except _DEGRADABLE as e:
            if not _degrades(dec, e):
                raise
            _quarantine(key.op, dec, e)
            last_err = e
            continue
        if i:
            faults.record_fallback(key.op, decision.label(), dec.label())
        return out
    raise DispatchError(
        f"every arm of the fallback chain for {key} failed: "
        f"{[d.label() for d in chain]}"
    ) from last_err


def run_decision(key: OpKey, decision: Decision, *operands):
    """Execute a policy decision fault-tolerantly, down its fallback
    chain (``_walk_chain``)."""
    platform = current_platform(operands[0])

    def run(dec: Decision) -> torch.Tensor:
        cand = get_candidate(dec.name)
        if not cand.supports(platform=platform):
            raise RuntimeError(
                f"candidate {dec.name!r} does not run on {platform!r} "
                f"(runs on {cand.platforms})"
            )
        return cand.run(*operands, config=dec.config)

    return _walk_chain(key, decision, run)


# -- remat="dots": the non-batched GEMM outputs of a checkpointed unit ------------

REMAT_COUNTS: Dict[str, int] = {"saved": 0, "replayed": 0, "recompute_gemms": 0}

# (mode, records, [next index]) while a unit's forward records or its
# recompute replays; None elsewhere
_REMAT: contextvars.ContextVar[Optional[tuple]] = contextvars.ContextVar(
    "repro_torch_remat", default=None)


@contextlib.contextmanager
def remat_record(records: list) -> Iterator[None]:
    """Around a checkpointed unit's forward: every NT/NN/TN dispatch
    appends ``(op, operand shapes, output)`` to ``records``."""
    token = _REMAT.set(("record", records))
    try:
        yield
    finally:
        _REMAT.reset(token)


@contextlib.contextmanager
def remat_replay(records: list) -> Iterator[None]:
    """Around the unit's recompute: the NT/NN/TN dispatches return the
    outputs ``remat_record`` kept, in call order, without selecting or
    launching; batched GEMMs and attention run again."""
    token = _REMAT.set(("replay", records, [0]))
    try:
        yield
    finally:
        _REMAT.reset(token)


def _dense_gemm(op: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A 2-D GEMM of a forward, through the remat mode in force."""
    mode = _REMAT.get()
    if mode is None:
        return _run(op, a, b)
    if mode[0] == "record":
        out = _run(op, a, b)
        mode[1].append((op, a.shape, b.shape, out.detach()))
        REMAT_COUNTS["saved"] += 1
        return out
    records, nxt = mode[1], mode[2]
    if nxt[0] >= len(records) or records[nxt[0]][:3] != (op, a.shape, b.shape):
        got = records[nxt[0]][:3] if nxt[0] < len(records) else None
        raise RuntimeError(
            f"remat='dots' recompute dispatched {op} {tuple(a.shape)} x {tuple(b.shape)} "
            f"where its forward had {got}: the unit is not deterministic"
        )
    out = records[nxt[0]][3].detach()  # a fresh tensor for this recompute's graph
    nxt[0] += 1
    REMAT_COUNTS["replayed"] += 1
    return out


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
    mode = _REMAT.get()
    if mode is not None and mode[0] == "replay":
        REMAT_COUNTS["recompute_gemms"] += 1
    return run_decision(key, policy_select(current_policy(), key, (a, b)), a, b)


def _run3(op: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Select and execute one batched GEMM on (g, ., .) operands."""
    g, m, k = a.shape
    n = b.shape[1] if op == "BNT" else b.shape[2]
    key = OpKey(op, int(m), int(n), int(k), a.element_size(), int(g))
    return run_decision(key, policy_select(current_policy(), key, (a, b)), a, b)


def _swap(x: torch.Tensor) -> torch.Tensor:
    """The last two axes swapped, materialised: kernels take no views."""
    return x.transpose(-1, -2).contiguous()


# op -> (dA, dB) of C = op(A, B) with cotangent G, as dispatched GEMMs: the
# JAX engine's _dispatch2_bwd and _dispatch3_bwd.
_GRADS = {
    "NT": (lambda a, b, g: _run("NN", g, b), lambda a, b, g: _run("TN", g, a)),
    "NN": (lambda a, b, g: _run("NT", g, b), lambda a, b, g: _run("TN", a, g)),
    "TN": (lambda a, b, g: _run("NT", b, g), lambda a, b, g: _run("NN", a, g)),
    "BNT": (lambda a, b, g: _run3("BNN", g, b), lambda a, b, g: _run3("BNN", _swap(g), a)),
    "BNN": (lambda a, b, g: _run3("BNT", g, b), lambda a, b, g: _run3("BNN", _swap(a), g)),
}


class _Dispatch(torch.autograd.Function):
    """One 2-D or batched GEMM, differentiable through ``_GRADS``."""

    @staticmethod
    def forward(ctx, op, a, b):
        ctx.op, ctx.scope = op, current_scope()
        ctx.save_for_backward(a, b)
        return (_run3 if op in BATCHED_OPS else _dense_gemm)(op, a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.contiguous()
        grads = [None, None]
        with resume_scope(ctx.scope):
            for i, (fn, x) in enumerate(zip(_GRADS[ctx.op], (a, b))):
                if ctx.needs_input_grad[1 + i]:
                    grads[i] = fn(a, b, g).to(x.dtype)
        return None, *grads


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
    """Select and execute the attention plan down its fallback chain:
    ``FUSED_ATTN`` runs the fused kernel with the mask inside; every other
    arm (``UNFUSED_ATTN``, the chain's last, included) runs the unfused
    sub-dispatch plan, so a faulted fused kernel degrades to the BNT/BNN
    pair."""
    g, m, dh = q.shape
    n = k.shape[1]
    key = OpKey("ATTN", int(m), int(n), int(dh), q.element_size(), int(g))
    decision = policy_select(current_policy(), key, (q, k, v))

    def run(dec: Decision) -> torch.Tensor:
        if dec.name == "FUSED_ATTN":
            from repro_torch.kernels.attention_fused import attention_fused

            block = tuple(dec.config) if dec.config is not None else None
            return attention_fused(q, k, v, lengths, mask=mask, block=block)
        return _unfused_attn_plan(mask, q, k, v, lengths)

    return _walk_chain(key, decision, run)


class _DispatchAttn(torch.autograd.Function):
    """The attention plan; the backward is ``_dispatch_attn_bwd`` of the
    JAX engine (flash-style: recompute, never save, the probabilities)."""

    @staticmethod
    def forward(ctx, mask, q, k, v, lengths):
        ctx.mask, ctx.scope = mask, current_scope()
        ctx.save_for_backward(q, k, v, lengths)
        return _run_attn(mask, q, k, v, lengths)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, lengths = ctx.saved_tensors
        mask = ctx.mask
        with resume_scope(ctx.scope):
            s_raw = _attn_logits(q, k)
            probs = _attn_probs(mask, s_raw, lengths)  # (g, m, n) f32
            dout32 = dout.float().contiguous()
            # dV = P^T dO; masked probabilities are 0, so invalid rows get 0
            dv = _run3("BNN", _swap(probs), dout32)
            # dP = dO V^T, V zeroed beyond lengths as in the forward mix
            dp = _run3("BNT", dout32, _zero_invalid_kv(v, lengths).float().contiguous())
            # softmax vjp: dS = P * (dP - sum(dP * P)); masked entries stay 0
            ds = probs * (dp - torch.sum(dp * probs, dim=-1, keepdim=True))
            if mask.softcap:
                ds = ds * (1.0 - torch.tanh(s_raw / mask.softcap) ** 2)
            dq = _run3("BNN", ds, k.float())
            dk = _run3("BNN", _swap(ds), q.float())
        return None, dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None


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
    pre-scaled by ``d_head**-0.5``.  Differentiable in q, k and v."""
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
    out = _DispatchAttn.apply(mask, q3, k3, v3, lengths3)
    return out.reshape(lead + out.shape[-2:])


def dispatch(op: str, a, b, policy: Optional[SelectionPolicy] = None):
    """Compute one dense-layer GEMM through the policy-selected
    (candidate, tile config).

      dispatch("NT", a, b)   a:(..., m, k) @ b:(n, k)^T -> (..., m, n)
      dispatch("NN", a, b)   a:(..., m, k) @ b:(k, n)   -> (..., m, n)
      dispatch("TN", a, b)   a:(k, m)^T    @ b:(k, n)   -> (m, n)

    For NT, ``b`` is a weight in the (out, in) convention, so a dense
    layer's forward pass is the paper's NT operation.  Leading dims of
    ``a`` flatten for NT/NN.  An explicit ``policy=`` scopes this call's
    forward only; the gradients dispatch under the scope of the backward."""
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
        return _Dispatch.apply("TN", a.contiguous(), b.contiguous())
    lead = a.shape[:-1]
    out = _Dispatch.apply(op, a.reshape(-1, a.shape[-1]).contiguous(), b.contiguous())
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
    out = _Dispatch.apply(op, a3, b3)
    return out.reshape(lead + out.shape[-2:])


def dispatch_report(policy: Optional[SelectionPolicy] = None) -> str:
    """Render per-(op, candidate, tile-config) call counts of ``policy``
    (default: the scoped policy), grouped by op kind and keyed
    ``NAME@BMxBNxBK`` for decisions with an explicit tile."""
    pol = policy if policy is not None else current_policy()
    stats = pol.stats
    lines = [f"dispatch report — {pol!r}"]
    quarantined = faults.quarantine_entries()
    if quarantined:
        lines.append(
            f"  quarantined arms: {len(quarantined)} "
            f"({', '.join(e.label() for e in quarantined)}) — see health_report()"
        )
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


def health_report() -> str:
    """Render the process-wide dispatch health: the armed fault-injection
    rules, the quarantine ledger (which arms failed, how, how often) and
    the fallbacks taken.  Returns the text; callers print it."""
    lines = ["health report — dispatch fault tolerance"]
    rules = faults.active_faults()
    if rules:
        lines.append(f"  fault injection: {len(rules)} armed rule(s)")
        lines.extend(f"    {rule.describe()}" for rule in rules)
    else:
        lines.append("  fault injection: (none armed)")
    entries = faults.quarantine_entries()
    if entries:
        lines.append(f"  quarantined arms: {len(entries)}")
        for e in entries:
            lines.append(f"    {e.op:<4s} {e.label():<24s} failures={e.count} [{e.error}]")
    else:
        lines.append("  quarantined arms: (none)")
    fallbacks = faults.fallback_counts()
    if fallbacks:
        lines.append(f"  fallbacks taken: {sum(fallbacks.values())}")
        for (op, selected, executed), n in sorted(fallbacks.items()):
            lines.append(f"    {op:<4s} {selected} -> {executed} x{n}")
    else:
        lines.append("  fallbacks taken: (none)")
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


def policy_from_spec(spec: str, distributed: bool = False, device="cuda") -> SelectionPolicy:
    """Build a policy from a CLI spec string.

      model[:path]                       learned selector (the default
                                         selector, or an artifact)
      fixed:XLA_TNN                      FixedPolicy (other ops run each
                                         op's reference)
      fixed:PALLAS_NT@8x128x192          FixedPolicy with a forced tile: a
                                         plan of the candidate's kernel
                                         (kernels/tiling.py); a shape whose
                                         route has no such plan raises
      fixed:nt=PALLAS_TNN,attn=fused     op-qualified FixedPolicy
      fixed:attn=fused@4x64              attention plan entry; fused tiles
                                         are (bq, bk)
      analytic                           AnalyticPolicy (H100 roofline)
      cascade:A,B@BMxBNxBK,C             CascadePolicy over the names; an
                                         entry with a tile is taken only
                                         where its kernel has that plan
      autotune[:cache.json]              AutotunePolicy measuring on
                                         ``device`` (default cache:
                                         ``measure.default_cache_path()``)

    ``distributed=True`` restricts the guarded policies to the candidates
    marked distributed-safe and disables autotune measurement, as in the
    JAX package (the port's launchers run on one device)."""
    kind, _, arg = spec.strip().partition(":")
    kind, arg = kind.strip(), arg.strip()
    if not kind:
        raise _spec_error("empty policy spec")
    if kind == "model":
        if not arg:
            return default_policy()  # the default selector: distributed-safe
        # recover=True: a corrupt artifact is moved aside and a fallback
        # selector trained, never a crash
        return ModelPolicy.from_artifact(arg, distributed=distributed, recover=True)
    if kind == "fixed":
        if not arg:
            raise _spec_error("fixed policy needs a candidate: fixed:<NAME>")
        return _parse_fixed_arg(arg)
    if kind == "analytic":
        return AnalyticPolicy(distributed=distributed)
    if kind == "autotune":
        from .measure import default_cache_path

        return AutotunePolicy(cache_path=arg or default_cache_path(),
                              distributed=distributed, device=device)
    if kind == "cascade":
        names = [n.strip() for n in arg.split(",") if n.strip()]
        if not names:
            raise _spec_error("cascade policy needs names: cascade:<A,B,...>")
        return CascadePolicy(names, distributed=distributed)
    raise _spec_error(f"unknown policy spec {spec!r}")


def add_policy_argument(parser) -> None:
    """Attach the shared ``--policy`` option to an argparse parser (the
    JAX package's default, ``model``: the default learned selector)."""
    parser.add_argument("--policy", default="model", help=POLICY_SPEC_HELP)
