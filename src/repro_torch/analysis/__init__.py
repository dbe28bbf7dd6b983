"""Static analysis of the port's machine-checked invariants.

The port's central contract is the JAX package's: every GEMM-shaped
contraction of a model or launcher routes through the selection policy
(``core.dispatch``, ``core.dispatch_attention``), the candidate registry
stays consistent, and shared state is mutated under its declared lock.
These passes check it statically, before a kernel runs:

  * ``dispatch_lint``  -- AST walk flagging ``torch.einsum``,
    ``torch.matmul``/``mm``/``bmm``/``tensordot``, ``F.linear`` and ``@``
    calls that bypass the dispatch engine (rules DL0xx);
  * ``registry_lint``  -- candidate-registry consistency: defaults,
    binary pairs, analytic arms, tile-config spaces, per-(op, platform)
    enumeration, fallback chains (rules RC1xx);
  * ``concurrency``    -- AST checker for ``# guarded-by: <lock>``
    annotations, ContextVar set/reset pairing and thread/acquire hygiene
    (rules CC5xx).

``python -m repro_torch.analysis.lint`` runs them (the AST passes share
one parsed-source cache, ``cache.py``); findings carry file:line,
severity and a rule id, and the committed baseline (``baseline.json``
beside these modules) suppresses known findings, each with its
justification.  The rule catalogue is ``lint-rules.md`` beside them.
None of this imports the JAX package; the AST passes themselves import
nothing beyond the standard library.
"""

from .findings import (
    Baseline,
    Finding,
    RULES,
    SEVERITIES,
)

__all__ = ["Baseline", "Finding", "RULES", "SEVERITIES"]
