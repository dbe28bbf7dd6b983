"""Static analysis of the port's machine-checked invariants.

The port's central contract is the JAX package's: every GEMM-shaped
contraction of a model or launcher routes through the selection policy
(``core.dispatch``, ``core.dispatch_attention``), the candidate registry
stays consistent, persisted artifacts match their schemas, every
candidate keeps its shape contract on every plan, bf16 products
accumulate in f32, no kernel reads memory it was not given, and shared
state is mutated under its declared lock.  These passes check it:

  * ``dispatch_lint``  -- AST walk flagging ``torch.einsum``,
    ``torch.matmul``/``mm``/``bmm``/``tensordot``, ``F.linear`` and ``@``
    calls that bypass the dispatch engine (rules DL0xx);
  * ``registry_lint``  -- candidate-registry consistency: defaults,
    binary pairs, analytic arms, tile-config spaces, per-(op, platform)
    enumeration, fallback chains (rules RC1xx);
  * ``artifacts_lint`` -- torch-free validation of measurement caches,
    selector artifacts and the committed ``BENCH_{kernels,serve}.json``
    against ``schemas.py``'s mirror of the port's constants (rules AR2xx);
  * ``contracts``      -- every candidate's output shape and dtype on the
    meta route (the port's ``eval_shape``) against the plain route's, and
    every enumerated tile plan's split and shared memory (rules KC30x);
  * ``numerics``       -- f32 accumulation read from the CUDA sources (mma
    types and outputs, accumulator declarations, downcasts) and the
    kernel arms' plain routes (rules NM401-NM403);
  * ``sanitize``       -- the poison sanitizer, every plan run on poisoned
    and zero-filled memory (rule NM404; ``lint --sanitize`` on the CPU,
    ``chip_smoke.py`` and a ``gpu``-marked test on the card);
  * ``concurrency``    -- AST checker for ``# guarded-by: <lock>``
    annotations, ContextVar set/reset pairing and thread/acquire hygiene
    (rules CC5xx).

``python -m repro_torch.analysis.lint`` runs them (the passes that read
sources share one source cache, ``cache.py``); findings carry file:line,
severity and a rule id, and the committed baseline (``baseline.json``
beside these modules) suppresses known findings, each with its
justification.  The rule catalogue is ``lint-rules.md`` beside them.
None of this imports the JAX package; the dispatch, artifact and
concurrency passes import nothing beyond the standard library.
"""

from .findings import (
    Baseline,
    Finding,
    RULES,
    SEVERITIES,
)

__all__ = ["Baseline", "Finding", "RULES", "SEVERITIES"]
