"""repro_torch.core -- the dispatch engine, the candidate registry and the
scoped selection policies of the port."""

from .candidates import (
    BINARY_PAIRS_BY_OP,
    CANDIDATES,
    DEFAULT_BY_OP,
    PAPER_PAIR,
    get_candidate,
    register_candidate,
    unregister_candidate,
)
from .engine import (
    dispatch,
    dispatch_attention,
    dispatch_batched,
    dispatch_report,
    policy_from_spec,
)
from .opkey import OPS, OpKey
from .policy import Decision, FixedPolicy, current_policy, use_policy

__all__ = [
    "BINARY_PAIRS_BY_OP",
    "CANDIDATES",
    "DEFAULT_BY_OP",
    "PAPER_PAIR",
    "get_candidate",
    "register_candidate",
    "unregister_candidate",
    "dispatch",
    "dispatch_attention",
    "dispatch_batched",
    "dispatch_report",
    "policy_from_spec",
    "OPS",
    "OpKey",
    "Decision",
    "FixedPolicy",
    "current_policy",
    "use_policy",
]
