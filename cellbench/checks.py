"""The numbers ``correct`` is decided from, each held to its limit.

Training (the first steps of the timed object, through the window's own
call and feed, against the reference's steps on the same rows):

  loss_gap        the largest relative gap of a step's loss;
  grad_norm_gap   the relative gap of the first step's global gradient
                  norm before clipping;
  first_grad_gap  the worst leaf's gap between the norms of the first
                  gradient as the optimizer takes it (clipped; worked out
                  from the first moment after one step), against the
                  reference's norm of that leaf or of the median leaf,
                  whichever is larger;
  change_gap      the same for the norm of each leaf's change over the
                  checked steps, over the leaves whose reference
                  gradient is at least a thousandth of the median
                  leaf's (the others move by round-off alone).

Serving: ``logit_gap``, the widest gap by which a served token's logit
lies below the reference's best at its position, in units of the
standard deviation of the reference's logits there, over a sample of
the finished requests drawn from the seed, the longest among them.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = ["rel_gap", "leaf_gap", "moving_leaves", "train_numbers", "Check", "judge"]

Check = Tuple[str, float, float]  # (name, value, limit)


def rel_gap(value: float, ref: float) -> float:
    return abs(value - ref) / max(abs(ref), 1e-30)


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
             leaves: Optional[Iterable[str]] = None) -> float:
    """max over ``leaves`` of |prog - ref| / max(ref, median ref)."""
    names = list(leaves) if leaves is not None else list(ref)
    med = statistics.median(ref[k] for k in names)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in names)


def moving_leaves(ref_grad: Dict[str, float]) -> List[str]:
    """The leaves whose reference gradient norm is at least 1e-3 of the
    median leaf's."""
    med = statistics.median(ref_grad.values())
    return [k for k, v in ref_grad.items() if v >= 1e-3 * med]


def train_numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The training numbers from the two sides' readings (each with
    ``losses``, ``grad_norm``, ``first_grad`` and ``change``)."""
    if len(prog["losses"]) != len(ref["losses"]):
        raise ValueError("the two sides checked different numbers of steps")
    return {
        "loss_gap": max(rel_gap(a, b) for a, b in zip(prog["losses"], ref["losses"])),
        "grad_norm_gap": rel_gap(prog["grad_norm"], ref["grad_norm"]),
        "first_grad_gap": leaf_gap(prog["first_grad"], ref["first_grad"]),
        "change_gap": leaf_gap(prog["change"], ref["change"], moving_leaves(ref["first_grad"])),
    }


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, List[Check]]:
    """Every number against its limit; a number that is not finite, or
    has no limit, fails."""
    checks: List[Check] = []
    ok = True
    for name, value in numbers.items():
        limit = limits.get(name)
        if limit is None or not math.isfinite(value) or value > limit:
            ok = False
        checks.append((name, float(value), float(limit) if limit is not None else float("nan")))
    missing = set(limits) - set(numbers)
    if missing:
        ok = False
        checks += [(name, float("nan"), float(limits[name])) for name in sorted(missing)]
    return ok, checks
