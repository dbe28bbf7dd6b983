"""Feature extraction for the selection problem.

Paper format (8-dim):  (gm, sm, cc, mbw, l2c, m, n, k) -> label in {-1, +1}

Op-space extension (9-dim): the paper routes only the forward NT GEMM;
our dispatch covers the backward NN/TN gradients too, so the op kind is a
model feature — ordinal-encoded.

Batched extension (10-dim): the attention contractions (BNT/BNN) add the
collapsed batch extent ``g`` as the last column.  Each extension appends
*after* the existing layout, so models trained on the 8-dim paper format
or the 9-dim op-space format keep predicting unchanged (tree-based
learners never look past the feature indices they were trained on).

The port's default selector decides attention (ATTN) with a model of its
own (``make_attn_features``): the same 10 columns plus the element size,
since attention's two arms part most where f32 makes the core
compute-bound, and the ATTN rows sweep both dtypes.

Feature generation is O(1) — the paper stresses this so the predictor adds
negligible overhead.  PyTorch dispatches eagerly, so the selectors memoise
their decision per ``OpKey``: features are built once per distinct key.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .hardware import HardwareSpec
from .opkey import check_op

__all__ = [
    "FEATURE_NAMES",
    "OP_FEATURE",
    "make_features",
    "make_attn_features",
    "make_feature_matrix",
    "normalize01",
]

FEATURE_NAMES = ("gm", "sm", "cc", "mbw", "l2c", "m", "n", "k", "op", "g")

# Ordinal op encoding; index order matches opkey.OPS.
OP_FEATURE = {
    "NT": 0.0, "NN": 1.0, "TN": 2.0, "BNT": 3.0, "BNN": 4.0, "ATTN": 5.0,
}


def make_features(
    hw: HardwareSpec, m: int, n: int, k: int, op: str = "NT", g: int = 1
) -> np.ndarray:
    """The paper's 8-dim sample vector plus the op-kind and batch-extent
    columns.  O(1)."""
    gm, sm, cc, mbw, l2c = hw.features()
    return np.array(
        [gm, sm, cc, mbw, l2c, float(m), float(n), float(k),
         OP_FEATURE[check_op(op)], float(g)]
    )


def make_attn_features(
    hw: HardwareSpec, m: int, n: int, dh: int, dsize: int, g: int
) -> np.ndarray:
    """An ATTN row's vector: ``make_features`` at (m, n, dh) plus the
    element size as an 11th column.  O(1)."""
    return np.append(make_features(hw, m, n, dh, op="ATTN", g=g), float(dsize))


def make_feature_matrix(
    hw: HardwareSpec,
    mnk: Sequence[Sequence[int]],
    ops: Optional[Sequence[str]] = None,
    gs: Optional[Sequence[int]] = None,
) -> np.ndarray:
    base = np.array(hw.features(), dtype=np.float64)
    mnk = np.asarray(mnk, dtype=np.float64)
    if ops is None:
        op_col = np.zeros((len(mnk), 1))  # all-NT: the paper's setting
    else:
        op_col = np.array(
            [[OP_FEATURE[check_op(o)]] for o in ops], dtype=np.float64
        )
    if gs is None:
        g_col = np.ones((len(mnk), 1))  # unbatched ops
    else:
        g_col = np.asarray(gs, dtype=np.float64).reshape(-1, 1)
    return np.concatenate(
        [np.tile(base, (len(mnk), 1)), mnk, op_col, g_col], axis=1
    )


def normalize01(X: np.ndarray, lo=None, hi=None):
    """(0,1) min-max normalisation — required for SVMs, not for trees."""
    X = np.asarray(X, dtype=np.float64)
    lo = X.min(axis=0) if lo is None else lo
    hi = X.max(axis=0) if hi is None else hi
    span = np.where(hi > lo, hi - lo, 1.0)
    return (X - lo) / span, lo, hi
