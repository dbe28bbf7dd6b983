"""From-scratch gradient-boosted decision trees (the paper's learner).

The paper uses XGBoost with CART base learners, ``max_depth=8``,
``n_estimators=8``, ``eta=1.0``, ``gamma=0``.  XGBoost is not available in
this offline container, so we implement the second-order boosting algorithm
it uses (Chen & Guestrin 2016) directly on numpy:

  * exact greedy split finding with the gain
        0.5 * (G_L^2/(H_L+lam) + G_R^2/(H_R+lam) - G^2/(H+lam)) - gamma
  * leaf weight  w = -G/(H+lam)
  * binary logistic loss: g = p - y,  h = p (1 - p)

Also provides :class:`DecisionTreeClassifier` (plain CART with gini
impurity) for the paper's Table VI comparison.

Everything is deterministic given the input data.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np

__all__ = [
    "TreeNode",
    "RegressionTree",
    "GBDTClassifier",
    "DecisionTreeClassifier",
]


@dataclass
class TreeNode:
    """A single CART node.  Leaves have ``feature == -1``."""

    feature: int = -1
    threshold: float = 0.0
    value: float = 0.0
    left: Optional["TreeNode"] = None
    right: Optional["TreeNode"] = None

    def is_leaf(self) -> bool:
        return self.feature < 0

    def to_dict(self) -> Dict[str, Any]:
        if self.is_leaf():
            return {"value": float(self.value)}
        return {
            "feature": int(self.feature),
            "threshold": float(self.threshold),
            "left": self.left.to_dict(),
            "right": self.right.to_dict(),
        }

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "TreeNode":
        if "feature" not in d:
            return TreeNode(value=float(d["value"]))
        return TreeNode(
            feature=int(d["feature"]),
            threshold=float(d["threshold"]),
            left=TreeNode.from_dict(d["left"]),
            right=TreeNode.from_dict(d["right"]),
        )

    def depth(self) -> int:
        if self.is_leaf():
            return 0
        return 1 + max(self.left.depth(), self.right.depth())

    def n_nodes(self) -> int:
        if self.is_leaf():
            return 1
        return 1 + self.left.n_nodes() + self.right.n_nodes()


def _best_split(
    X: np.ndarray,
    g: np.ndarray,
    h: np.ndarray,
    lam: float,
    gamma: float,
    min_child_weight: float,
):
    """Exact greedy split search.  Returns (gain, feature, threshold)."""
    n, d = X.shape
    G, H = g.sum(), h.sum()
    parent = G * G / (H + lam)
    best = (0.0, -1, 0.0)
    for j in range(d):
        order = np.argsort(X[:, j], kind="stable")
        xs = X[order, j]
        gs = np.cumsum(g[order])
        hs = np.cumsum(h[order])
        # candidate split after position i (i.e. left = order[:i+1])
        # valid only where xs[i] != xs[i+1]
        valid = xs[:-1] != xs[1:]
        if not valid.any():
            continue
        GL, HL = gs[:-1], hs[:-1]
        GR, HR = G - GL, H - HL
        ok = valid & (HL >= min_child_weight) & (HR >= min_child_weight)
        if not ok.any():
            continue
        gains = 0.5 * (GL**2 / (HL + lam) + GR**2 / (HR + lam) - parent) - gamma
        gains = np.where(ok, gains, -np.inf)
        i = int(np.argmax(gains))
        if gains[i] > best[0]:
            thr = 0.5 * (xs[i] + xs[i + 1])
            best = (float(gains[i]), j, float(thr))
    return best


class RegressionTree:
    """Second-order CART regression tree (XGBoost-style base learner)."""

    def __init__(
        self,
        max_depth: int = 8,
        lam: float = 1.0,
        gamma: float = 0.0,
        min_child_weight: float = 1e-6,
    ):
        self.max_depth = max_depth
        self.lam = lam
        self.gamma = gamma
        self.min_child_weight = min_child_weight
        self.root: Optional[TreeNode] = None

    def fit(self, X: np.ndarray, g: np.ndarray, h: np.ndarray) -> "RegressionTree":
        X = np.asarray(X, dtype=np.float64)
        g = np.asarray(g, dtype=np.float64)
        h = np.asarray(h, dtype=np.float64)
        self.root = self._build(X, g, h, depth=0)
        return self

    def _leaf(self, g: np.ndarray, h: np.ndarray) -> TreeNode:
        return TreeNode(value=-g.sum() / (h.sum() + self.lam))

    def _build(self, X, g, h, depth) -> TreeNode:
        if depth >= self.max_depth or len(g) < 2:
            return self._leaf(g, h)
        gain, feat, thr = _best_split(
            X, g, h, self.lam, self.gamma, self.min_child_weight
        )
        if feat < 0 or gain <= 0.0:
            return self._leaf(g, h)
        mask = X[:, feat] <= thr
        node = TreeNode(feature=feat, threshold=thr)
        node.left = self._build(X[mask], g[mask], h[mask], depth + 1)
        node.right = self._build(X[~mask], g[~mask], h[~mask], depth + 1)
        return node

    def predict(self, X: np.ndarray) -> np.ndarray:
        X = np.asarray(X, dtype=np.float64)
        out = np.empty(len(X), dtype=np.float64)
        # iterative traversal; vectorised by partitioning index sets
        stack = [(self.root, np.arange(len(X)))]
        while stack:
            node, idx = stack.pop()
            if len(idx) == 0:
                continue
            if node.is_leaf():
                out[idx] = node.value
                continue
            mask = X[idx, node.feature] <= node.threshold
            stack.append((node.left, idx[mask]))
            stack.append((node.right, idx[~mask]))
        return out


def _sigmoid(x: np.ndarray) -> np.ndarray:
    return 0.5 * (1.0 + np.tanh(0.5 * x))


class GBDTClassifier:
    """Binary gradient-boosted classifier with logistic loss.

    Labels are in {-1, +1} (paper convention: -1 => TNN faster, +1 => NT
    faster-or-equal).  Internally mapped to {0, 1}.
    """

    def __init__(
        self,
        n_estimators: int = 8,
        max_depth: int = 8,
        eta: float = 1.0,
        lam: float = 1.0,
        gamma: float = 0.0,
        base_score: float = 0.5,
    ):
        self.n_estimators = n_estimators
        self.max_depth = max_depth
        self.eta = eta
        self.lam = lam
        self.gamma = gamma
        self.base_score = base_score
        self.trees: List[RegressionTree] = []

    # -- training ---------------------------------------------------------
    def fit(self, X: np.ndarray, y: np.ndarray) -> "GBDTClassifier":
        X = np.asarray(X, dtype=np.float64)
        y01 = (np.asarray(y) > 0).astype(np.float64)
        f = np.full(len(y01), math.log(self.base_score / (1 - self.base_score)))
        self.trees = []
        for _ in range(self.n_estimators):
            p = _sigmoid(f)
            g = p - y01
            h = np.maximum(p * (1.0 - p), 1e-12)
            tree = RegressionTree(
                max_depth=self.max_depth, lam=self.lam, gamma=self.gamma
            ).fit(X, g, h)
            self.trees.append(tree)
            f = f + self.eta * tree.predict(X)
        return self

    # -- inference --------------------------------------------------------
    def decision_function(self, X: np.ndarray) -> np.ndarray:
        X = np.asarray(X, dtype=np.float64)
        f = np.full(
            len(X), math.log(self.base_score / (1 - self.base_score))
        )
        for tree in self.trees:
            f = f + self.eta * tree.predict(X)
        return f

    def predict_proba(self, X: np.ndarray) -> np.ndarray:
        return _sigmoid(self.decision_function(X))

    def predict(self, X: np.ndarray) -> np.ndarray:
        """Returns labels in {-1, +1}."""
        return np.where(self.decision_function(X) >= 0.0, 1, -1)

    # -- persistence ------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return {
            "kind": "gbdt",
            "n_estimators": self.n_estimators,
            "max_depth": self.max_depth,
            "eta": self.eta,
            "lam": self.lam,
            "gamma": self.gamma,
            "base_score": self.base_score,
            "trees": [t.root.to_dict() for t in self.trees],
        }

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "GBDTClassifier":
        m = GBDTClassifier(
            n_estimators=d["n_estimators"],
            max_depth=d["max_depth"],
            eta=d["eta"],
            lam=d["lam"],
            gamma=d["gamma"],
            base_score=d["base_score"],
        )
        for td in d["trees"]:
            t = RegressionTree(max_depth=d["max_depth"], lam=d["lam"], gamma=d["gamma"])
            t.root = TreeNode.from_dict(td)
            m.trees.append(t)
        return m

    def save(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump(self.to_dict(), fh)

    @staticmethod
    def load(path: str) -> "GBDTClassifier":
        with open(path) as fh:
            return GBDTClassifier.from_dict(json.load(fh))


class GBDTRegressor:
    """Gradient-boosted regression (squared loss) — used by the beyond-paper
    k-way selector to predict log-runtime per candidate algorithm."""

    def __init__(
        self,
        n_estimators: int = 24,
        max_depth: int = 6,
        eta: float = 0.3,
        lam: float = 1.0,
        gamma: float = 0.0,
    ):
        self.n_estimators = n_estimators
        self.max_depth = max_depth
        self.eta = eta
        self.lam = lam
        self.gamma = gamma
        self.base = 0.0
        self.trees: List[RegressionTree] = []

    def fit(self, X: np.ndarray, y: np.ndarray) -> "GBDTRegressor":
        X = np.asarray(X, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        self.base = float(y.mean())
        f = np.full(len(y), self.base)
        self.trees = []
        h = np.ones(len(y))
        for _ in range(self.n_estimators):
            g = f - y  # d/df 0.5 (f-y)^2
            tree = RegressionTree(
                max_depth=self.max_depth, lam=self.lam, gamma=self.gamma
            ).fit(X, g, h)
            self.trees.append(tree)
            f = f + self.eta * tree.predict(X)
        return self

    def predict(self, X: np.ndarray) -> np.ndarray:
        X = np.asarray(X, dtype=np.float64)
        f = np.full(len(X), self.base)
        for tree in self.trees:
            f = f + self.eta * tree.predict(X)
        return f

    def to_dict(self) -> Dict[str, Any]:
        return {
            "kind": "gbdt_regressor",
            "n_estimators": self.n_estimators,
            "max_depth": self.max_depth,
            "eta": self.eta,
            "lam": self.lam,
            "gamma": self.gamma,
            "base": self.base,
            "trees": [t.root.to_dict() for t in self.trees],
        }

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "GBDTRegressor":
        m = GBDTRegressor(
            n_estimators=d["n_estimators"],
            max_depth=d["max_depth"],
            eta=d["eta"],
            lam=d["lam"],
            gamma=d["gamma"],
        )
        m.base = d["base"]
        for td in d["trees"]:
            t = RegressionTree(max_depth=d["max_depth"], lam=d["lam"], gamma=d["gamma"])
            t.root = TreeNode.from_dict(td)
            m.trees.append(t)
        return m


class DecisionTreeClassifier:
    """Plain CART classifier (gini), for the paper's Table VI comparison."""

    def __init__(self, max_depth: int = 8, min_samples_leaf: int = 1):
        self.max_depth = max_depth
        self.min_samples_leaf = min_samples_leaf
        self.root: Optional[TreeNode] = None

    def fit(self, X: np.ndarray, y: np.ndarray) -> "DecisionTreeClassifier":
        X = np.asarray(X, dtype=np.float64)
        y01 = (np.asarray(y) > 0).astype(np.float64)
        self.root = self._build(X, y01, 0)
        return self

    def _build(self, X, y, depth) -> TreeNode:
        pos = y.sum()
        n = len(y)
        if depth >= self.max_depth or n < 2 * self.min_samples_leaf or pos in (0, n):
            return TreeNode(value=1.0 if pos * 2 >= n else -1.0)
        best = (0.0, -1, 0.0)
        parent_gini = 1.0 - (pos / n) ** 2 - (1 - pos / n) ** 2
        for j in range(X.shape[1]):
            order = np.argsort(X[:, j], kind="stable")
            xs, ys = X[order, j], y[order]
            cum_pos = np.cumsum(ys)[:-1]
            nl = np.arange(1, n)
            nr = n - nl
            valid = (xs[:-1] != xs[1:]) & (nl >= self.min_samples_leaf) & (
                nr >= self.min_samples_leaf
            )
            if not valid.any():
                continue
            pl = cum_pos / nl
            pr = (pos - cum_pos) / nr
            gini = (nl / n) * (1 - pl**2 - (1 - pl) ** 2) + (nr / n) * (
                1 - pr**2 - (1 - pr) ** 2
            )
            gain = np.where(valid, parent_gini - gini, -np.inf)
            i = int(np.argmax(gain))
            if gain[i] > best[0]:
                best = (float(gain[i]), j, 0.5 * (xs[i] + xs[i + 1]))
        gain, feat, thr = best
        if feat < 0:
            return TreeNode(value=1.0 if pos * 2 >= n else -1.0)
        mask = X[:, feat] <= thr
        node = TreeNode(feature=feat, threshold=thr)
        node.left = self._build(X[mask], y[mask], depth + 1)
        node.right = self._build(X[~mask], y[~mask], depth + 1)
        return node

    def predict(self, X: np.ndarray) -> np.ndarray:
        X = np.asarray(X, dtype=np.float64)
        out = np.empty(len(X), dtype=np.float64)
        stack = [(self.root, np.arange(len(X)))]
        while stack:
            node, idx = stack.pop()
            if len(idx) == 0:
                continue
            if node.is_leaf():
                out[idx] = node.value
                continue
            mask = X[idx, node.feature] <= node.threshold
            stack.append((node.left, idx[mask]))
            stack.append((node.right, idx[~mask]))
        return np.where(out >= 0, 1, -1)
