"""Minimal kernel SVM trained with simplified SMO (Platt 1998).

Used only for the paper's Table VI comparison (GBDT vs SVM-RBF vs SVM-Poly
vs DT).  libSVM is not available offline; this is a compact, deterministic
re-implementation sufficient for the ~2k-sample selection dataset.

Paper hyper-parameters: C = 1000.0, gamma = 0.01, features normalised to
(0, 1) before training (normalisation lives in the caller, see
``core.train_model``).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

__all__ = ["SVMClassifier", "rbf_kernel", "poly_kernel"]


def rbf_kernel(gamma: float) -> Callable[[np.ndarray, np.ndarray], np.ndarray]:
    def k(a: np.ndarray, b: np.ndarray) -> np.ndarray:
        aa = (a * a).sum(axis=1)[:, None]
        bb = (b * b).sum(axis=1)[None, :]
        d2 = np.maximum(aa + bb - 2.0 * a @ b.T, 0.0)
        return np.exp(-gamma * d2)

    return k


def poly_kernel(gamma: float, degree: int = 3, coef0: float = 0.0):
    def k(a: np.ndarray, b: np.ndarray) -> np.ndarray:
        return (gamma * (a @ b.T) + coef0) ** degree

    return k


class SVMClassifier:
    """Binary SVM, labels in {-1, +1}."""

    def __init__(
        self,
        C: float = 1000.0,
        kernel: str = "rbf",
        gamma: float = 0.01,
        degree: int = 3,
        tol: float = 1e-3,
        max_passes: int = 5,
        max_iter: int = 2000,
        seed: int = 0,
    ):
        self.C = C
        self.kernel_name = kernel
        self.gamma = gamma
        self.degree = degree
        self.tol = tol
        self.max_passes = max_passes
        self.max_iter = max_iter
        self.seed = seed
        self._kfn = (
            rbf_kernel(gamma) if kernel == "rbf" else poly_kernel(gamma, degree)
        )
        self.alpha: Optional[np.ndarray] = None
        self.b = 0.0
        self.X: Optional[np.ndarray] = None
        self.y: Optional[np.ndarray] = None

    def fit(self, X: np.ndarray, y: np.ndarray) -> "SVMClassifier":
        X = np.asarray(X, dtype=np.float64)
        y = np.where(np.asarray(y) > 0, 1.0, -1.0)
        n = len(y)
        K = self._kfn(X, X)
        alpha = np.zeros(n)
        b = 0.0
        rng = np.random.RandomState(self.seed)

        def f(i):
            return (alpha * y) @ K[:, i] + b

        passes = 0
        it = 0
        while passes < self.max_passes and it < self.max_iter:
            it += 1
            changed = 0
            for i in range(n):
                Ei = f(i) - y[i]
                if (y[i] * Ei < -self.tol and alpha[i] < self.C) or (
                    y[i] * Ei > self.tol and alpha[i] > 0
                ):
                    j = rng.randint(n - 1)
                    if j >= i:
                        j += 1
                    Ej = f(j) - y[j]
                    ai, aj = alpha[i], alpha[j]
                    if y[i] != y[j]:
                        L, H = max(0.0, aj - ai), min(self.C, self.C + aj - ai)
                    else:
                        L, H = max(0.0, ai + aj - self.C), min(self.C, ai + aj)
                    if L >= H:
                        continue
                    eta = 2.0 * K[i, j] - K[i, i] - K[j, j]
                    if eta >= 0:
                        continue
                    alpha[j] = np.clip(aj - y[j] * (Ei - Ej) / eta, L, H)
                    if abs(alpha[j] - aj) < 1e-7:
                        continue
                    alpha[i] = ai + y[i] * y[j] * (aj - alpha[j])
                    b1 = (
                        b
                        - Ei
                        - y[i] * (alpha[i] - ai) * K[i, i]
                        - y[j] * (alpha[j] - aj) * K[i, j]
                    )
                    b2 = (
                        b
                        - Ej
                        - y[i] * (alpha[i] - ai) * K[i, j]
                        - y[j] * (alpha[j] - aj) * K[j, j]
                    )
                    if 0 < alpha[i] < self.C:
                        b = b1
                    elif 0 < alpha[j] < self.C:
                        b = b2
                    else:
                        b = 0.5 * (b1 + b2)
                    changed += 1
            passes = passes + 1 if changed == 0 else 0

        sv = alpha > 1e-8
        self.alpha = alpha[sv]
        self.X = X[sv]
        self.y = y[sv]
        self.b = b
        return self

    def decision_function(self, X: np.ndarray) -> np.ndarray:
        X = np.asarray(X, dtype=np.float64)
        if self.X is None or len(self.X) == 0:
            return np.zeros(len(X))
        return (self.alpha * self.y) @ self._kfn(self.X, X) + self.b

    def predict(self, X: np.ndarray) -> np.ndarray:
        return np.where(self.decision_function(X) >= 0, 1, -1)
