"""Performance-prediction surrogate (paper §III-C, Tab. III).

Gradient-boosted regression trees + ridge regression, implemented from
scratch in numpy (no XGBoost offline) — same role as the paper's
"XGBoost/Regression/Decision Trees" ensemble.  Predicts
[throughput, memory, accuracy] from (configuration ⊕ graph statistics);
R² is reported per metric exactly as Tab. III.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np


# ---------------------------------------------------------------------------
# Regression tree (exact greedy, variance reduction)
# ---------------------------------------------------------------------------

@dataclass
class _Node:
    feature: int = -1
    thresh: float = 0.0
    left: int = -1
    right: int = -1
    value: float = 0.0


class RegressionTree:
    def __init__(self, max_depth=4, min_samples_leaf=4, n_thresholds=16):
        self.max_depth = max_depth
        self.min_leaf = min_samples_leaf
        self.n_thr = n_thresholds
        self.nodes: List[_Node] = []

    def fit(self, X, y):
        self.nodes = []
        self._build(X, y, 0)
        return self

    def _build(self, X, y, depth) -> int:
        idx = len(self.nodes)
        self.nodes.append(_Node(value=float(y.mean()) if len(y) else 0.0))
        if depth >= self.max_depth or len(y) < 2 * self.min_leaf or y.std() < 1e-12:
            return idx
        best = None  # (sse, f, thr, maskL)
        for f in range(X.shape[1]):
            col = X[:, f]
            qs = np.quantile(col, np.linspace(0.08, 0.92, self.n_thr))
            for thr in np.unique(qs):
                mL = col <= thr
                nL = mL.sum()
                if nL < self.min_leaf or len(y) - nL < self.min_leaf:
                    continue
                yL, yR = y[mL], y[~mL]
                sse = ((yL - yL.mean()) ** 2).sum() + ((yR - yR.mean()) ** 2).sum()
                if best is None or sse < best[0]:
                    best = (sse, f, float(thr), mL)
        if best is None:
            return idx
        _, f, thr, mL = best
        self.nodes[idx].feature = f
        self.nodes[idx].thresh = thr
        self.nodes[idx].left = self._build(X[mL], y[mL], depth + 1)
        self.nodes[idx].right = self._build(X[~mL], y[~mL], depth + 1)
        return idx

    def predict(self, X):
        out = np.empty(len(X))
        for i, x in enumerate(X):
            n = 0
            while self.nodes[n].feature >= 0:
                n = (self.nodes[n].left if x[self.nodes[n].feature]
                     <= self.nodes[n].thresh else self.nodes[n].right)
            out[i] = self.nodes[n].value
        return out


class GBDT:
    """Gradient-boosted trees (squared loss)."""

    def __init__(self, n_trees=60, lr=0.15, max_depth=4, min_samples_leaf=4,
                 seed=0):
        self.n_trees, self.lr = n_trees, lr
        self.kw = dict(max_depth=max_depth, min_samples_leaf=min_samples_leaf)
        self.trees: List[RegressionTree] = []
        self.base = 0.0

    def fit(self, X, y):
        X, y = np.asarray(X, float), np.asarray(y, float)
        self.base = float(y.mean())
        pred = np.full(len(y), self.base)
        self.trees = []
        for _ in range(self.n_trees):
            t = RegressionTree(**self.kw).fit(X, y - pred)
            pred += self.lr * t.predict(X)
            self.trees.append(t)
        return self

    def predict(self, X):
        X = np.asarray(X, float)
        pred = np.full(len(X), self.base)
        for t in self.trees:
            pred += self.lr * t.predict(X)
        return pred


class Ridge:
    def __init__(self, alpha=1.0):
        self.alpha = alpha

    def fit(self, X, y):
        X = np.hstack([np.asarray(X, float), np.ones((len(X), 1))])
        A = X.T @ X + self.alpha * np.eye(X.shape[1])
        self.w = np.linalg.solve(A, X.T @ np.asarray(y, float))
        return self

    def predict(self, X):
        X = np.hstack([np.asarray(X, float), np.ones((len(X), 1))])
        return X @ self.w


def r2_score(y_true, y_pred) -> float:
    y_true, y_pred = np.asarray(y_true, float), np.asarray(y_pred, float)
    ss_res = ((y_true - y_pred) ** 2).sum()
    ss_tot = ((y_true - y_true.mean()) ** 2).sum()
    return float(1.0 - ss_res / max(ss_tot, 1e-12))


# ---------------------------------------------------------------------------
# Multi-metric surrogate
# ---------------------------------------------------------------------------

METRICS = ("throughput", "memory", "accuracy")


class Surrogate:
    """One boosted-tree + ridge blend per metric (log-space for thr/mem)."""

    def __init__(self, seed: int = 0, n_trees: int = 60):
        self.models = {m: GBDT(n_trees=n_trees, seed=seed) for m in METRICS}
        self.linear = {m: Ridge() for m in METRICS}
        self.blend = 0.85
        self.log_space = {"throughput": True, "memory": True, "accuracy": False}

    def _tf(self, m, y):
        return np.log(np.maximum(y, 1e-9)) if self.log_space[m] else y

    def _itf(self, m, y):
        return np.exp(y) if self.log_space[m] else y

    def fit(self, X, Y: dict):
        for m in METRICS:
            y = self._tf(m, np.asarray(Y[m], float))
            self.models[m].fit(X, y)
            self.linear[m].fit(X, y)
        return self

    def predict(self, X) -> dict:
        out = {}
        for m in METRICS:
            y = (self.blend * self.models[m].predict(X)
                 + (1 - self.blend) * self.linear[m].predict(X))
            out[m] = self._itf(m, y)
        return out

    def r2(self, X, Y: dict) -> dict:
        pred = self.predict(X)
        return {m: r2_score(Y[m], pred[m]) for m in METRICS}
