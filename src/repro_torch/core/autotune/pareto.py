"""Pareto-front extraction + T*/M*/balanced selection + grid-search baseline.

The paper reads T* (max throughput) and M* (min memory) off the two ends of
the Pareto front (Tab. II) and reports PPO exploring ~2.1× faster than grid
search for equal-quality configurations.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import numpy as np

from repro_torch.core.autotune.space import Space


def pareto_front(points: np.ndarray) -> np.ndarray:
    """Indices of non-dominated points.  Convention: every column is
    maximized (negate memory before calling)."""
    n = len(points)
    keep = np.ones(n, bool)
    for i in range(n):
        if not keep[i]:
            continue
        dom = np.all(points >= points[i], axis=1) & np.any(points > points[i],
                                                           axis=1)
        if dom.any():
            keep[i] = False
    return np.where(keep)[0]


def front_from_history(history) -> List[int]:
    """history: list of (cfg, metrics, reward)."""
    pts = np.array([[m["throughput"], -m["memory"], m["accuracy"]]
                    for _, m, _ in history])
    return list(pareto_front(pts))


def select_endpoints(history) -> Dict[str, Tuple[Dict, Dict]]:
    """T* / M* / balanced configurations off the Pareto front."""
    idx = front_from_history(history)
    front = [history[i] for i in idx]
    t_star = max(front, key=lambda h: h[1]["throughput"])
    m_star = min(front, key=lambda h: h[1]["memory"])

    # balanced: max normalized geometric trade-off
    thr = np.array([h[1]["throughput"] for h in front])
    mem = np.array([h[1]["memory"] for h in front])
    acc = np.array([h[1]["accuracy"] for h in front])
    thr_n = (thr - thr.min()) / max(np.ptp(thr), 1e-9)
    mem_n = 1.0 - (mem - mem.min()) / max(np.ptp(mem), 1e-9)
    acc_n = (acc - acc.min()) / max(np.ptp(acc), 1e-9)
    bal = front[int(np.argmax(thr_n + mem_n + acc_n))]
    return {"T*": (t_star[0], t_star[1]), "M*": (m_star[0], m_star[1]),
            "balanced": (bal[0], bal[1])}


def grid_search(space: Space, evaluate: Callable[[Dict], Dict],
                reward: Callable[[Dict], float], points_per_dim: int = 3,
                target: float | None = None):
    """Full-factorial baseline.  Returns (best_cfg, best_reward, evals,
    evals_to_target)."""
    grid = space.grid(points_per_dim)
    best_cfg, best_r = None, -np.inf
    evals_to_target = None
    for i, u in enumerate(grid):
        cfg = space.decode(u)
        r = reward(evaluate(cfg))
        if r > best_r:
            best_r, best_cfg = r, cfg
        if target is not None and evals_to_target is None and r >= target:
            evals_to_target = i + 1
    return best_cfg, best_r, len(grid), evals_to_target
