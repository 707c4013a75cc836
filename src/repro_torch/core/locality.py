"""Locality policy: bias-rate weighting + the Eq. (1) accuracy-drop model.

``ΔA = f1(η, γ, d(G), Θ)`` — fitted on profiled runs (the auto-tuner's
surrogate consumes the same features); the closed form below encodes the
paper's qualitative claims: ΔA grows with γ, is damped by cache volume Θ
and graph density d(G), and grows as partition overlap η shrinks.
"""
from __future__ import annotations

from typing import Callable

import numpy as np

from repro_torch.core.cache import FeatureCache


def bias_weight_fn(cache: FeatureCache, gamma: float) -> Callable[[np.ndarray], np.ndarray]:
    """w(v) = γ if v cached else 1 (paper §III-A: higher weight → higher
    selection probability in the weighted reservoir)."""
    def fn(ids: np.ndarray) -> np.ndarray:
        return np.where(cache.device_map[ids] >= 0, float(gamma), 1.0)
    return fn


def accuracy_drop_model(eta: float, gamma: float, density: float,
                        cache_frac: float,
                        a=0.012, b=0.25, c=40.0, d=0.03) -> float:
    """ΔA (fraction, e.g. 0.01 = 1 point) — Eq. (1) closed form.

    * γ=1 → no drop from biasing (reverts to uniform sampling)
    * larger cache (Θ) ⇒ biased set covers more of the graph ⇒ smaller drop
    * denser graphs are more robust (paper: "robust graph topology")
    * partitioning (η<1) adds a separate loss term
    """
    bias_term = a * np.log(max(gamma, 1.0)) / (1.0 + b * cache_frac * 100.0)
    density_damp = 1.0 / (1.0 + c * density * 1e3)
    part_term = d * (1.0 - eta)
    return float(bias_term * density_damp + part_term)


def edge_locality_score(g, owner: np.ndarray) -> float:
    """Fraction of edges whose endpoints share a partition under ``owner``
    (node → partition id).  This is the objective the locality-aware
    partitioner maximizes: every cross-partition edge is a potential halo
    fetch, and 1 − score is the cut ratio that shrinks η in Eq. (1)."""
    src = np.repeat(np.arange(g.num_nodes), np.diff(g.indptr))
    if len(src) == 0:
        return 1.0
    return float((owner[src] == owner[g.indices]).mean())


def expected_hit_rate(cache_frac: float, gamma: float,
                      skew: float = 0.8) -> float:
    """Analytic hit-rate model used by the surrogate's feature set.

    Static hotness caching on a power-law graph already captures ``skew`` of
    traffic at small cache fractions; biasing multiplies the odds of picking
    a cached neighbor by γ."""
    base = skew * cache_frac ** 0.25 if cache_frac > 0 else 0.0
    base = min(base, 0.95)
    odds = base / max(1.0 - base, 1e-9) * gamma
    return odds / (1.0 + odds)
