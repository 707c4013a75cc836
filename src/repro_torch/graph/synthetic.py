"""Synthetic power-law graph generators (offline stand-ins for OGB).

The container has no dataset downloads, so every paper dataset gets a
synthetic twin with matched *statistics*: node/edge counts (scaled), a
power-law degree distribution with the dataset's exponent, homophilous
community structure (labels correlate with topology — so locality-biased
sampling has a real accuracy effect to measure), and features drawn from
class-conditional Gaussians (so a GNN actually learns).
"""
from __future__ import annotations


import numpy as np

from repro_torch.graph.storage import Graph, from_edges


def powerlaw_graph(num_nodes: int, num_edges: int, power_exp: float = 2.1,
                   feat_dim: int = 100, num_classes: int = 16,
                   homophily: float = 0.7, seed: int = 0,
                   name: str = "synthetic") -> Graph:
    """Chung–Lu style power-law graph with community structure.

    Expected degree of node i ∝ i^{-1/(power_exp-1)}; edges are drawn with
    probability ∝ w_i·w_j, then rewired toward same-class targets with
    probability ``homophily``.
    """
    rng = np.random.default_rng(seed)
    n, m = num_nodes, num_edges

    # class assignment (balanced-ish communities)
    labels = rng.integers(0, num_classes, size=n).astype(np.int32)
    # order nodes by community so class-local edge sampling is cheap
    order = np.argsort(labels, kind="stable")
    labels = labels[order]
    class_start = np.searchsorted(labels, np.arange(num_classes))
    class_end = np.searchsorted(labels, np.arange(num_classes), side="right")

    # Chung–Lu weights (power-law ranks, shuffled so hot nodes span classes)
    ranks = np.arange(1, n + 1, dtype=np.float64)
    w = ranks ** (-1.0 / (power_exp - 1.0))
    rng.shuffle(w)
    p = w / w.sum()

    src = rng.choice(n, size=m, p=p).astype(np.int32)
    dst_global = rng.choice(n, size=m, p=p).astype(np.int32)

    # homophilous rewiring: with prob `homophily`, redirect dst into src's class
    flip = rng.random(m) < homophily
    src_cls = labels[src]
    lo = class_start[src_cls]
    hi = class_end[src_cls]
    same_class_dst = (lo + (rng.random(m) * np.maximum(hi - lo, 1)).astype(np.int64))
    dst = np.where(flip, same_class_dst.astype(np.int32), dst_global)

    # self-loop removal (redirect to (v+1) mod n)
    self_loop = src == dst
    dst = np.where(self_loop, (dst + 1) % n, dst)

    # class-conditional Gaussian features
    centers = rng.normal(0, 1.0, size=(num_classes, feat_dim)).astype(np.float32)
    feats = centers[labels] + rng.normal(0, 2.0, size=(n, feat_dim)).astype(np.float32)

    return from_edges(n, src, dst, feats, labels, seed=seed, name=name)


def dataset_like(cfg, seed: int = 0) -> Graph:
    """Build the synthetic twin described by a GNNConfig."""
    return powerlaw_graph(
        num_nodes=cfg.num_nodes, num_edges=cfg.num_edges,
        power_exp=cfg.power_exp, feat_dim=cfg.feat_dim,
        num_classes=cfg.num_classes, seed=seed,
        name=cfg.name.replace("graphsage-", ""))
