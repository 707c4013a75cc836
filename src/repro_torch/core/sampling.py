"""Locality-aware graph sampling (paper §III-A, Algo. 2).

Core mechanism: Efraimidis–Spirakis weighted reservoir sampling — key
k_j = u_j^{1/w_j}, keep the top-m keys.  Cached vertices get weight γ
(bias rate), uncached weight 1, so sampling is biased toward cache hits.

Two implementations with identical distribution:
  * ``reservoir_sample_ref``  — the paper's sequential Algo. 2 (oracle)
  * ``es_sample``             — vectorized keys + top-m (TPU-native shape;
    the Pallas kernel in kernels/reservoir mirrors this formulation)

``NeighborSampler`` builds multi-hop GraphSAGE-style blocks with fixed
fanout padding (static shapes → jit-friendly training batches).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import numpy as np

from repro_torch.graph.storage import Graph


def reservoir_sample_ref(neighbors: np.ndarray, weights: np.ndarray, m: int,
                         rng: np.random.Generator) -> np.ndarray:
    """Algo. 2 verbatim: sequential weighted reservoir sampling."""
    if len(neighbors) <= m:
        return neighbors.copy()
    res_items = list(neighbors[:m])
    keys = list(rng.random(m) ** (1.0 / weights[:m]))
    for j in range(m, len(neighbors)):
        k_j = rng.random() ** (1.0 / weights[j])
        t = int(np.argmin(keys))
        if k_j > keys[t]:
            res_items[t] = neighbors[j]
            keys[t] = k_j
    return np.asarray(res_items, dtype=neighbors.dtype)


def es_keys(weights: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Efraimidis–Spirakis keys u^{1/w} (log-space for stability)."""
    u = rng.random(weights.shape)
    return np.log(np.maximum(u, 1e-300)) / np.maximum(weights, 1e-12)


def es_sample(neighbors: np.ndarray, weights: np.ndarray, m: int,
              rng: np.random.Generator) -> np.ndarray:
    """Vectorized top-m by ES keys — same distribution as Algo. 2."""
    if len(neighbors) <= m:
        return neighbors.copy()
    keys = es_keys(weights, rng)
    top = np.argpartition(-keys, m - 1)[:m]
    return neighbors[top]


def hop_edges(indptr: np.ndarray, indices: np.ndarray, dst_ids: np.ndarray):
    """The neighbours of ``dst_ids`` laid end to end: ``(nb_all, row_start,
    sizes)``, row ``i``'s being ``nb_all[row_start[i]:][:sizes[i]]``."""
    starts = indptr[dst_ids]
    sizes = (indptr[dst_ids + 1] - starts).astype(np.int64)
    total = int(sizes.sum())
    row_start = np.cumsum(sizes) - sizes
    offs = np.repeat(starts, sizes) + (np.arange(total)
                                       - np.repeat(row_start, sizes))
    return indices[offs], row_start, sizes


def topm_buckets(sizes: np.ndarray, row_start: np.ndarray,
                 fanout: int) -> list:
    """The rows with more than ``fanout`` neighbours (those that go to top-m
    selection), bucketed by power-of-two padded width, narrowest first: a
    list of ``(rs, src, valid)``, ``rs`` the bucket's row numbers, ``src``
    (len(rs), width) positions in ``nb_all`` (a row's last neighbour
    repeated past its end) and ``valid`` the mask ``col < size``."""
    rows = np.where(sizes > fanout)[0]
    widths = 1 << np.ceil(np.log2(sizes[rows])).astype(int)
    out = []
    for w in np.unique(widths):
        rs = rows[widths == w]
        col = np.arange(w)
        valid = col[None, :] < sizes[rs, None]
        src = row_start[rs, None] + np.minimum(col[None, :],
                                               sizes[rs, None] - 1)
        out.append((rs, src, valid))
    return out


@dataclass
class Block:
    """One hop: bipartite (src → dst) with fixed-fanout padding.

    ``neigh_idx[i, f]`` indexes ``src_ids``; -1 = padded slot."""
    src_ids: np.ndarray      # (n_src,) global node ids (dst ids are a prefix)
    dst_ids: np.ndarray      # (n_dst,)
    neigh_idx: np.ndarray    # (n_dst, fanout) int32, -1 padded


@dataclass
class MiniBatch:
    blocks: List[Block]          # input-hop first
    input_ids: np.ndarray        # node ids needing features (== blocks[0].src_ids)
    seeds: np.ndarray            # (batch,)
    labels: np.ndarray           # (batch,)
    features: Optional[np.ndarray] = None   # filled by batch generation
    # (stays None under GNNConfig.fused_gather_agg — the trainer resolves
    # the input hop at step time through FeaturePlane.fused_inputs)
    # graph topology version the batch was sampled at (dynamic graphs:
    # lets downstream consumers detect batches drawn before a mutation)
    topology_version: int = -1

    def num_input_nodes(self) -> int:
        return len(self.input_ids)


class NeighborSampler:
    """Multi-hop locality-aware sampler.

    ``weight_fn(ids) -> weights`` implements the bias: γ for cached ids,
    1 otherwise (see core/locality.py).  ``use_reference=True`` switches to
    the sequential Algo. 2 oracle (tests)."""

    def __init__(self, graph: Graph, fanouts: Sequence[int],
                 weight_fn: Optional[Callable[[np.ndarray], np.ndarray]] = None,
                 seed: int = 0, use_reference: bool = False):
        self.g = graph
        self.fanouts = tuple(fanouts)
        self.weight_fn = weight_fn
        self.rng = np.random.default_rng(seed)
        self.use_reference = use_reference

    def _sample_one_hop(self, dst_ids: np.ndarray, fanout: int) -> np.ndarray:
        """Returns sampled (n_dst, fanout) global ids with -1 pad."""
        g = self.g
        # both paths read through the merged base+overlay view, so edge
        # mutations are visible to the very next hop; for a frozen graph
        # adj() returns the base arrays untouched (bit-exact with the old
        # direct reads)
        indptr, indices = g.adj()
        out = -np.ones((len(dst_ids), fanout), dtype=np.int64)
        if self.use_reference:
            for i, v in enumerate(dst_ids):
                nb = indices[indptr[v]:indptr[v + 1]]
                if len(nb) == 0:
                    continue
                w = (np.ones(len(nb)) if self.weight_fn is None
                     else self.weight_fn(nb))
                picked = reservoir_sample_ref(nb, w, min(fanout, len(nb)),
                                              self.rng)
                out[i, :len(picked)] = picked
            return out
        # vectorized ES: one key computation over all edges of the hop, then
        # BUCKETED batched top-m (rows grouped by padded width) — all work is
        # large numpy ops that release the GIL, so sampler threads scale
        # (the host-side twin of the kernels/reservoir TPU formulation).
        nb_all, row_start, sizes = hop_edges(indptr, indices, dst_ids)
        if len(nb_all) == 0:
            return out

        # rows with ≤ fanout neighbors: take everything (no keys needed)
        small = sizes <= fanout
        if small.any():
            rs = np.where(small)[0]
            w = int(sizes[rs].max()) if len(rs) else 0
            if w > 0:
                col = np.arange(w)
                valid = col[None, :] < sizes[rs, None]
                src = row_start[rs, None] + np.minimum(col[None, :],
                                                       sizes[rs, None] - 1)
                block = nb_all[src]
                row_idx = np.broadcast_to(rs[:, None], valid.shape)
                col_idx = np.broadcast_to(col[None, :], valid.shape)
                out[row_idx[valid], col_idx[valid]] = block[valid]

        buckets = topm_buckets(sizes, row_start, fanout)
        if buckets:
            w_all = (np.ones(len(nb_all)) if self.weight_fn is None
                     else self.weight_fn(nb_all))
            keys = es_keys(w_all, self.rng)
            for rs, src, valid in buckets:
                km = np.where(valid, keys[src], -np.inf)
                top = np.argpartition(-km, fanout - 1, axis=1)[:, :fanout]
                out[rs[:, None], np.arange(fanout)[None, :]] = (
                    nb_all[np.take_along_axis(src, top, axis=1)])
        return out

    def sample(self, seeds: np.ndarray) -> MiniBatch:
        seeds = np.asarray(seeds, dtype=np.int64)
        blocks: List[Block] = []
        dst = seeds
        for fanout in self.fanouts:           # hop 1 = nearest to output
            nbrs = self._sample_one_hop(dst, fanout)
            # src set = dst ∪ sampled, with dst occupying the prefix positions
            valid = nbrs >= 0
            flat = nbrs[valid]
            src_sorted, inv = np.unique(np.concatenate([dst, flat]),
                                        return_inverse=True)
            dst_pos = inv[:len(dst)]                      # dst are unique
            in_dst = np.zeros(len(src_sorted), bool)
            in_dst[dst_pos] = True
            order = np.concatenate([dst_pos, np.where(~in_dst)[0]])
            src_ids = src_sorted[order]
            new_pos = np.empty(len(src_sorted), np.int32)
            new_pos[order] = np.arange(len(src_sorted), dtype=np.int32)
            neigh_idx = -np.ones_like(nbrs, dtype=np.int32)
            if valid.any():
                neigh_idx[valid] = new_pos[np.searchsorted(src_sorted, flat)]
            blocks.append(Block(src_ids=src_ids.astype(np.int64),
                                dst_ids=dst.astype(np.int64),
                                neigh_idx=neigh_idx))
            dst = src_ids
        blocks.reverse()                      # input hop first
        return MiniBatch(blocks=blocks, input_ids=blocks[0].src_ids,
                         seeds=seeds, labels=self.g.labels[seeds],
                         topology_version=self.g.topology_version)


def seed_loader(graph: Graph, batch_size: int, seed: int = 0,
                mask: Optional[np.ndarray] = None):
    """Iterate shuffled train-seed batches (drop last partial)."""
    ids = np.where(graph.train_mask if mask is None else mask)[0]
    rng = np.random.default_rng(seed)
    perm = rng.permutation(ids)
    for i in range(0, len(perm) - batch_size + 1, batch_size):
        yield perm[i:i + batch_size].astype(np.int64)
