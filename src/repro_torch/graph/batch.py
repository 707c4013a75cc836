"""Batch generation (Algo. 1 lines 9-10): dedup → reindex → feature retrieve.

Locality-aware sampling concentrates repeated node ids, so deduplication
shrinks the mini-batch substantially (the paper's memory win).  Features for
the input hop are fetched THROUGH the feature plane — the single
backend-pluggable seam (core/feature_plane.py) whose host backend wraps the
cache (hit/miss accounting feeds both throughput and the bias feedback
loop) and whose device backend runs the Pallas cache gather.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Optional, Sequence, Union

import numpy as np

from repro_torch.core.cache import FeatureCache
from repro_torch.core.sampling import MiniBatch

if TYPE_CHECKING:  # typing-only: the graph layer stays jax-free at runtime
    from repro_torch.core.feature_plane import FeaturePlane


def generate_batch(mb: MiniBatch,
                   plane: Optional[Union["FeaturePlane", FeatureCache]],
                   graph, fused: bool = False) -> MiniBatch:
    """Fill ``mb.features`` for the input hop (dedup already done by the
    sampler's np.unique reindexing).  ``plane`` is a ``FeaturePlane`` (the
    hot path) or, for back-compat, a bare ``FeatureCache``; ``None`` reads
    the host store directly (evaluation paths).

    ``fused=True`` (``GNNConfig.fused_gather_agg``) DEFERS the feature
    work entirely: the batch is returned with ``features=None`` and the
    trainer resolves the input hop at step time through
    ``FeaturePlane.fused_inputs`` (encoded slots + miss sideband) — the
    (n_src0, F) input tensor never materializes, and encoding at step
    time means the slot references can never go stale between batch
    generation and the jitted step consuming them."""
    if fused and plane is not None and mb.blocks:
        return mb
    if plane is not None:
        feats = plane.fetch(mb.input_ids)
    else:
        feats = graph.features[mb.input_ids]
    return dataclasses.replace(mb, features=feats)


def compute_level_caps(batch: int, fanouts: Sequence[int],
                       num_nodes: int) -> list:
    """Fixed per-node-level caps (input-hop first, same order as
    ``batch_device_arrays`` ``sizes``): level i+1 can grow at most
    ``(1 + fanout)`` over level i (dst ∪ sampled, dedup only shrinks),
    and never beyond the graph.  One cap vector → ONE jit signature per
    (model, level_caps) across the whole batch-size schedule — the
    serving engines and the all-hop fused train step share this
    discipline (and therefore share compiled signatures)."""
    caps = [int(batch)]
    for f in fanouts:
        caps.append(min(caps[-1] * (1 + int(f)), int(num_nodes)))
    caps.reverse()                            # input-hop level first
    return caps


def _pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def batch_device_arrays(mb: MiniBatch, pad_seed_level: bool = False,
                        level_caps: Optional[Sequence[int]] = None):
    """Convert to jit-friendly arrays with CHAINED padding.

    Invariant required by models/gnn.py: the padded dst count of hop i equals
    the padded src count of hop i+1 (dst_ids ARE the prefix of the next hop's
    src_ids, so one pad size per node level).  Padded neighbor rows are -1
    (masked out); padded feature rows are zero.

    Three padding regimes per node level:

      * default — pow2 buckets, seeds exact (training: the seed count is
        the constant ``batch_size``, hop sizes drift within a few buckets
        and the retraces amortize over a long run);
      * ``pad_seed_level`` — seeds pow2-bucket too (a serving engine
        admits 1..batch seeds per step);
      * ``level_caps`` — every level pads to a FIXED cap (input-hop
        first, same order as ``sizes``): ONE jit signature ever, for
        latency-SLO serving where a single ~250 ms mid-sweep retrace
        stalls the fabric long enough to age out its whole queue.

    Padded rows are inert either way: they reference only masked −1
    neighbors, so real logits never see them."""
    n_levels = len(mb.blocks) + 1
    # level sizes: [n_src_hop0, n_dst_hop0 == n_src_hop1, ..., n_seeds]
    sizes = [len(mb.blocks[0].src_ids)] + [len(b.dst_ids) for b in mb.blocks]
    if level_caps is not None:
        if len(level_caps) != n_levels:
            raise ValueError(f"level_caps has {len(level_caps)} entries "
                             f"for {n_levels} node levels")
        pads = [max(int(c), s) for c, s in zip(level_caps, sizes)]
    else:
        pads = [_pow2(s) for s in sizes]
        if not pad_seed_level:
            pads[-1] = sizes[-1]                # seeds: exact batch size
    neigh_idxs = []
    for i, blk in enumerate(mb.blocks):
        pad_dst = pads[i + 1]
        m = -np.ones((pad_dst, blk.neigh_idx.shape[1]), np.int32)
        m[:blk.neigh_idx.shape[0]] = blk.neigh_idx
        neigh_idxs.append(m)
    out = {
        "neigh_idxs": neigh_idxs,
        "labels": mb.labels.astype(np.int32),
        "sizes": sizes,
        "pads": pads,
        # sampled-at topology version rides along (dynamic graphs:
        # consumers can audit which adjacency a batch was drawn from)
        "topology_version": mb.topology_version,
    }
    if mb.features is None:
        # deferred fused batch (generate_batch(fused=True)): the input
        # hop is resolved at step time via FeaturePlane.fused_inputs
        # against pads[0] — no feature tensor rides the batch
        return out
    feats = mb.features
    fpad = np.zeros((pads[0], feats.shape[1]), feats.dtype)
    fpad[:sizes[0]] = feats
    out["features"] = fpad
    return out


def inference_arrays(mb: MiniBatch,
                     level_caps: Optional[Sequence[int]] = None):
    """Forward-only view of ``batch_device_arrays`` for the serving path
    (serve/gnn_engine.py): same chained-padding invariant, no labels.
    With ``level_caps`` (the engines pass their precomputed per-level
    maxima) every step has ONE fixed shape — serving admits a varying
    seed count per step AND hop sizes vary with which seeds get
    co-batched, so shape-following pads retrace jit mid-serving (~250 ms
    each on this container, long enough that a latency-SLO fabric ages
    out its whole queue).  The engine reads only the real-seed prefix of
    the logits."""
    arrays = batch_device_arrays(mb, pad_seed_level=True,
                                 level_caps=level_caps)
    return {"features": arrays["features"],
            "neigh_idxs": arrays["neigh_idxs"],
            "sizes": arrays["sizes"]}


def batch_bytes(mb: MiniBatch) -> int:
    """B term of Eq. (3): bytes of the generated mini-batch."""
    total = mb.features.nbytes if mb.features is not None else 0
    for blk in mb.blocks:
        total += blk.neigh_idx.nbytes + blk.src_ids.nbytes + blk.dst_ids.nbytes
    return total + mb.labels.nbytes
