"""Collectives of the multi-partition GNN path over the partition mesh
(launch/mesh.py): the gradient mean-all-reduce and the bounded halo
exchange.

Only the host-simulated mesh is ported: every partition's tensors lie on
the trainer's one device, and each collective computes its result as the
JAX package's host-sim branch does — the same arithmetic in the same
order, so the mean is bit-equal to the JAX twin's on the CPU.  A real
multi-card mesh is refused where it is built (``make_partition_mesh``).
"""
from __future__ import annotations

from typing import List

import numpy as np

from repro_torch.launch.mesh import MULTI_CARD, HostSimMesh
from repro_torch.models.params import leaves, unflatten


def _host_sim(mesh):
    if not (mesh is None or isinstance(mesh, HostSimMesh)):
        raise NotImplementedError(f"collectives over {mesh!r}: {MULTI_CARD}")


def grad_allreduce(mesh):
    """Mean-all-reduce over per-partition gradient trees (data-parallel GNN
    scale-out, core/multipart.py).

    Returns ``fn(trees) -> tree`` averaging a list of identically-structured
    gradient trees, one per partition: ``sum(xs) / n`` leaf by leaf, summed
    in partition order."""
    _host_sim(mesh)

    def host_mean(trees: List):
        n = float(len(trees))
        if len(trees) == 1:
            return trees[0]
        return unflatten(trees[0], [sum(xs) / n for xs in
                                    zip(*map(leaves, trees), strict=True)])
    return host_mean


def _routing(plan):
    """Global→local index map plus, per (src q → dst p) pair, the rows
    q sends (q-local ids) and where p scatters them (halo positions)."""
    parts = plan.parts
    loc = np.zeros(len(plan.owner), np.int64)
    for ns in plan.node_sets:
        loc[ns] = np.arange(len(ns))
    send = [[None] * parts for _ in range(parts)]   # send[q][p]
    put = [[None] * parts for _ in range(parts)]    # put[p][q]
    for p, hs in enumerate(plan.halo_sets):
        owners = plan.owner[hs] if len(hs) else np.zeros(0, np.int32)
        for q in range(parts):
            pos = np.where(owners == q)[0]
            send[q][p] = loc[hs[pos]]
            put[p][q] = pos
    return send, put


def _volume(plan, feat_dim: int) -> int:
    return plan.halo_rows * feat_dim * 4


def halo_all_to_all(mesh):
    """Bounded halo-feature exchange over the partition mesh.

    Returns ``fn(plan, part_feats) -> (halo_feats, volume_bytes)`` where
    ``part_feats[p]`` are partition p's OWNED feature rows in local order
    and ``halo_feats[p]`` are the rows for ``plan.halo_sets[p]`` in halo
    order — every row is owned by another partition, so all of them cross
    a boundary (``volume_bytes`` counts exactly that traffic, the HitGNN
    inter-device term the ``halo_budget`` knob caps).  The routing runs as
    host-side numpy gathers, row for row those of the JAX package."""
    _host_sim(mesh)

    def host_exchange(plan, part_feats):
        send, put = _routing(plan)
        halo_feats = []
        for p, hs in enumerate(plan.halo_sets):
            rows = np.zeros((len(hs), part_feats[p].shape[1]), np.float32)
            for q in range(plan.parts):
                if len(put[p][q]):
                    rows[put[p][q]] = part_feats[q][send[q][p]]
            halo_feats.append(rows)
        return halo_feats, _volume(plan, part_feats[0].shape[1])
    return host_exchange
