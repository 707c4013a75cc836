"""Collectives over the host-simulated mesh (launch/mesh.py): the
multi-partition GNN path's gradient mean-all-reduce and bounded halo
exchange, the sequence-sharded decode attention with its softmax combine
(``flash_decode_attention``), and the analytic bytes of a quantized
all-reduce.

Only the host-simulated mesh is ported: every partition's tensors lie on
the trainer's one device, and each collective computes its result as the
JAX package's host-sim branch does — the same arithmetic in the same
order, so the mean is bit-equal to the JAX twin's on the CPU.  A real
multi-card mesh is refused where it is built (``make_partition_mesh``).
"""
from __future__ import annotations

import math
from typing import List

import numpy as np
import torch

from repro_torch.launch.mesh import MULTI_CARD, HostSimMesh, axis_sizes
from repro_torch.models.params import leaves, unflatten


def _host_sim(mesh):
    if not (mesh is None or isinstance(mesh, HostSimMesh)):
        raise NotImplementedError(f"collectives over {mesh!r}: {MULTI_CARD}")


def _partial_attend(q, k, v, mask):
    """Attention over one member's time slice.

    q (B, H, Dh); k/v (B, Tl, H, Dh); mask (B, Tl) True = valid.  Returns
    (o (B, H, Dh) f32, the numerator at the local max; m (B, H) the local
    max; denom (B, H) the local sum of exp)."""
    scores = torch.einsum("bhe,bthe->bht", q, k).float()
    scores = torch.where(mask[:, None, :], scores,
                         torch.full((), -1e30, device=q.device))
    m = scores.amax(dim=-1)                                  # (B, H)
    p = torch.exp(scores - m[..., None])
    p = torch.where(mask[:, None, :], p, torch.zeros((), device=q.device))
    denom = p.sum(dim=-1)                                    # (B, H)
    o = torch.einsum("bht,bthe->bhe", p.to(v.dtype), v)
    return o.float(), m, denom


def flash_decode_attention(mesh, axis: str = "model"):
    """Sequence-sharded single-token attention with a max-rescaled softmax
    combine, over the ``axis`` members of a host-simulated mesh.

    Returns ``fn(q, k, v, pos)``: q (B, H, Dh); the caches k/v (B, T, H,
    Dh), T split into one slice per member; pos (B,) each row's last valid
    position.  Each member attends over its slice with the ``(base + t) <=
    pos`` mask, then the partial (o, m, denom) combine in member order:
    the global max, each part rescaled to it, the numerators and the
    denominators summed.  Output (B, H, Dh) in v's dtype.  Plain torch, as
    the JAX package's is jnp: on a real mesh the combine's two sums are the
    only traffic (B·H·Dh, not the cache)."""
    _host_sim(mesh)
    n = axis_sizes(mesh)[axis]

    def attend(q, k, v, pos):
        T = k.shape[1]
        if T % n:
            raise ValueError(f"cache length {T} does not split into {n}")
        Tl = T // n
        parts = []
        for s in range(n):
            t = s * Tl + torch.arange(Tl, device=k.device)
            mask = t[None, :] <= pos[:, None]
            parts.append(_partial_attend(q, k[:, s * Tl:(s + 1) * Tl],
                                         v[:, s * Tl:(s + 1) * Tl], mask))
        g_max = parts[0][1]
        for _, m, _ in parts[1:]:
            g_max = torch.maximum(g_max, m)
        num = den = None
        for o, m, denom in parts:
            w = torch.exp(m - g_max)
            num = o * w[..., None] if num is None else num + o * w[..., None]
            den = denom * w if den is None else den + denom * w
        return (num / torch.clamp(den[..., None], min=1e-30)).to(v.dtype)
    return attend


def quantized_allreduce_bytes(shape, n_devices: int, bits: int = 8) -> float:
    """Analytic bytes a device sends in a ring all-reduce of a tensor of
    ``shape`` with a ``bits``-wide payload."""
    payload = float(math.prod(shape)) * bits / 8
    return 2.0 * payload * (n_devices - 1) / n_devices


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
