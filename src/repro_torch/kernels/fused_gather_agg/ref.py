"""Plain PyTorch version of the fused gather + aggregate: the CPU path and
the oracle the CUDA kernel is held against.  Resolve the encoded slots
against (table, aux), take the dst prefix, and aggregate with the
segment-agg plain version (``mean`` for GraphSAGE/GCN layer 0, ``sum`` for
GIN layer 0), as the JAX package's ``fused_gather_agg/ref.py`` does."""
from __future__ import annotations

import torch

from repro_torch.kernels.segment_agg.ref import neighbor_agg_ref


def resolve_rows_ref(enc, table, aux):
    """Encoded-slot resolve: ``enc[i] >= 0`` → table slot, ``enc[i] < 0``
    → row ``-enc[i]-1`` of the ``aux`` sideband.  Out-of-range slots clamp,
    as the JAX gather does."""
    e = enc.long()
    hit = e >= 0
    rows_t = table[e.clamp(0, table.shape[0] - 1)]
    rows_a = aux[(-e - 1).clamp(0, aux.shape[0] - 1)]
    return torch.where(hit[:, None], rows_t, rows_a)


def gather_aggregate_ref(enc, neigh_idx, table, aux, mode: str = "mean"):
    rows = resolve_rows_ref(enc, table, aux)
    h_dst = rows[:neigh_idx.shape[0]]
    return h_dst, neighbor_agg_ref(neigh_idx, rows, mode=mode)
