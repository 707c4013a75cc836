"""Plain PyTorch versions of the masked neighbour aggregation and its
gradient: the CPU path and the oracles the CUDA kernels are held against.

``neighbor_agg_ref`` repeats the expressions of the JAX package's
``segment_agg/ref.py``.  ``neighbor_agg_bwd_ref`` writes the gradient out
explicitly (an ``index_add_`` scatter of the scaled output gradient, and a
row dot product for the weights); it is not autograd of the forward.
"""
from __future__ import annotations

import torch


def _check_mode(mode: str, weights):
    if weights is not None and mode != "sum":
        # attention weights are already normalized (a softmax over the edge
        # set): the weighted family is the SUM, as in the JAX package
        raise ValueError("per-edge weights imply mode='sum'")
    if mode not in ("mean", "sum"):
        raise ValueError(f"unknown aggregation mode: {mode!r}")


def _safe(neigh_idx, ns: int):
    # -1 pads read row 0 (masked); indices past Ns clamp, as the JAX gather does
    return neigh_idx.clamp(0, ns - 1).long()


def _count(mask, dtype):
    return mask.sum(-1, keepdim=True).clamp(min=1).to(dtype)


def neighbor_agg_ref(neigh_idx, h_src, mode: str = "mean", weights=None):
    """neigh_idx (Nd, fanout) int (−1 pad); h_src (Ns, D); weights
    (Nd, fanout) or None → (Nd, D)."""
    _check_mode(mode, weights)
    mask = neigh_idx >= 0
    nb = h_src[_safe(neigh_idx, h_src.shape[0])]
    nb = nb * mask[..., None].to(h_src.dtype)
    if weights is not None:
        nb = nb * weights[..., None].to(h_src.dtype)
    if mode == "sum":
        return nb.sum(1)
    return nb.sum(1) / _count(mask, h_src.dtype)


def neighbor_agg_bwd_ref(neigh_idx, dout, h_src, mode: str = "mean",
                         weights=None):
    """Gradient of ``neighbor_agg_ref`` for an output gradient ``dout``
    (Nd, D): ``(dh_src (Ns, D), dw (Nd, fanout) or None)``.

    ``dh_src[idx[r, f]] += s · dout[r]`` over the valid entries, with
    ``s = 1/cnt_r`` (mean), ``1`` (sum) or ``weights[r, f]`` (weighted);
    ``dw[r, f] = ⟨dout[r], h_src[idx[r, f]]⟩`` where valid, else 0."""
    _check_mode(mode, weights)
    ns, d = h_src.shape
    mask = neigh_idx >= 0
    if mode == "mean" and weights is None:
        g = (dout / _count(mask, dout.dtype))[:, None, :]
    elif weights is not None:
        g = dout[:, None, :] * weights[..., None].to(dout.dtype)
    else:
        g = dout[:, None, :]
    g = g.expand(*neigh_idx.shape, d)
    dh = torch.zeros((ns, d), dtype=h_src.dtype, device=h_src.device)
    dh.index_add_(0, neigh_idx[mask].long().clamp(max=ns - 1), g[mask])
    dw = None
    if weights is not None:
        nb = h_src[_safe(neigh_idx, ns)]
        dw = torch.where(mask, (dout[:, None, :] * nb).sum(-1),
                         torch.zeros((), dtype=dout.dtype, device=dout.device))
    return dh, dw
