"""GNN models over sampled blocks: GraphSAGE (mean), GCN, GAT, GIN.

Blocks use fixed-fanout padded neighbor matrices (core/sampling.py), so
every hop is a dense masked gather + matmul.  This is the unfused form of
the JAX package's models/gnn.py: the gathered-neighbor tensor
(``_gather_neighbors``) is materialized and reduced, and autograd
differentiates it — no kernel runs in the model, so no backward kernel is
needed.  The fused forms (``segment_agg``, ``fused_gather_agg``) are not
ported yet.

Parameters are plain dicts of tensors, ``{"layers": [{name: tensor}]}``,
in the JAX package's layout: weights are ``(din, dout)`` and a layer
computes ``h @ W``, so ``models/convert.py`` maps them by name.
"""
from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.params import decl, leaves, unflatten

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def layer_dims(cfg) -> List[Tuple[int, int]]:
    dims = [cfg.feat_dim] + [cfg.hidden] * (cfg.num_layers - 1) + [cfg.num_classes]
    return list(zip(dims[:-1], dims[1:]))


def decls_gnn(cfg):
    layers = []
    for (din, dout) in layer_dims(cfg):
        if cfg.model == "graphsage":
            layers.append({"w_self": decl((din, dout)),
                           "w_neigh": decl((din, dout)),
                           "b": decl((dout,), init="zeros")})
        elif cfg.model == "gcn":
            layers.append({"w": decl((din, dout)),
                           "b": decl((dout,), init="zeros")})
        elif cfg.model == "gat":
            layers.append({"w": decl((din, dout)),
                           "a_src": decl((dout,), scale=0.1, init="normal"),
                           "a_dst": decl((dout,), scale=0.1, init="normal"),
                           "b": decl((dout,), init="zeros")})
        elif cfg.model == "gin":
            layers.append({"eps": decl((1,), init="zeros"),
                           "w1": decl((din, dout)),
                           "b1": decl((dout,), init="zeros"),
                           "w2": decl((dout, dout)),
                           "b2": decl((dout,), init="zeros")})
        else:
            raise ValueError(cfg.model)
    return {"layers": layers}


def _gather_neighbors(h_src, neigh_idx):
    """h_src (Ns,D), neigh_idx (Nd,F) with -1 pad → (nb (Nd,F,D), mask)."""
    mask = neigh_idx >= 0
    nb = h_src[neigh_idx.clamp(min=0).long()]
    return nb * mask[..., None].to(h_src.dtype), mask


def _count(mask, dtype):
    return mask.sum(-1, keepdim=True).clamp(min=1).to(dtype)


def _mean_agg(h_src, neigh_idx):
    nb, mask = _gather_neighbors(h_src, neigh_idx)
    return nb.sum(1) / _count(mask, h_src.dtype)


def _sum_agg(h_src, neigh_idx):
    nb, _ = _gather_neighbors(h_src, neigh_idx)
    return nb.sum(1)


def sage_layer(p, h_src, neigh_idx, *, act=True):
    h_dst = h_src[:neigh_idx.shape[0]]
    agg = _mean_agg(h_src, neigh_idx)
    out = h_dst @ p["w_self"] + agg @ p["w_neigh"] + p["b"]
    return F.relu(out) if act else out


def gcn_layer(p, h_src, neigh_idx, *, act=True):
    # sampled-mean approximation of sym-normalized aggregation incl. self-loop
    h_dst = h_src[:neigh_idx.shape[0]]
    agg = _mean_agg(h_src, neigh_idx)
    cnt = _count(neigh_idx >= 0, h_dst.dtype)
    z = (agg * cnt + h_dst) / (cnt + 1.0)
    out = z @ p["w"] + p["b"]
    return F.relu(out) if act else out


def gin_layer(p, h_src, neigh_idx, *, act=True):
    h_dst = h_src[:neigh_idx.shape[0]]
    z = (1.0 + p["eps"]) * h_dst + _sum_agg(h_src, neigh_idx)
    out = F.relu(z @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]
    return F.relu(out) if act else out


def gat_layer(p, h_src, neigh_idx, *, act=True):
    n_dst = neigh_idx.shape[0]
    z_src = h_src @ p["w"]                               # (Ns,D')
    z_dst = z_src[:n_dst]
    nb, mask = _gather_neighbors(z_src, neigh_idx)       # (Nd,F,D')
    e = F.leaky_relu(nb @ p["a_src"] + (z_dst @ p["a_dst"])[:, None],
                     negative_slope=0.2)
    e = e.masked_fill(~mask, -1e30)
    # include the self edge in the softmax (jax.nn.leaky_relu's 0.01 slope)
    e_self = F.leaky_relu(z_dst @ (p["a_src"] + p["a_dst"]))[:, None]
    alla = torch.softmax(torch.cat([e, e_self], dim=1), dim=1)
    agg = torch.einsum("nf,nfd->nd", alla[:, :-1], nb) + alla[:, -1:] * z_dst
    out = agg + p["b"]
    return F.elu(out) if act else out


_LAYER_FNS = {"graphsage": sage_layer, "gcn": gcn_layer, "gat": gat_layer,
              "gin": gin_layer}


def gnn_forward(params, features, neigh_idxs, cfg):
    """features (pad_src0, F); neigh_idxs[i] (pad_dst_i, fanout_i) with the
    chained-padding invariant pad_dst_i == pad_src_{i+1}."""
    fn = _LAYER_FNS[cfg.model]
    h = features.to(_DTYPES[cfg.compute_dtype])
    n = len(params["layers"])
    for i, (p, idx) in enumerate(zip(params["layers"], neigh_idxs)):
        h = fn(p, h, idx, act=(i < n - 1))
    return h                                              # (pad_seeds, classes)


def _softmax_ce(logits, labels):
    logits = logits[:labels.shape[0]].float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels[:, None].long())[:, 0]
    loss = (lse - gold).mean()
    acc = (logits.argmax(-1) == labels).float().mean()
    return loss, acc


def gnn_loss(params, features, neigh_idxs, labels, cfg):
    return _softmax_ce(gnn_forward(params, features, neigh_idxs, cfg), labels)


def make_train_step(cfg, opt):
    """(params, opt_state, features, neigh_idxs, labels) →
    (params, opt_state, loss, acc): one unfused step, gradients by
    autograd, update by the functional ``opt``.  The returned parameters
    are new tensors; the inputs are not modified."""

    def step(params, opt_state, features, neigh_idxs, labels):
        flat = [p.detach().requires_grad_(True) for p in leaves(params)]
        live = unflatten(params, flat)
        loss, acc = gnn_loss(live, features, neigh_idxs, labels, cfg)
        grads = unflatten(params, torch.autograd.grad(loss, flat))
        with torch.no_grad():
            updates, opt_state = opt.update(grads, opt_state, params, cfg.lr)
            params = unflatten(params, [p + u.to(p.dtype) for p, u in
                                        zip(leaves(params), leaves(updates))])
        return params, opt_state, loss.detach(), acc
    return step
