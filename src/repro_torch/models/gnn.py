"""GNN models over sampled blocks: GraphSAGE (mean), GCN, GAT, GIN.

Blocks use fixed-fanout padded neighbor matrices (core/sampling.py), so
every hop is a dense masked gather + matmul.  Every layer has the JAX
package's two expressions of the same math:

- **unfused** (default): materialize the gathered-neighbor tensor
  (``_gather_neighbors``) and reduce it; autograd differentiates it.
  Serving and evaluation use it.
- **fused** (``fused=True``): the hop's aggregation runs through
  ``kernels/segment_agg.neighbor_agg`` over the previous layer's output
  buffer, so the (Nd, fanout, D) tensor never materializes; its gradient
  is the kernel's backward.  ``gnn_forward_allfused`` goes further at
  layer 0: the input rows are resolved straight out of the feature-plane
  cache table through ``kernels/fused_gather_agg`` (encoded slots + miss
  sideband), so the (pad_src0, F) input tensor never materializes either.

Parameters are plain dicts of tensors, ``{"layers": [{name: tensor}]}``,
in the JAX package's layout: weights are ``(din, dout)`` and a layer
computes ``h @ W``, so ``models/convert.py`` maps them by name.
"""
from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.fused_gather_agg.ops import gather_aggregate
from repro_torch.kernels.fused_gather_agg.ref import \
    resolve_rows_ref as resolve_rows
from repro_torch.kernels.segment_agg.ops import neighbor_agg
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


# ---------------------------------------------------------------------------
# combine stages: what each model does AFTER the neighbor aggregation,
# shared between the unfused layers, the fused layers and the all-fused
# layer-0 entry (which gets (h_dst, agg) from kernels/fused_gather_agg)
# ---------------------------------------------------------------------------

def _sage_combine(p, h_dst, agg_mean, neigh_idx, act):
    out = h_dst @ p["w_self"] + agg_mean @ p["w_neigh"] + p["b"]
    return F.relu(out) if act else out


def _gcn_combine(p, h_dst, agg_mean, neigh_idx, act):
    # sampled-mean approximation of sym-normalized aggregation incl. self-loop
    cnt = _count(neigh_idx >= 0, h_dst.dtype)
    z = (agg_mean * cnt + h_dst) / (cnt + 1.0)
    out = z @ p["w"] + p["b"]
    return F.relu(out) if act else out


def _gin_combine(p, h_dst, agg_sum, neigh_idx, act):
    z = (1.0 + p["eps"]) * h_dst + agg_sum
    out = F.relu(z @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]
    return F.relu(out) if act else out


# model → (combine fn, aggregation mode its layer consumes)
_COMBINE = {"graphsage": (_sage_combine, "mean"),
            "gcn": (_gcn_combine, "mean"),
            "gin": (_gin_combine, "sum")}


def _agg(h_src, neigh_idx, mode, *, fused):
    if fused:
        return neighbor_agg(neigh_idx, h_src, mode=mode)
    return _mean_agg(h_src, neigh_idx) if mode == "mean" \
        else _sum_agg(h_src, neigh_idx)


def sage_layer(p, h_src, neigh_idx, *, act=True, fused=False):
    h_dst = h_src[:neigh_idx.shape[0]]
    agg = _agg(h_src, neigh_idx, "mean", fused=fused)
    return _sage_combine(p, h_dst, agg, neigh_idx, act)


def gcn_layer(p, h_src, neigh_idx, *, act=True, fused=False):
    h_dst = h_src[:neigh_idx.shape[0]]
    agg = _agg(h_src, neigh_idx, "mean", fused=fused)
    return _gcn_combine(p, h_dst, agg, neigh_idx, act)


def gin_layer(p, h_src, neigh_idx, *, act=True, fused=False):
    h_dst = h_src[:neigh_idx.shape[0]]
    agg = _agg(h_src, neigh_idx, "sum", fused=fused)
    return _gin_combine(p, h_dst, agg, neigh_idx, act)


def gat_layer(p, h_src, neigh_idx, *, act=True, fused=False):
    n_dst = neigh_idx.shape[0]
    z_src = h_src @ p["w"]                               # (Ns,D')
    z_dst = z_src[:n_dst]
    # the self edge joins the softmax (jax.nn.leaky_relu's 0.01 slope)
    e_self = F.leaky_relu(z_dst @ (p["a_src"] + p["a_dst"]))[:, None]
    if fused:
        # attention scores need only the scalar projections z@a_src —
        # gather those (Nd, fanout) scalars, not (Nd, fanout, D') rows
        mask = neigh_idx >= 0
        s_src = z_src @ p["a_src"]                       # (Ns,)
        s_nb = s_src[neigh_idx.clamp(0, s_src.shape[0] - 1).long()]
        e = F.leaky_relu(torch.where(mask, s_nb, torch.zeros_like(s_nb))
                         + (z_dst @ p["a_dst"])[:, None], negative_slope=0.2)
        e = e.masked_fill(~mask, -1e30)
        alla = torch.softmax(torch.cat([e, e_self], dim=1), dim=1)
        agg = neighbor_agg(neigh_idx, z_src, mode="sum",
                           weights=alla[:, :-1].contiguous()) \
            + alla[:, -1:] * z_dst
    else:
        nb, mask = _gather_neighbors(z_src, neigh_idx)   # (Nd,F,D')
        e = F.leaky_relu(nb @ p["a_src"] + (z_dst @ p["a_dst"])[:, None],
                         negative_slope=0.2)
        e = e.masked_fill(~mask, -1e30)
        alla = torch.softmax(torch.cat([e, e_self], dim=1), dim=1)
        agg = torch.einsum("nf,nfd->nd", alla[:, :-1], nb) \
            + alla[:, -1:] * z_dst
    out = agg + p["b"]
    return F.elu(out) if act else out


_LAYER_FNS = {"graphsage": sage_layer, "gcn": gcn_layer, "gat": gat_layer,
              "gin": gin_layer}


def gnn_forward(params, features, neigh_idxs, cfg, *, fused=False):
    """features (pad_src0, F); neigh_idxs[i] (pad_dst_i, fanout_i) with the
    chained-padding invariant pad_dst_i == pad_src_{i+1}."""
    fn = _LAYER_FNS[cfg.model]
    h = features.to(_DTYPES[cfg.compute_dtype])
    n = len(params["layers"])
    for i, (p, idx) in enumerate(zip(params["layers"], neigh_idxs)):
        h = fn(p, h, idx, act=(i < n - 1), fused=fused)
    return h                                              # (pad_seeds, classes)


def gnn_forward_allfused(params, enc0, aux0, table, neigh_idxs, cfg):
    """All-hop fused forward: layer-0 inputs are the encoded slots ``enc0``
    resolved against the feature-plane cache ``table`` and the miss
    sideband ``aux0`` (kernels/fused_gather_agg) — the (pad_src0, F)
    input-feature tensor never materializes — and every hop ≥ 1 runs the
    fused per-hop aggregation over the previous layer's output buffer."""
    dt = _DTYPES[cfg.compute_dtype]
    n = len(params["layers"])
    p0, idx0 = params["layers"][0], neigh_idxs[0]
    if cfg.model == "gat":
        # attention needs the per-src projection: resolve the rows (still no
        # neighbor tensor) and run the fused GAT layer on them
        rows = resolve_rows(enc0, table, aux0).to(dt)
        h = gat_layer(p0, rows, idx0, act=(n > 1), fused=True)
    else:
        combine, mode = _COMBINE[cfg.model]
        h_dst, agg = gather_aggregate(enc0, idx0, table, aux0, mode=mode)
        h = combine(p0, h_dst.to(dt), agg.to(dt), idx0, act=(n > 1))
    fn = _LAYER_FNS[cfg.model]
    for i, (p, idx) in enumerate(zip(params["layers"][1:], neigh_idxs[1:]),
                                 start=1):
        h = fn(p, h, idx, act=(i < n - 1), fused=True)
    return h


def _softmax_ce(logits, labels):
    logits = logits[:labels.shape[0]].float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels[:, None].long())[:, 0]
    loss = (lse - gold).mean()
    acc = (logits.argmax(-1) == labels).float().mean()
    return loss, acc


def gnn_loss(params, features, neigh_idxs, labels, cfg):
    return _softmax_ce(gnn_forward(params, features, neigh_idxs, cfg), labels)


def gnn_loss_allfused(params, enc0, aux0, table, neigh_idxs, labels, cfg):
    logits = gnn_forward_allfused(params, enc0, aux0, table, neigh_idxs, cfg)
    return _softmax_ce(logits, labels)


def _make_step(loss_fn, cfg, opt):
    """One step of ``loss_fn(params, *inputs)``: gradients by autograd, the
    update by the functional ``opt``.  The returned parameters are new
    tensors; the inputs are not modified."""

    def step(params, opt_state, *inputs):
        flat = [p.detach().requires_grad_(True) for p in leaves(params)]
        live = unflatten(params, flat)
        loss, acc = loss_fn(live, *inputs)
        grads = unflatten(params, torch.autograd.grad(loss, flat))
        with torch.no_grad():
            updates, opt_state = opt.update(grads, opt_state, params, cfg.lr)
            params = unflatten(params, [p + u.to(p.dtype) for p, u in
                                        zip(leaves(params), leaves(updates))])
        return params, opt_state, loss.detach(), acc
    return step


def make_train_step(cfg, opt):
    """(params, opt_state, features, neigh_idxs, labels) →
    (params, opt_state, loss, acc): one unfused step."""
    return _make_step(lambda p, feats, idxs, labels:
                      gnn_loss(p, feats, idxs, labels, cfg), cfg, opt)


def make_train_step_allfused(cfg, opt):
    """All-hop fused twin of ``make_train_step``: (params, opt_state, enc0,
    aux0, table, neigh_idxs, labels) → (params, opt_state, loss, acc),
    consuming the feature plane's encoded inputs instead of the
    materialized feature tensor.  ``step.counters["calls"]`` counts
    invocations (PyTorch runs eagerly: there are no traces to count)."""
    counters = {"calls": 0}
    inner = _make_step(
        lambda p, enc0, aux0, table, idxs, labels: gnn_loss_allfused(
            p, enc0, aux0, table, idxs, labels, cfg), cfg, opt)

    def step(params, opt_state, enc0, aux0, table, neigh_idxs, labels):
        counters["calls"] += 1
        return inner(params, opt_state, enc0, aux0, table, neigh_idxs, labels)

    step.counters = counters
    return step


def make_eval_fn(cfg):
    """(params, features, neigh_idxs, labels) → accuracy over the labelled
    prefix of the logits (unfused forward, no gradients)."""

    def ev(params, features, neigh_idxs, labels):
        with torch.inference_mode():
            logits = gnn_forward(params, features, neigh_idxs, cfg)
            logits = logits[:labels.shape[0]]
            return (logits.argmax(-1) == labels).float().mean()
    return ev
