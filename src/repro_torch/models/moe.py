"""Mixture-of-Experts layer: the JAX package's "gather-capacity" MoE.

A port of ``src/repro/models/moe.py``, line for line.  The tokens are
split into ``DS = ctx_dp_size()`` groups, the data shards of the sharding
context (``distributed/sharding.py``; 1 with no context, and when DS does
not divide the tokens), and each expert's capacity is per group, as in
JAX.  The port runs on one card with no context, so its paths have DS = 1;
the dry-run (launch/dryrun.py) traces under the production mesh's context
and so counts JAX's grouping:

  1. router logits (T, E) in f32, the pad experts masked with -1e30; each
     token's top-k experts by probability, their weights renormalised
  2. per-expert scores (E, T): the routing weight where routed, -inf else
  3. each expert's top-C tokens of each group by score; the slots past an
     expert's routed tokens are invalid and gather zeros
  4. batched expert matmuls (E, C, D) @ (E, D, F)
  5. each token's contributions summed back, then the shared experts

Tokens beyond an expert's capacity C = cf·k·(T/DS)/E (rounded up to a
multiple of 8, at most T/DS) in a group are dropped, as in GShard; the
residual carries them.

Step 5 is JAX's scatter-add ``y.at[idx].add(out)``.  A scatter-add of
floats on the card (``index_add_``) adds in whatever order its atomics
land, so two prefills could differ in the last bit.  Here each token
gathers its own contributions and adds them in one fixed order, its
experts ascending: the order in which a sequential scatter over the
expert-major slots adds them, in the output's dtype.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import (constrain, ctx_dp_size,
                                              is_dtensor, shard_axis)
from repro_torch.models import layers as L
from repro_torch.models.params import decl

PAD_LOGIT = -1e30


def decls_moe(cfg):
    D, Fd = cfg.d_model, cfg.d_ff
    E = cfg.num_experts_padded
    d = {"router": decl((D, E), ("fsdp", None), scale=1.0),
         "w_gate": decl((E, D, Fd), ("expert", "fsdp", None)),
         "w_up": decl((E, D, Fd), ("expert", "fsdp", None)),
         "w_down": decl((E, Fd, D), ("expert", None, "fsdp"))}
    if cfg.shared_expert_ff:
        S = cfg.shared_expert_ff
        d["shared"] = {"w_gate": decl((D, S), ("fsdp", "tp")),
                       "w_up": decl((D, S), ("fsdp", "tp")),
                       "w_down": decl((S, D), ("tp", "fsdp"))}
    return d


def capacity(cfg, tokens_per_shard: int) -> int:
    E = cfg.num_experts_padded
    c = int(cfg.capacity_factor * cfg.moe_top_k * tokens_per_shard / E)
    # a multiple of 8, at least 8 (the JAX package's sublane alignment)
    c = max(8, -(-c // 8) * 8)
    return min(c, tokens_per_shard)


def combine(out, idx, valid, topi, e0: int = 0):
    """The experts' outputs summed back per token: out (E, C, D), expert
    e0 + e's slot c holding token idx[e, c] where valid[e, c]; topi (T, K)
    each token's experts (an expert outside e0..e0+E-1 adds nothing).
    Returns (T, D) in out's dtype, each token's contributions added in
    ascending expert order (JAX's ``zeros.at[idx].add(out)`` over the
    expert-major slots, written as a gather: no two threads add into one
    row)."""
    E, C, D = out.shape
    T, K = topi.shape
    dev = out.device
    # each token's slot in each expert's buffer (-1: not gathered there);
    # an expert's C tokens are distinct, so no two writes meet
    slot = torch.full((E, T), -1, dtype=torch.long, device=dev)
    cols = torch.arange(C, device=dev).expand(E, C)
    slot.scatter_(1, idx, torch.where(valid, cols, -1))
    experts = topi.sort(dim=-1).values - e0                          # (T, K)
    here = (experts >= 0) & (experts < E)
    experts = experts.clamp(0, E - 1)
    c = slot[experts, torch.arange(T, device=dev)[:, None]]          # (T, K)
    c = torch.where(here, c, -1)
    part = out.reshape(E * C, D)[(experts * C + c.clamp_min(0)).view(-1)]
    part = torch.where((c >= 0).view(-1, 1), part,
                       torch.zeros((), dtype=part.dtype, device=dev))
    part = part.view(T, K, D)
    y = part[:, 0]
    for k in range(1, K):
        y = y + part[:, k]
    return y


def top_k(x, k: int):
    """``jax.lax.top_k`` over the last dim: the k largest values, and
    among equal values the lower index first (a stable descending sort;
    ``torch.topk`` promises no order among ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(xt, router, cfg):
    """Tokens xt (T, D) → (topi (T, K) each token's experts, w_te (T, E)
    its routing weight on each expert (0 where not routed), me (E,) the
    mean router probability, fe (E,) the mean routed count)."""
    E, K = cfg.num_experts_padded, cfg.moe_top_k
    dev = xt.device
    logits = xt.float() @ router.float()                             # (T, E)
    if cfg.num_experts_padded > cfg.num_experts:
        real = torch.arange(E, device=dev) < cfg.num_experts
        logits = torch.where(real, logits,
                             torch.full((), PAD_LOGIT, device=dev))
    probs = torch.softmax(logits, dim=-1)
    topw, topi = top_k(probs, K)                                    # (T, K)
    topw = topw / topw.sum(-1, keepdim=True).clamp_min(1e-9)

    onehot = F.one_hot(topi, E).float()                              # (T, K, E)
    w_te = (onehot * topw[..., None]).sum(1)                         # (T, E)
    return topi, w_te, probs.mean(0), onehot.sum(1).mean(0)


def experts(xt, w_te, topi, w_gate, w_up, w_down, C: int, DS: int,
            e0: int = 0):
    """Experts e0..e0+El-1 (``w_gate`` (El, D, F) ...) over the tokens xt
    (T, D) in DS groups: each expert's top-C tokens of each group by its
    routing weight ``w_te`` (T, El), the batched expert products, and the
    tokens' outputs summed back (``combine``).  Returns (T, D)."""
    T, D = xt.shape
    El = w_gate.shape[0]
    Tl = T // DS
    dev = xt.device
    scores = torch.where(w_te > 0, w_te,
                         torch.full((), -torch.inf, device=dev)).T   # (El, T)

    gathered_w, idx = top_k(scores.reshape(El, DS, Tl), C)
    if DS > 1:                       # each group's token ids made global
        idx = idx + (torch.arange(DS, device=dev) * Tl)[None, :, None]
    gathered_w, idx = gathered_w.reshape(El, DS * C), idx.reshape(El, DS * C)
    valid = torch.isfinite(gathered_w)
    gate_w = torch.where(valid, gathered_w, torch.zeros((), device=dev))

    buf = xt[idx.reshape(-1)].view(El, DS * C, D)
    buf = buf * valid[..., None].to(buf.dtype)
    g = torch.bmm(buf, w_gate.to(buf.dtype))
    u = torch.bmm(buf, w_up.to(buf.dtype))
    out = torch.bmm(F.silu(g) * u, w_down.to(buf.dtype))       # (El, DS·C, D)
    out = out * gate_w[..., None].to(out.dtype)
    return combine(out, idx, valid, topi, e0)


def moe_mlp(p, x, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) → (y (B, S, D), aux_loss f32 scalar)."""
    B, S, D = x.shape
    T = B * S
    E, K = cfg.num_experts_padded, cfg.moe_top_k
    DS = ctx_dp_size()
    if T % DS != 0:
        DS = 1
    C = capacity(cfg, T // DS)

    xt = x.reshape(T, D)
    if is_dtensor(xt):
        y, me, fe = _moe_sharded(p, xt, cfg, DS, C)
    else:
        topi, w_te, me, fe = route(xt, p["router"], cfg)
        y = experts(xt, w_te, topi, p["w_gate"], p["w_up"], p["w_down"], C,
                    DS)
    y = constrain(y.view(B, S, D), "dp", None, None)

    if cfg.shared_expert_ff:
        sp = p["shared"]
        sg = L._proj(x, sp["w_gate"].to(x.dtype))
        su = L._proj(x, sp["w_up"].to(x.dtype))
        y = y + L._proj(F.silu(sg) * su, sp["w_down"].to(x.dtype))

    # load-balancing auxiliary loss (Switch): E * sum_e f_e * p_e
    aux = cfg.num_experts * torch.sum(me * fe) / max(K, 1)
    return y, aux.float()


def _moe_sharded(p, xt, cfg, DS: int, C: int):
    """The routed experts of DTensor tokens xt (T, D), per shard
    (``local_map``): each rank routes its own tokens (the batch rows of
    its ``dp`` shards: the groups JAX's ``constrain`` puts there) and runs
    the experts it holds (the ``expert`` dim on the ``model`` axis), so
    its output is a partial sum over that axis, reduced by the caller's
    ``constrain``; nothing is sent but that sum and the weights' FSDP
    gathers.  ``me`` and ``fe`` come back as partial sums over the ``dp``
    shards of each shard's means over DS."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = xt.device_mesh
    E = cfg.num_experts_padded
    x_pl = tuple(pl if pl.is_shard(0) else Replicate()
                 for pl in xt.placements)
    shards = 1
    for j, pl in enumerate(x_pl):
        if pl.is_shard(0):
            shards *= mesh.size(j)
    ds_local = max(DS // shards, 1)
    ex = shard_axis(p["w_gate"], 0)
    if ex is not None and x_pl[ex] != Replicate():
        ex = None
    e0 = 0 if ex is None else mesh.get_local_rank(ex) * (E // mesh.size(ex))
    rep = (Replicate(),) * mesh.ndim
    dp_partial = tuple(Partial() if pl.is_shard(0) else Replicate()
                       for pl in x_pl)

    def route_local(xl, rl):
        topi, w_te, me, fe = route(xl, rl, cfg)
        return topi, w_te, me / shards, fe / shards
    topi, w_te, me, fe = local_map(
        route_local, out_placements=(x_pl, x_pl, dp_partial, dp_partial),
        in_placements=(x_pl, rep), in_grad_placements=(x_pl, dp_partial),
        device_mesh=mesh, redistribute_inputs=True)(xt, p["router"])

    w_pl = tuple(Shard(0) if j == ex else Replicate()
                 for j in range(mesh.ndim))
    w_grad = tuple(Shard(0) if j == ex else dp_partial[j]
                   for j in range(mesh.ndim))
    y_pl = tuple(Partial() if j == ex else x_pl[j] for j in range(mesh.ndim))

    def experts_local(xl, wl, tl, g, u, d):
        return experts(xl, wl[:, e0:e0 + g.shape[0]], tl, g, u, d, C,
                       ds_local, e0)
    y = local_map(
        experts_local, out_placements=list(y_pl),
        in_placements=(x_pl, x_pl, x_pl, w_pl, w_pl, w_pl),
        in_grad_placements=(y_pl, y_pl, x_pl, w_grad, w_grad, w_grad),
        device_mesh=mesh, redistribute_inputs=True)(
            xt, w_te, topi, p["w_gate"], p["w_up"], p["w_down"])
    return y, me, fe
