"""Optimizers with the JAX package's arithmetic (``train/optimizer.py``):
AdamW, Adafactor, SGD with momentum and Lion, and ``get_optimizer``.

Not ``torch.optim``: these keep the JAX package's constants and
expressions (AdamW's b2 = 0.95 and eps OUTSIDE ``sqrt(v / bc2)``, bias
corrections in f32, Adafactor's factored second moment and update-RMS
clip), f32 state, an integer step ``count``, and work on parameter trees
(dicts and lists of tensors) whose state mirrors the tree by name, as the
checkpoint format needs.

Every optimizer declares its state as the JAX package's does:
``state_decls(param_decls)`` mirrors the declarations (f32, each
parameter's logical axes; Adafactor's factored ``vr`` / ``vc`` drop the
last and the second-to-last axis), with an int32 ``count``, so the dry-run
(launch/dryrun.py) sizes and shards the state without allocating it.

Every optimizer has ``update_(grads, state, params, lr)``, in place: each
leaf's state and parameter are written where they lie, under
``torch.no_grad()``, and ``grads`` (a list in ``leaves`` order) gives up
each gradient once it is used.  This is what JAX's donated ``jit``
(``donate_argnums=(0, 1)``) does for the LM step: no second copy of the
state or the parameters.  An elementwise update runs on flat slices of at
most ``SLICE`` elements to bound its temporaries.

AdamW also keeps the JAX package's functional form, ``update(grads, state,
params, lr)`` → (updates, new_state), which the GNN trainers use; its
``update_`` gives the same numbers bit for bit on the CPU (the same
operations in the same order).
"""
from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.distributed.sharding import is_dtensor
from repro_torch.models.params import (ParamDecl, leaves, tree_map_decls,
                                       unflatten)

SLICE = 1 << 26    # elements of one slice of an elementwise in-place update


class Optimizer(NamedTuple):
    name: str
    state_decls: Callable[[Any], Any]
    init: Callable[[Any], Any]
    update_: Callable[[List[Optional[torch.Tensor]], Any, Any, Any], None]
    # the functional form (AdamW only)
    update: Optional[Callable[[Any, Any, Any, Any], Tuple[Any, Any]]] = None
    # whether ``update_`` is elementwise, so it may run on each shard of a
    # sharded parameter alone (train/trainer.py).  It must: on DTensors
    # the flat slices of ``_slices`` cannot view a head-sharded leaf in
    # PyTorch 2.11 (``scripts/sharded_update.py`` on the card raises)
    elementwise: bool = True


def _mirror(d: ParamDecl, dtype=torch.float32) -> ParamDecl:
    return ParamDecl(d.shape, dtype, d.axes, "zeros")


def _count_decl() -> ParamDecl:
    return ParamDecl((), torch.int32, (), "zeros")


def _zeros(params):
    return unflatten(params, [torch.zeros_like(p, dtype=torch.float32)
                              for p in leaves(params)])


def _slices(*ts):
    """Aligned flat slices of at most ``SLICE`` elements of same-shaped
    contiguous tensors."""
    flat = [t.view(-1) for t in ts]
    n = flat[0].numel()
    for i in range(0, n, SLICE):
        yield [f[i:i + SLICE] for f in flat]


def _each_leaf(grads, states, params, fn):
    """``fn(g, *state_leaves, p)`` leaf by leaf under no_grad, each
    gradient dropped from ``grads`` once used."""
    p_l = leaves(params)
    with torch.no_grad():
        for i, p in enumerate(p_l):
            fn(grads[i], *(s[i] for s in states), p)
            grads[i] = None


def _bias_corrections(b1, b2, c, dev):
    """``1 - b ** count`` in f32, as the JAX package computes them."""
    cf = torch.tensor(float(c), dtype=torch.float32, device=dev)
    return (1 - torch.tensor(b1, dtype=torch.float32, device=dev) ** cf,
            1 - torch.tensor(b2, dtype=torch.float32, device=dev) ** cf)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def make_adamw(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.0) -> Optimizer:
    def state_decls(decls):
        return {"m": tree_map_decls(_mirror, decls),
                "v": tree_map_decls(_mirror, decls),
                "count": _count_decl()}

    def init(params):
        return {"m": _zeros(params), "v": _zeros(params), "count": 0}

    def step(m, v, p, bc1, bc2, lr):
        u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        if weight_decay:
            u = u + weight_decay * p.float()
        return (-lr * u).to(p.dtype)

    def update(grads, state, params, lr):
        c = state["count"] + 1
        p_l, g_l = leaves(params), leaves(grads)
        bc1, bc2 = _bias_corrections(b1, b2, c, p_l[0].device)
        m = [b1 * m + (1 - b1) * g.float()
             for m, g in zip(leaves(state["m"]), g_l)]
        v = [b2 * v + (1 - b2) * torch.square(g.float())
             for v, g in zip(leaves(state["v"]), g_l)]
        updates = [step(m_, v_, p, bc1, bc2, lr)
                   for m_, v_, p in zip(m, v, p_l)]
        return (unflatten(params, updates),
                {"m": unflatten(params, m), "v": unflatten(params, v),
                 "count": c})

    def update_(grads, state, params, lr):
        c = state["count"] + 1
        bc1, bc2 = _bias_corrections(b1, b2, c, leaves(params)[0].device)

        def one(g, m, v, p):
            for gs, ms, vs, ps in _slices(g, m, v, p):
                g32 = gs.float()
                ms.mul_(b1).add_((1 - b1) * g32)
                vs.mul_(b2).add_((1 - b2) * torch.square(g32))
                ps.add_(step(ms, vs, ps, bc1, bc2, lr))
        _each_leaf(grads, (leaves(state["m"]), leaves(state["v"])), params,
                   one)
        state["count"] = c

    return Optimizer("adamw", state_decls, init, update_, update)


# ---------------------------------------------------------------------------
# Adafactor (factored second moment; no first moment)
# ---------------------------------------------------------------------------

def _factored(p) -> bool:
    return p.dim() >= 2 and p.shape[-1] > 1 and p.shape[-2] > 1


def _per_leaf(params, tree):
    """The subtrees of ``tree`` at ``params``' leaves, in ``leaves`` order
    (Adafactor's state holds a dict at each parameter's place)."""
    if isinstance(params, dict):
        return [x for k in sorted(params) for x in _per_leaf(params[k], tree[k])]
    if isinstance(params, (list, tuple)):
        return [x for p, t in zip(params, tree) for x in _per_leaf(p, t)]
    return [tree]


def _mean(x, dim=None, keepdim=False):
    return torch.mean(x) if dim is None else x.mean(dim, keepdim=keepdim)


def _less(placements, dim: int) -> tuple:
    """A parameter's DTensor placements less its dim ``dim``: that dim's
    shards replicated, the later dims' indices one lower."""
    from torch.distributed.tensor import Replicate, Shard
    return tuple(Replicate() if q.is_shard(dim) else
                 Shard(q.dim - 1) if q.is_shard() and q.dim > dim else q
                 for q in placements)


def _check_placed(s, p):
    """Adafactor's state of a DTensor leaf must lie as its parameter does
    (``v``), less the last dim (``vr``) or the second-to-last (``vc``), so
    that each rank's shards line up with its gradient's."""
    n, pl = p.dim(), tuple(p.placements)
    want = {"v": pl, "vr": _less(pl, n - 1), "vc": _less(pl, n - 2)}
    for k, t in s.items():
        if tuple(t.placements) != want[k]:
            raise ValueError(f"Adafactor's {k} lies as {t.placements}, its "
                             f"parameter as {pl}: want {want[k]}")


def _shard_mean(p):
    """``_mean`` over one rank's shards of the DTensor leaf ``p`` and of
    tensors that lie as it does or as ``vr`` does (``p`` less its last
    dim, whose dims are ``p``'s first ones): the local sum, all-reduced
    over each mesh dim that shards the reduced dim of ``p`` (every dim
    where ``dim`` is None), divided by the dim's global extent
    (``p.shape``: shards may be uneven)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    mesh, pl = p.device_mesh, tuple(p.placements)

    def summed(x, dims):
        if not dims:
            return x
        part = DTensor.from_local(x, mesh, [Partial() if j in dims else
                                            Replicate()
                                            for j in range(mesh.ndim)],
                                  run_check=False)
        return part.redistribute(mesh, [Replicate()] * mesh.ndim).to_local()

    def mean(x, dim=None, keepdim=False):
        if dim is None:
            return summed(torch.sum(x), [j for j, q in enumerate(pl)
                                         if q.is_shard()]) / p.numel()
        d = dim % x.dim()
        return summed(torch.sum(x, d, keepdim=keepdim),
                      [j for j, q in enumerate(pl) if q.is_shard(d)]) \
            / p.shape[d]
    return mean


def make_adafactor(b2=0.99, eps=1e-30, clip_rms=1.0) -> Optimizer:
    """Adafactor.  On DTensor parameters (the sharded step) each leaf's
    update runs on the rank's own shards of the gradient, the parameter
    and the state: each mean over a dim that the parameter shards is the
    shards' sums all-reduced over that mesh dim and divided by the global
    extent (``_shard_mean``), so no placement inside the update is left
    to DTensor (which gathered the stacked expert weights once the layers
    no longer divided the data ranks).  The state must lie as the
    parameter less the reduced dim (``_check_placed``), as
    ``state_decls``' physical specs place it (the same logical axes, each
    dim kept divisible by itself), so it is never redistributed."""
    def state_decls(decls):
        def one(d: ParamDecl):
            if len(d.shape) >= 2 and d.shape[-1] > 1 and d.shape[-2] > 1:
                return {"vr": ParamDecl(d.shape[:-1], torch.float32,
                                        d.axes[:-1], "zeros"),
                        "vc": ParamDecl(d.shape[:-2] + d.shape[-1:],
                                        torch.float32,
                                        d.axes[:-2] + d.axes[-1:], "zeros")}
            return {"v": _mirror(d)}
        return {"fac": tree_map_decls(one, decls), "count": _count_decl()}

    def init(params):
        def one(p):
            if _factored(p):
                return {"vr": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                          device=p.device),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                          dtype=torch.float32,
                                          device=p.device)}
            return {"v": torch.zeros_like(p, dtype=torch.float32)}
        return {"fac": unflatten(params, [one(p) for p in leaves(params)]),
                "count": 0}

    def step(s, g, p, lr, mean=_mean):
        """One leaf: (update, new state); ``mean(x, dim, keepdim)`` (every
        element where ``dim`` is None) is the plain one, or a shard's
        (``_shard_mean``)."""
        g32 = g.float()
        g2 = torch.square(g32) + eps
        if "vr" in s:
            vr = b2 * s["vr"] + (1 - b2) * mean(g2, -1)
            vc = b2 * s["vc"] + (1 - b2) * mean(g2, -2)
            rfac = vr / torch.clamp(mean(vr, -1, keepdim=True), min=eps)
            denom = torch.sqrt(rfac[..., None] * vc[..., None, :])
            u = g32 / torch.clamp(denom, min=eps)
            new_s = {"vr": vr, "vc": vc}
        else:
            v = b2 * s["v"] + (1 - b2) * g2
            u = g32 / (torch.sqrt(v) + 1e-8)
            new_s = {"v": v}
        # update-RMS clipping (Adafactor's d = 1.0 rule)
        rms = torch.sqrt(mean(torch.square(u)) + 1e-12)
        u = u / torch.clamp(rms / clip_rms, min=1.0)
        return (-lr * u).to(p.dtype), new_s

    def update_(grads, state, params, lr):
        def one(g, s, p):
            if is_dtensor(p):
                _check_placed(s, p)
                mean = _shard_mean(p)
                s, g, p = ({k: t.to_local() for k, t in s.items()},
                           g.to_local(), p.to_local())
            else:
                mean = _mean
            u, new_s = step(s, g, p, lr, mean)
            for k, t in new_s.items():
                s[k].copy_(t)
            p.add_(u)
        _each_leaf(grads, (_per_leaf(params, state["fac"]),), params, one)
        state["count"] += 1

    return Optimizer("adafactor", state_decls, init, update_,
                     elementwise=False)


# ---------------------------------------------------------------------------
# SGD (+momentum), Lion
# ---------------------------------------------------------------------------

def make_sgd(momentum=0.9) -> Optimizer:
    def state_decls(decls):
        return {"mu": tree_map_decls(_mirror, decls), "count": _count_decl()}

    def init(params):
        return {"mu": _zeros(params), "count": 0}

    def update_(grads, state, params, lr):
        def one(g, mu, p):
            for gs, ms, ps in _slices(g, mu, p):
                ms.mul_(momentum).add_(gs.float())
                ps.add_((-lr * ms).to(p.dtype))
        _each_leaf(grads, (leaves(state["mu"]),), params, one)
        state["count"] += 1

    return Optimizer("sgd", state_decls, init, update_)


def make_lion(b1=0.9, b2=0.99, weight_decay=0.0) -> Optimizer:
    def state_decls(decls):
        return {"m": tree_map_decls(_mirror, decls), "count": _count_decl()}

    def init(params):
        return {"m": _zeros(params), "count": 0}

    def step(m, g32, p, lr):
        u = torch.sign(b1 * m + (1 - b1) * g32)
        if weight_decay:
            u = u + weight_decay * p.float()
        return (-lr * u).to(p.dtype)

    def update_(grads, state, params, lr):
        def one(g, m, p):
            for gs, ms, ps in _slices(g, m, p):
                g32 = gs.float()
                u = step(ms, g32, ps, lr)
                ms.mul_(b2).add_((1 - b2) * g32)
                ps.add_(u)
        _each_leaf(grads, (leaves(state["m"]),), params, one)
        state["count"] += 1

    return Optimizer("lion", state_decls, init, update_)


def get_optimizer(cfg) -> Optimizer:
    name = getattr(cfg, "optimizer", "adamw")
    wd = getattr(cfg, "weight_decay", 0.0)
    if name == "adamw":
        return make_adamw(weight_decay=wd)
    if name == "adafactor":
        return make_adafactor()
    if name == "sgd":
        return make_sgd()
    if name == "lion":
        return make_lion(weight_decay=wd)
    raise ValueError(f"unknown optimizer {name!r}")
