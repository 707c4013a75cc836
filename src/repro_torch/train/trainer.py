"""Training-step construction: grads → clip → optimizer → apply, as the
JAX package's ``train/trainer.py``.

``make_train_step(model, cfg, opt)`` builds the LM step
``(params, opt_state, batch) → (params, opt_state, metrics)``, with
``grad_accum`` microbatches and the ``grad_transform`` hook.  The
gradients come from ``torch.autograd.grad`` of ``model.loss_fn`` with
respect to every parameter leaf; the update is the optimizer's in-place
``update_``, so the returned ``params`` and ``opt_state`` are the objects
passed in, written in place (what JAX's ``jit(step, donate_argnums=(0,
1))`` does), and each gradient is freed once the update has used it.

Sharded: the same step takes DTensor parameters and state, placed by
``physical_specs`` of ``model.decls`` and ``opt.state_decls``
(``models/convert.distribute_params``), inside a ``shard_ctx`` that holds
their ``DeviceMesh``.  Each gradient comes back from autograd as DTensor
leaves it (a partial sum where ranks computed parts of it) and is
redistributed to its parameter's placements before clipping and the
update: what JAX's ``out_shardings`` force, and where the step's gradient
all-reduces and reduce-scatters happen.  The loss and the metrics are
made replicated.  ``global_norm`` sums each leaf's shards (DTensor
reduces the partial sums); an elementwise optimizer (``opt.elementwise``:
AdamW, SGD, Lion) updates each rank's local shards in place, Adafactor
(whose factored moments are means over whole dims) takes the DTensors and
updates each leaf's local shards itself, its means reduced explicitly
over the mesh dims that shard them (``optimizer.make_adafactor``).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.distributed.sharding import is_dtensor
from repro_torch.models.params import leaves, tree_map, unflatten
from repro_torch.train.optimizer import Optimizer, get_optimizer


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves (in ``leaves`` order) of each leaf's sum
    of squares in f32.  Of DTensors: the sums added up as partial sums on
    every mesh dim where one of them is partial, then reduced once (left
    to DTensor, where a partial and a replicated sum meet it reduces in
    one PyTorch version and not in another)."""
    sq = [torch.sum(torch.square(t.float())) for t in leaves(tree)]
    dims = {j for s in sq if is_dtensor(s)
            for j, p in enumerate(s.placements) if p.is_partial()}
    if dims:
        from torch.distributed.tensor import DTensor, Partial, Replicate
        mesh = next(s for s in sq if is_dtensor(s)).device_mesh

        def share(s):
            """This rank's share of ``s`` as a partial sum on ``dims``: a
            sum replicated on one of them is kept by its first rank."""
            if not is_dtensor(s):
                return s if all(mesh.get_local_rank(j) == 0
                                for j in dims) else torch.zeros_like(s)
            keep = all(p.is_partial() or mesh.get_local_rank(j) == 0
                       for j, p in enumerate(s.placements) if j in dims)
            return s.to_local() if keep else torch.zeros_like(s.to_local())
        sq = [DTensor.from_local(sum(share(s) for s in sq), mesh,
                                 [Partial() if j in dims else Replicate()
                                  for j in range(mesh.ndim)],
                                 run_check=False)]
    return torch.sqrt(replicated(sum(sq)))


def clip_by_global_norm(grads, max_norm: float):
    """Scales each gradient of the list ``grads`` in place by
    min(1, max_norm / (norm + 1e-9)); returns (grads, norm)."""
    with torch.no_grad():
        gnorm = global_norm(grads)
        scale = torch.clamp(max_norm / (gnorm + 1e-9), max=1.0)
        for g in grads:
            g.mul_(scale)
    return grads, gnorm


def replicated(t):
    """A DTensor made replicated on every mesh dim (partial sums reduced,
    shards gathered); anything else as it is."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate
    return t.redistribute(t.device_mesh, (Replicate(),) * t.device_mesh.ndim)


def placed_like(grads, p_l):
    """Each DTensor gradient of the list redistributed to its parameter's
    placements."""
    return [g.redistribute(p.device_mesh, p.placements) if is_dtensor(g)
            else g for g, p in zip(grads, p_l)]


def _local(t):
    return t.to_local() if is_dtensor(t) else t


def _update(opt, grads, opt_state, params, lr):
    """``opt.update_``, on each rank's local shards where the parameters
    are DTensors and the update is elementwise; a non-elementwise one
    (Adafactor) gets the DTensors, whose placements its reductions need."""
    if not (opt.elementwise and any(is_dtensor(p) for p in leaves(params))):
        opt.update_(grads, opt_state, params, lr)
        return
    local_state = {k: (v if k == "count" else tree_map(_local, v))
                   for k, v in opt_state.items()}
    opt.update_([_local(g).contiguous() for g in grads], local_state,
                tree_map(_local, params), lr)
    opt_state["count"] = local_state["count"]
    grads[:] = [None] * len(grads)


def make_train_step(model, cfg, opt: Optional[Optimizer] = None,
                    grad_accum: int = 1,
                    grad_transform: Optional[Callable] = None):
    """grad_transform: an optional (grads tree → grads tree) hook, e.g. a
    compressed all-reduce.  Returns (train_step, opt)."""
    opt = opt or get_optimizer(cfg)

    def compute_grads(params, batch):
        p_l = leaves(params)
        for p in p_l:
            p.requires_grad_(True)
        try:
            loss, metrics = model.loss_fn(params, batch)
            grads = torch.autograd.grad(loss, p_l, allow_unused=True)
        finally:
            for p in p_l:
                p.requires_grad_(False)
        # a leaf the loss does not reach gets zeros, as jax.grad gives it
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, p_l)]
        return (replicated(loss.detach()),
                {k: replicated(v.detach()) for k, v in metrics.items()},
                placed_like(grads, p_l))

    def train_step(params, opt_state, batch):
        if grad_accum > 1:
            # the batch's leading dim split into microbatches, summed in order
            mbs = {k: v.reshape(grad_accum, v.shape[0] // grad_accum,
                                *v.shape[1:]) for k, v in batch.items()}
            grads = [torch.zeros_like(p, dtype=torch.float32)
                     for p in leaves(params)]
            lsum = torch.zeros((), dtype=torch.float32,
                               device=grads[0].device)
            for i in range(grad_accum):
                loss, _, g_mb = compute_grads(params,
                                              {k: v[i] for k, v in mbs.items()})
                for acc, g in zip(grads, g_mb):
                    acc.add_(g)
                lsum = lsum + loss
                del g_mb
            for g in grads:
                g.div_(grad_accum)
            loss = lsum / grad_accum
            metrics = {"loss": loss,
                       "aux": torch.zeros((), dtype=torch.float32,
                                          device=loss.device)}
        else:
            loss, metrics, grads = compute_grads(params, batch)

        if grad_transform is not None:
            grads = leaves(grad_transform(unflatten(params, grads)))
        if cfg.grad_clip:
            grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
        else:
            gnorm = global_norm(grads)
        _update(opt, grads, opt_state, params, cfg.learning_rate)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm,
                                   **metrics}

    return train_step, opt
