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
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.models.params import leaves, unflatten
from repro_torch.train.optimizer import Optimizer, get_optimizer


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves (in ``leaves`` order) of each leaf's sum
    of squares in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(t.float()))
                          for t in leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    """Scales each gradient of the list ``grads`` in place by
    min(1, max_norm / (norm + 1e-9)); returns (grads, norm)."""
    with torch.no_grad():
        gnorm = global_norm(grads)
        scale = torch.clamp(max_norm / (gnorm + 1e-9), max=1.0)
        for g in grads:
            g.mul_(scale)
    return grads, gnorm


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
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                grads)

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
        opt.update_(grads, opt_state, params, cfg.learning_rate)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm,
                                   **metrics}

    return train_step, opt
