"""Functional AdamW, as the JAX package's ``train/optimizer.py:make_adamw``.

Not ``torch.optim.AdamW``: this one keeps the JAX package's b2 = 0.95,
adds eps OUTSIDE ``sqrt(v / bc2)``, counts steps as an integer and works on
parameter trees (dicts and lists of tensors), returning updates rather
than writing into the parameters.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import torch

from repro_torch.models.params import leaves, unflatten


class Optimizer(NamedTuple):
    name: str
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, Any], Tuple[Any, Any]]


def make_adamw(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.0) -> Optimizer:
    def init(params):
        zeros = [torch.zeros_like(p, dtype=torch.float32) for p in leaves(params)]
        return {"m": unflatten(params, zeros),
                "v": unflatten(params, [z.clone() for z in zeros]),
                "count": 0}

    def update(grads, state, params, lr):
        c = state["count"] + 1
        p_l, g_l = leaves(params), leaves(grads)
        dev = p_l[0].device
        # bias corrections in float32, as the JAX package computes them
        cf = torch.tensor(float(c), dtype=torch.float32, device=dev)
        bc1 = 1 - torch.tensor(b1, dtype=torch.float32, device=dev) ** cf
        bc2 = 1 - torch.tensor(b2, dtype=torch.float32, device=dev) ** cf
        m = [b1 * m + (1 - b1) * g.float()
             for m, g in zip(leaves(state["m"]), g_l)]
        v = [b2 * v + (1 - b2) * torch.square(g.float())
             for v, g in zip(leaves(state["v"]), g_l)]
        updates = []
        for m_, v_, p in zip(m, v, p_l):
            u = (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps)
            if weight_decay:
                u = u + weight_decay * p.float()
            updates.append((-lr * u).to(p.dtype))
        return (unflatten(params, updates),
                {"m": unflatten(params, m), "v": unflatten(params, v),
                 "count": c})

    return Optimizer("adamw", init, update)
