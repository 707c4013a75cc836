"""Parameter declarations and the port's own initializer.

A model declares its parameters once as a tree (dicts and lists) of
:class:`ParamDecl`; ``init_params`` materializes it from a
``torch.Generator`` and ``param_bytes`` sizes it.  The JAX package draws
its initial values from ``jax.random`` threefry, which torch cannot
replay: parity tests load those values through ``models/convert.py``
instead, and standalone runs use this initializer.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Tuple

import torch


@dataclass(frozen=True)
class ParamDecl:
    shape: Tuple[int, ...]
    dtype: torch.dtype = torch.float32
    init: str = "scaled"                # normal | zeros | ones | scaled
    scale: float = 1.0                  # stddev multiplier (fan-in for 'scaled')


def decl(shape, init="scaled", scale=1.0, dtype=torch.float32) -> ParamDecl:
    return ParamDecl(tuple(int(s) for s in shape), dtype, init, scale)


def leaves(tree) -> list:
    """Leaves in a fixed order (dict keys sorted, lists in order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def unflatten(tree, flat) -> Any:
    """Rebuild ``tree``'s structure from ``flat`` (the order of ``leaves``)."""
    it = iter(flat)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return [build(v) for v in t]
        return next(it)
    return build(tree)


def init_params(decls, generator: torch.Generator, device="cuda"):
    """Materialize parameters on ``device``.  Values are drawn on the CPU
    from ``generator`` (one stream, leaves in ``leaves`` order), so a seed
    gives the same weights on every device."""
    def one(d: ParamDecl) -> torch.Tensor:
        if d.init == "zeros":
            t = torch.zeros(d.shape)
        elif d.init == "ones":
            t = torch.ones(d.shape)
        elif d.init == "normal":
            t = torch.randn(d.shape, generator=generator) * d.scale
        elif d.init == "scaled":        # fan-in scaled normal
            fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
            t = torch.randn(d.shape, generator=generator) \
                * (d.scale / math.sqrt(max(fan_in, 1)))
        else:
            raise ValueError(f"unknown init {d.init!r}")
        return t.to(device=device, dtype=d.dtype)
    return unflatten(decls, [one(d) for d in leaves(decls)])


def param_bytes(decls) -> int:
    return sum(math.prod(d.shape) * d.dtype.itemsize for d in leaves(decls))
