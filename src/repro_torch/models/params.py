"""Parameter declarations and the port's own initializer.

A model declares its parameters once as a tree (dicts and lists) of
:class:`ParamDecl`; ``init_params`` materializes it from a
``torch.Generator`` and ``param_bytes`` sizes it.  ``stack_decls`` adds
the leading layer axis of the LM's layer stack.  Unlike the JAX package's
declarations, the port's carry no sharding axes.  The JAX package draws
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


def tree_map(fn, tree) -> Any:
    """``fn`` applied to every leaf of nested dicts and lists, keeping the
    structure (tuples become lists)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def stack_decls(decls, n: int):
    """Add a leading layer axis of size ``n`` to every decl in the subtree.
    A ``scaled`` init then reads its fan-in from the stacked shape, as the
    JAX package's does."""
    return tree_map(lambda d: ParamDecl((n,) + d.shape, d.dtype, d.init,
                                        d.scale), decls)


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


def init_params(decls, generator: torch.Generator, device="cuda",
                dtype_override=None):
    """Materialize parameters on ``device``.  Random values are drawn on the
    generator's device from its one stream, leaves in ``leaves`` order: a
    CPU generator gives the same weights on every device, a CUDA generator
    draws a full-width LM on the card.  ``dtype_override`` stores every
    leaf in that dtype instead of its declared one (as the JAX package's
    ``init_params`` does): a normal draw is made in f32, one leaf at a
    time, and rounded."""
    gdev = generator.device

    def one(d: ParamDecl) -> torch.Tensor:
        dt = dtype_override or d.dtype
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=dt, device=device)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=dt, device=device)
        if d.init == "normal":
            std = d.scale
        elif d.init == "scaled":        # fan-in scaled normal
            fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
            std = d.scale / math.sqrt(max(fan_in, 1))
        else:
            raise ValueError(f"unknown init {d.init!r}")
        t = torch.randn(d.shape, generator=generator, device=gdev).mul_(std)
        return t.to(device=device, dtype=dt)
    return unflatten(decls, [one(d) for d in leaves(decls)])


def param_bytes(decls) -> int:
    return sum(math.prod(d.shape) * d.dtype.itemsize for d in leaves(decls))
