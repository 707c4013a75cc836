"""Parameter declarations and the port's own initializer.

A model declares its parameters once as a tree (dicts and lists) of
:class:`ParamDecl` (shape, dtype, logical sharding axes, initializer),
the JAX package's fields in its order.  From it derive:

  * ``init_params``      materialized tensors (the port's initializer)
  * ``abstract_params``  ``meta`` tensors: shapes and dtypes, no storage
                         (the dry-run, launch/dryrun.py)
  * ``logical_specs``    the tree of logical partition specs
                         (``distributed.sharding.P``)
  * ``param_count`` / ``param_bytes``

``stack_decls`` adds the leading (replicated) layer axis of the LM's layer
stack.  The logical axis names are the JAX package's: ``fsdp``, ``tp``,
``tp_kv``, ``qheads``, ``expert``, ``vocab``, ``dp``, ``kvseq``,
``kvheads`` and ``None`` (replicated); ``distributed/sharding.py``
resolves them against a mesh.  The JAX package draws its initial values
from ``jax.random`` threefry, which torch cannot replay: parity tests load
those values through ``models/convert.py`` instead, and standalone runs use
this initializer.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

import torch

Logical = Tuple[Any, ...]  # logical axis names (str, a tuple of them, None)


@dataclass(frozen=True)
class ParamDecl:
    shape: Tuple[int, ...]
    dtype: torch.dtype
    axes: Logical                       # logical sharding, len == len(shape)
    init: str = "normal"                # normal | zeros | ones | scaled
    scale: float = 1.0                  # stddev multiplier (fan-in for 'scaled')

    def __post_init__(self):
        assert len(self.axes) == len(self.shape), (self.shape, self.axes)


def decl(shape, axes, init="scaled", scale=1.0,
         dtype=torch.float32) -> ParamDecl:
    return ParamDecl(tuple(int(s) for s in shape), dtype, tuple(axes), init,
                     scale)


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


def tree_map_decls(fn: Callable[[ParamDecl], Any], decls):
    return tree_map(fn, decls)


def stack_decls(decls, n: int):
    """Add a leading (replicated) layer axis of size ``n`` to every decl in
    the subtree.  A ``scaled`` init then reads its fan-in from the stacked
    shape, as the JAX package's does."""
    return tree_map(lambda d: ParamDecl((n,) + d.shape, d.dtype,
                                        (None,) + d.axes, d.init, d.scale),
                    decls)


def abstract_params(decls, dtype_override: Optional[torch.dtype] = None):
    """Each leaf as an empty tensor on the ``meta`` device: its shape and
    dtype (``dtype_override`` for every leaf, if given), no storage."""
    return tree_map(lambda d: torch.empty(d.shape,
                                          dtype=dtype_override or d.dtype,
                                          device="meta"), decls)


def logical_specs(decls):
    from repro_torch.distributed.sharding import P
    return tree_map(lambda d: P(*d.axes), decls)


def unflatten(tree, flat) -> Any:
    """Rebuild ``tree``'s structure from ``flat`` (the order of ``leaves``).
    A module-level recursion, not a nested function that calls itself: that
    closure is a reference cycle, which kept ``flat`` (a step's gradients)
    allocated until the garbage collector ran."""
    return _rebuild(tree, iter(flat))


def _rebuild(t, it) -> Any:
    if isinstance(t, dict):
        return {k: _rebuild(t[k], it) for k in sorted(t)}
    if isinstance(t, (list, tuple)):
        return [_rebuild(v, it) for v in t]
    return next(it)


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


def param_count(decls) -> int:
    return sum(math.prod(d.shape) for d in leaves(decls))


def param_bytes(decls) -> int:
    return sum(math.prod(d.shape) * d.dtype.itemsize for d in leaves(decls))
