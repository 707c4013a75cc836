"""Gradient compression for the slow cross-pod data-parallel axis.

A port of ``src/repro/train/compression.py``.  Two schemes, both with
error feedback (the residual is carried to the next step, so compression
error does not bias convergence):

  * int8 uniform quantization with a per-tensor scale: 4x fewer bytes
    than f32, 2x fewer than bf16;
  * top-k sparsification: k·(4 + 4) bytes per tensor.

Each function gives the JAX package's values bit for bit on the CPU:
``torch.round`` rounds half to even as ``jnp.round`` does, the f32
operations run in JAX's order, and ``topk_sparsify`` selects through a
stable descending sort of ``|x|``, so equal magnitudes keep the lower
index first, as ``jax.lax.top_k`` does (``torch.topk`` promises no order
among ties).

``compressed_psum_int8`` is the cross-member mean with an int8 payload,
over the members of a host-simulated mesh (``launch/mesh.HostSimMesh``:
every member's tensor on one device, as ``grad_allreduce`` works) or of a
``GroupMesh`` (one member a process): each member quantizes by the shared
(max) scale, the int32 payloads are summed in member order, and the sum
is dequantized and divided by the member count.  Over a group the scale
is an ``all_reduce(MAX)`` (exact) and the int8 payloads travel as int8
(one ``all_gather``), so every member computes the host-sim result on its
tensor's device.  ``make_crosspod_grad_transform`` is the
``grad_transform`` hook of ``train/trainer.make_train_step`` for a mesh
with a ``pod`` axis.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import torch

from repro_torch.distributed.collectives import all_gather_tensors
from repro_torch.launch.mesh import GroupMesh, HostSimMesh, axis_sizes
from repro_torch.models.params import leaves, tree_map, unflatten


# ---------------------------------------------------------------------------
# Quantization primitives
# ---------------------------------------------------------------------------

def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` rounded once, as JAX divides: the divisor is a tensor on
    x's device (CUDA divides by a host scalar as a product with its
    reciprocal, which can round differently)."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def _scale(x: torch.Tensor) -> torch.Tensor:
    return _div(x.abs().max().float(), 127.0) + 1e-12


def _quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x.float() / scale), -127, 127)


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x → (int8 payload, f32 scale ``max|x| / 127 + 1e-12``)."""
    scale = _scale(x)
    return _quantize(x, scale).to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def topk_sparsify(x: torch.Tensor, frac: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Keep the top-``frac`` entries by magnitude (at least one): (values,
    flat int32 indices), largest magnitude first, ties to the lower
    index."""
    flat = x.reshape(-1)
    k = max(int(frac * flat.numel()), 1)
    idx = torch.sort(flat.abs(), descending=True, stable=True).indices[:k]
    return flat[idx], idx.to(torch.int32)


def topk_densify(vals: torch.Tensor, idx: torch.Tensor, shape
                 ) -> torch.Tensor:
    out = torch.zeros(math.prod(shape), dtype=vals.dtype, device=vals.device)
    out[idx.long()] = vals
    return out.reshape(tuple(shape))


# ---------------------------------------------------------------------------
# Error feedback
# ---------------------------------------------------------------------------

def ef_init(params):
    """A zero f32 residual for every leaf."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _ef(grads, residual, compress):
    """(compressed-then-decompressed grads, new residual), leaf by leaf."""
    sent, res = [], []
    for g, r in zip(leaves(grads), leaves(residual), strict=True):
        corrected = g.float() + r
        dense = compress(corrected)
        sent.append(dense.to(g.dtype))
        res.append(corrected - dense)
    return unflatten(grads, sent), unflatten(grads, res)


def ef_compress_int8(grads, residual):
    return _ef(grads, residual, lambda c: dequantize_int8(*quantize_int8(c)))


def ef_compress_topk(grads, residual, frac: float = 0.05):
    return _ef(grads, residual,
               lambda c: topk_densify(*topk_sparsify(c, frac), c.shape))


# ---------------------------------------------------------------------------
# The compressed mean over a mesh axis
# ---------------------------------------------------------------------------

def _compressed_mean(xs: List[torch.Tensor]) -> torch.Tensor:
    n = len(xs)
    scale = torch.stack([_scale(x) for x in xs]).max()      # the shared scale
    acc = _quantize(xs[0], scale).to(torch.int32)
    for x in xs[1:]:
        acc = acc + _quantize(x, scale).to(torch.int32)
    return _div(acc.float() * scale, n).to(xs[0].dtype)


def _group_compressed_mean(x: torch.Tensor, mesh: GroupMesh) -> torch.Tensor:
    """``_compressed_mean`` of the group's members' ``x``, this member's
    tensor its only input: the same shared scale, the int32 sum in member
    order and the division, on x's device."""
    import torch.distributed as dist
    scale = _scale(x).reshape(1).to(mesh.comm_device)
    dist.all_reduce(scale, op=dist.ReduceOp.MAX,            # exact
                    group=mesh.group)
    scale = scale.to(x.device).reshape(())
    q = _quantize(x, scale).to(torch.int8)                   # the wire
    acc = None
    for (m,) in all_gather_tensors(mesh, [q]):
        acc = m.to(torch.int32) if acc is None else acc + m.to(torch.int32)
    return _div(acc.float() * scale, mesh.size).to(x.dtype)


def compressed_psum_int8(xs: List[torch.Tensor], mesh) -> torch.Tensor:
    """Mean of the members' tensors with an int8 payload: what every member
    holds after the JAX package's ``compressed_psum_int8``.  ``xs`` holds
    one tensor per member of a host-simulated ``mesh``, in member order;
    over a ``GroupMesh`` it is a one-element list, this process's tensor.

    Wire format per tensor: the int8 payload (summed as int32) and one f32
    scale (max-reduced), about 4x fewer bytes than an f32 all-reduce."""
    if isinstance(mesh, GroupMesh):
        if len(xs) != 1:
            raise ValueError(f"{len(xs)} tensors: a member of a GroupMesh "
                             f"passes its own, as a 1-list")
        return _group_compressed_mean(xs[0], mesh)
    if not isinstance(mesh, HostSimMesh):
        raise NotImplementedError(f"compressed_psum_int8 over {mesh!r}: it "
                                  f"runs over a HostSimMesh or a GroupMesh")
    if len(xs) != mesh.size:
        raise ValueError(f"{len(xs)} tensors for a mesh of {mesh.size}")
    return _compressed_mean(xs)


def make_crosspod_grad_transform(mesh, kind: str = "int8"):
    """``grad_transform`` hook for ``make_train_step``: each gradient leaf
    through the compressed mean over the mesh's ``pod`` axis; None for a
    mesh without one.  On a ``GroupMesh`` whose axis is ``pod`` each
    process's gradient is its member's, and the mean runs over the group.
    Otherwise the port's step holds one replicated gradient tree, so each
    leaf enters as ``pod``-many equal members, as a replicated tree enters
    the JAX package's ``shard_map``."""
    if "pod" not in mesh.axis_names:
        return None
    if isinstance(mesh, GroupMesh):
        return lambda grads: tree_map(
            lambda g: _group_compressed_mean(g, mesh), grads)
    n = axis_sizes(mesh)["pod"]

    def transform(grads):
        return tree_map(lambda g: _compressed_mean([g] * n), grads)
    return transform
