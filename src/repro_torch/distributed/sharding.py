"""Logical→physical sharding resolution, as spec arithmetic with no devices.

A port of ``src/repro/distributed/sharding.py``.  The model zoo declares
shardings with *logical* axis names (models/params.py); this module
resolves them against a mesh's axis names and sizes, per architecture:

  * ``fsdp``   → the ``data`` mesh axis (ZeRO-3 parameter sharding; on a
    multi-pod mesh sharded within a pod, replicated across pods).
  * ``tp``     → the ``model`` mesh axis.
  * ``tp_kv``  → ``model`` iff num_kv_heads divides the model-axis size,
    else replicated.
  * ``expert`` → the ``model`` mesh axis (expert parallelism).
  * ``dp``     → ``("pod", "data")`` on multi-pod meshes, else ``data``.
  * ``kvseq``  → ``model`` when the config selects sequence-sharded KV
    (``kv_shard == "sequence"``, or ``auto`` with kv heads indivisible).

The specs serve two things.  The dry-run's memory accounting
(launch/dryrun.py) sizes each device's share of every tensor by them
(``shard_bytes``).  And the sharded LM step places its tensors by them as
``torch.distributed.tensor`` DTensors, PyTorch's counterpart of JAX's
``NamedSharding``: ``placements`` turns a physical spec into DTensor
placements over a ``DeviceMesh`` with the mesh's axis names (a mesh axis
named in dim i is ``Shard(i)``; ``("pod", "data")`` on one dim is
``Shard(i)`` on both), and ``constrain`` is JAX's
``with_sharding_constraint``: inside a ``shard_ctx`` that holds a
``DeviceMesh``, a DTensor is redistributed to the spec's placements.  On a
plain tensor, or with no ``DeviceMesh`` installed, ``constrain`` is an
identity, so the one-card paths run as they are.  ``shardings_of`` returns
the spec tree.  ``P`` stands in for JAX's ``PartitionSpec``; two specs are
equal when they agree with trailing ``None``s dropped and a one-name tuple
read as the name.  The mesh is any of ``launch/mesh.py``'s
(``axis_sizes``).
"""
from __future__ import annotations

from contextlib import ExitStack
from typing import Any, Dict, Optional

from repro_torch.launch.mesh import axis_sizes
from repro_torch.models.params import ParamDecl, tree_map


class P:
    """A partition spec: per dimension ``None`` (replicated), a mesh axis
    name, or a tuple of names."""

    __slots__ = ("axes",)

    def __init__(self, *axes):
        self.axes = tuple(tuple(a) if isinstance(a, list) else a
                          for a in axes)

    def __iter__(self):
        return iter(self.axes)

    def __len__(self):
        return len(self.axes)

    def __getitem__(self, i):
        return self.axes[i]

    def normalized(self) -> tuple:
        out = [a[0] if isinstance(a, tuple) and len(a) == 1 else a
               for a in self.axes]
        while out and out[-1] is None:
            out.pop()
        return tuple(out)

    def __eq__(self, other):
        if isinstance(other, P):
            return self.normalized() == other.normalized()
        if isinstance(other, tuple):
            return self.normalized() == P(*other).normalized()
        return NotImplemented

    def __hash__(self):
        return hash(self.normalized())

    def __repr__(self):
        return f"P{self.axes!r}" if len(self.axes) != 1 else \
            f"P({self.axes[0]!r})"


def make_rules(cfg, mesh) -> Dict[str, Any]:
    sizes = axis_sizes(mesh)
    model_size = sizes.get("model", 1)
    multi_pod = "pod" in sizes

    kv_heads = getattr(cfg, "num_kv_heads", 0) or 0
    q_heads = getattr(cfg, "num_heads", 0) or 0
    if getattr(cfg, "pad_head_groups", False) and kv_heads:
        from repro_torch.models.layers import padded_heads
        q_heads = padded_heads(cfg, model_size)
    kv_div = kv_heads > 0 and kv_heads % model_size == 0
    q_div = q_heads > 0 and q_heads % model_size == 0
    kv_shard = getattr(cfg, "kv_shard", "auto")
    if kv_shard == "auto":
        kv_shard = "heads" if kv_div else "sequence"
    if kv_shard == "replicated":
        kv_shard = "none"

    return {
        "dp": ("pod", "data") if multi_pod else "data",
        "fsdp": "data" if getattr(cfg, "fsdp_params", True) else None,
        "tp": "model",
        "tp_kv": "model" if kv_div else None,
        "qheads": "model" if q_div else None,
        "expert": "model",
        "kvseq": "model" if kv_shard == "sequence" else None,
        # kv-head axis of the decode cache: shardable only in heads mode
        "kvheads": "model" if (kv_shard == "heads" and kv_div) else None,
        # decode: repeated-KV layout — shard time XOR heads, never both
        "dkr_t": "model" if kv_shard == "sequence" else None,
        "dkr_h": "model" if (kv_shard != "sequence" and q_div) else None,
        "seq": None,            # training activations: sequence replicated
        "vocab": ("model"
                  if getattr(cfg, "vocab_size", 0) % model_size == 0 else None),
    }


def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    sizes = axis_sizes(mesh)
    if isinstance(axes, (tuple, list)):
        n = 1
        for a in axes:
            n *= sizes.get(a, 1)
        return n
    return sizes.get(axes, 1)


def enforce_divisible(spec: P, shape, mesh) -> P:
    """Drop sharding on any dim the mesh axis doesn't divide evenly."""
    out = []
    for i, dim in enumerate(shape):
        ax = spec[i] if i < len(spec) else None
        if ax is not None and dim % _axis_size(mesh, ax) != 0:
            ax = None
        out.append(ax)
    return P(*out)


def resolve_spec(logical: P, rules: Dict[str, Any]) -> P:
    out = []
    for ax in logical:
        if ax is None:
            out.append(None)
        elif isinstance(ax, (tuple, list)):
            phys = []
            for a in ax:
                r = rules.get(a, None)
                if r is None:
                    continue
                phys.extend(r if isinstance(r, tuple) else (r,))
            out.append(tuple(phys) if phys else None)
        else:
            out.append(rules.get(ax, None))
    return P(*out)


def physical_specs(decls_or_logical, cfg, mesh):
    """Resolve a tree of ParamDecl (or logical ``P``) to physical specs; a
    declaration's spec drops any sharding that does not divide its dim."""
    rules = make_rules(cfg, mesh)

    def one(x):
        if isinstance(x, ParamDecl):
            return enforce_divisible(resolve_spec(P(*x.axes), rules),
                                     x.shape, mesh)
        return resolve_spec(x, rules)
    return tree_map(one, decls_or_logical)


def shardings_of(specs, mesh):
    """The spec tree itself: the port places nothing by it."""
    return specs


def batch_spec(cfg, mesh) -> P:
    return resolve_spec(P("dp", None), make_rules(cfg, mesh))


def dp_size(mesh) -> int:
    sizes = axis_sizes(mesh)
    return sizes.get("data", 1) * sizes.get("pod", 1)


def shard_bytes(shape, dtype_size: int, spec: P, mesh) -> int:
    """One device's bytes of a tensor of ``shape`` laid out by ``spec``:
    each dim divided by the size of its mesh axes (``spec`` divides them:
    ``enforce_divisible``)."""
    n = dtype_size
    for i, dim in enumerate(shape):
        n *= dim // _axis_size(mesh, spec[i] if i < len(spec) else None)
    return n


def placements(spec: P, device_mesh) -> tuple:
    """A physical spec as DTensor placements over ``device_mesh``, one a
    mesh dim: ``Shard(i)`` where dim i names the mesh axis (alone or in a
    tuple), ``Replicate()`` where no dim does or the axis has size 1 (a
    one-wide axis holds the whole dim, as in JAX)."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(device_mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for i, ax in enumerate(spec):
        for a in ax if isinstance(ax, tuple) else (ax,):
            if a is not None and device_mesh.size(names.index(a)) > 1:
                out[names.index(a)] = Shard(i)
    return tuple(out)


def shard_axis(x, dim: int):
    """The first mesh dim on which the DTensor ``x`` is sharded along its
    dim ``dim``, or None."""
    for j, pl in enumerate(x.placements):
        if pl.is_shard(dim):
            return j
    return None


def is_dtensor(x) -> bool:
    """Whether ``x`` is a ``torch.distributed.tensor.DTensor`` (without
    importing the DTensor package for a plain tensor)."""
    return type(x).__name__ == "DTensor" and hasattr(x, "placements")


# ---------------------------------------------------------------------------
# Sharding context: the mesh and rules the model code reads (``ctx_dp_size``
# groups the MoE's tokens by it; ``constrain`` places DTensors by it).
# Unset, every size is 1 and ``constrain`` does nothing.
# ---------------------------------------------------------------------------

class _ShardCtx:
    mesh: Optional[Any] = None
    rules: Optional[Dict[str, Any]] = None
    device_mesh: Optional[Any] = None


_CTX = _ShardCtx()


class shard_ctx:
    """Context manager installing (mesh, rules) for ``ctx_dp_size`` and,
    with a ``device_mesh`` (a ``DeviceMesh`` of ``mesh``'s axis names and
    sizes), the mesh ``constrain`` places DTensors on.  With a
    ``device_mesh`` it also enters DTensor's ``implicit_replication``, so
    the tensors the model makes itself (RoPE tables, masks, positions) act
    as replicated operands beside the DTensors."""

    def __init__(self, cfg, mesh, device_mesh=None):
        self.mesh = mesh
        self.rules = make_rules(cfg, mesh)
        self.device_mesh = device_mesh
        if device_mesh is not None and \
                axis_sizes(mesh) != axis_sizes(device_mesh):
            raise ValueError(f"device mesh {axis_sizes(device_mesh)} is not "
                             f"the mesh {axis_sizes(mesh)}")

    def __enter__(self):
        self._saved = (_CTX.mesh, _CTX.rules, _CTX.device_mesh)
        _CTX.mesh, _CTX.rules = self.mesh, self.rules
        _CTX.device_mesh = self.device_mesh
        self._stack = ExitStack()
        if self.device_mesh is not None:
            from torch.distributed.tensor.experimental import \
                implicit_replication
            self._stack.enter_context(implicit_replication())
        return self

    def __exit__(self, *exc):
        self._stack.close()
        _CTX.mesh, _CTX.rules, _CTX.device_mesh = self._saved
        return False


def constrain(x, *logical_axes):
    """JAX's ``constrain``: inside a ``shard_ctx`` with a ``DeviceMesh``, a
    DTensor ``x`` redistributed to the placements of its logical spec
    (resolved by the context's rules, any dim the mesh does not divide
    replicated); anything else returned as it is."""
    if _CTX.device_mesh is None or not is_dtensor(x):
        return x
    spec = enforce_divisible(resolve_spec(P(*logical_axes), _CTX.rules),
                             x.shape, _CTX.mesh)
    want = placements(spec, _CTX.device_mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(_CTX.device_mesh, want)


def ctx_dp_size() -> int:
    if _CTX.mesh is None:
        return 1
    return dp_size(_CTX.mesh)


def ctx_axis_size(axis: str) -> int:
    if _CTX.mesh is None:
        return 1
    return axis_sizes(_CTX.mesh).get(axis, 1)
