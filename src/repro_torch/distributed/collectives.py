"""Collectives over the partition mesh (launch/mesh.py): the
multi-partition GNN path's gradient mean-all-reduce and bounded halo
exchange, the sequence-sharded decode attention with its softmax combine
(``flash_decode_attention``), and the analytic bytes of a quantized
all-reduce.

Two meshes, one result.  On a ``HostSimMesh`` every member's tensors lie
on the caller's one device and each collective computes its result as the
JAX package's host-sim branch does — the same arithmetic in the same
order, so the mean is bit-equal to the JAX twin's on the CPU.  On a
``GroupMesh`` each process holds its own member: the members' tensors
travel through ``torch.distributed`` (an ``all_gather`` of their bytes on
the mesh's ``comm_device``, or an ``all_to_all``), and each process then
runs the host-sim arithmetic, in member order, on the tensors' own
device.  So every member of a group holds what the host-simulated mesh
computes on that device, bit for bit.  A mesh over the first P ranks of a
larger group runs each collective on its own process group
(``GroupMesh.group``), sized by the mesh; a rank that holds no partition
calls none of them.  ``broadcast_object`` runs over any ``GroupMesh``,
the world's (``GroupMesh.world``) included.  No reduction runs inside the
transport (``all_reduce(SUM)``'s ring and tree orders are not member
order); only ``compressed_psum_int8``'s max, which is exact, does.

``CollectiveTraffic`` counts the collectives the sharded LM step issues
(DTensor's functional collectives), by op and bytes, with the JAX
package's volume model: the dry-run's ``collective_bytes_per_device``
(launch/dryrun.py) and a real rank's own traffic (launch/group.py) read
the same counter.
"""
from __future__ import annotations

import math
from collections import defaultdict
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.launch.mesh import GroupMesh, HostSimMesh, axis_sizes
from repro_torch.models.params import leaves, unflatten


def _is_group(mesh) -> bool:
    """True for a ``GroupMesh``, False for a host-simulated one (or none);
    any other mesh (a device-free ``AbstractMesh``) holds no tensors."""
    if isinstance(mesh, GroupMesh):
        if not mesh.holds_partition:
            raise ValueError(f"rank {mesh.rank} holds no member of a "
                             f"{mesh.size}-member mesh")
        return True
    if mesh is None or isinstance(mesh, HostSimMesh):
        return False
    raise NotImplementedError(f"collectives over {mesh!r}: they run over a "
                              f"HostSimMesh or a GroupMesh")


def all_gather_tensors(mesh: GroupMesh, xs: List[torch.Tensor]
                       ) -> List[List[torch.Tensor]]:
    """Every member's ``xs``: ``out[r][i]`` is member r's ``xs[i]``, on
    ``xs[i]``'s device with its dtype and shape.  One ``all_gather`` of the
    tensors' bytes (uint8) on ``mesh.comm_device``; every member passes
    tensors of the same shapes and dtypes.  The member's own come back
    bit for bit."""
    import torch.distributed as dist
    _is_group(mesh)
    flat = [x.detach().contiguous().reshape(-1).view(torch.uint8) for x in xs]
    sizes = [f.numel() for f in flat]
    buf = torch.cat(flat).to(mesh.comm_device)
    got = [torch.empty_like(buf) for _ in range(mesh.size)]
    dist.all_gather(got, buf, group=mesh.group)
    return [[p.clone().view(x.dtype).reshape(x.shape).to(x.device)
             for p, x in zip(torch.split(g, sizes), xs, strict=True)]
            for g in got]


def all_gather_objects(mesh, value: Any) -> List[Any]:
    """``value`` of every process of the mesh, in rank order (pickled over
    the group); ``[value]`` on a host-simulated mesh, whose one process
    holds every partition."""
    if not _is_group(mesh):
        return [value]
    import torch.distributed as dist
    out = [None] * mesh.size
    dist.all_gather_object(out, value, group=mesh.group)
    return out


def agree(mesh, what: str, value: Any):
    """Raise ``RuntimeError`` unless every process of the mesh holds an
    equal ``value`` (a collective over a group; nothing on a
    host-simulated mesh)."""
    values = all_gather_objects(mesh, value)
    if any(v != values[0] for v in values):
        raise RuntimeError(f"{what}: the processes disagree ({values})")


def broadcast_object(mesh, value: Any, src: int = 0) -> Any:
    """Rank ``src``'s ``value`` on every process of the mesh (pickled over
    its group); ``value`` itself on a host-simulated mesh.  Every process
    passes a value; only ``src``'s is read."""
    if not _is_group(mesh):
        return value
    import torch.distributed as dist
    box = [value]
    dist.broadcast_object_list(box, src=src, group=mesh.group)
    return box[0]


def barrier(mesh):
    """Wait for every process of a ``GroupMesh``; nothing on a
    host-simulated mesh."""
    if not _is_group(mesh):
        return
    import torch.distributed as dist
    if mesh.backend == "nccl":
        dist.barrier(group=mesh.group, device_ids=[mesh.comm_device.index])
    else:
        dist.barrier(group=mesh.group)


def _partial_attend(q, k, v, mask):
    """Attention over one member's time slice.

    q (B, H, Dh); k/v (B, Tl, H, Dh); mask (B, Tl) True = valid.  Returns
    (o (B, H, Dh) f32, the numerator at the local max; m (B, H) the local
    max; denom (B, H) the local sum of exp)."""
    scores = torch.einsum("bhe,bthe->bht", q, k).float()
    scores = torch.where(mask[:, None, :], scores,
                         torch.full((), -1e30, device=q.device))
    m = scores.amax(dim=-1)                                  # (B, H)
    p = torch.exp(scores - m[..., None])
    p = torch.where(mask[:, None, :], p, torch.zeros((), device=q.device))
    denom = p.sum(dim=-1)                                    # (B, H)
    o = torch.einsum("bht,bthe->bhe", p.to(v.dtype), v)
    return o.float(), m, denom


def _combine(parts, dtype):
    """The members' partial (o, m, denom) in member order → the attention:
    the global max, each part rescaled to it, numerators and denominators
    summed."""
    g_max = parts[0][1]
    for _, m, _ in parts[1:]:
        g_max = torch.maximum(g_max, m)
    num = den = None
    for o, m, denom in parts:
        w = torch.exp(m - g_max)
        num = o * w[..., None] if num is None else num + o * w[..., None]
        den = denom * w if den is None else den + denom * w
    return (num / torch.clamp(den[..., None], min=1e-30)).to(dtype)


def flash_decode_attention(mesh, axis: str = "model"):
    """Sequence-sharded single-token attention with a max-rescaled softmax
    combine, over the ``axis`` members of the mesh.

    Returns ``fn(q, k, v, pos)``: q (B, H, Dh); the caches k/v (B, T, H,
    Dh), T split into one slice per member; pos (B,) each row's last valid
    position.  Each member attends over its slice with the ``(base + t) <=
    pos`` mask, then the partial (o, m, denom) combine in member order:
    the global max, each part rescaled to it, the numerators and the
    denominators summed.  Output (B, H, Dh) in v's dtype.  Plain torch, as
    the JAX package's is jnp.  On a ``GroupMesh`` every process passes the
    whole cache and attends over its own member's slice only; the partial
    (o, m, denom) are all the traffic (B·H·(Dh + 2) floats a member, not
    the cache), and every process returns the combined attention."""
    group = _is_group(mesh)
    n = axis_sizes(mesh)[axis]

    def partial(q, k, v, pos, s, Tl):
        t = s * Tl + torch.arange(Tl, device=k.device)
        mask = t[None, :] <= pos[:, None]
        return _partial_attend(q, k[:, s * Tl:(s + 1) * Tl],
                               v[:, s * Tl:(s + 1) * Tl], mask)

    def attend(q, k, v, pos):
        T = k.shape[1]
        if T % n:
            raise ValueError(f"cache length {T} does not split into {n}")
        Tl = T // n
        if group:
            parts = all_gather_tensors(
                mesh, list(partial(q, k, v, pos, mesh.rank, Tl)))
        else:
            parts = [partial(q, k, v, pos, s, Tl) for s in range(n)]
        return _combine(parts, v.dtype)
    return attend


def quantized_allreduce_bytes(shape, n_devices: int, bits: int = 8) -> float:
    """Analytic bytes a device sends in a ring all-reduce of a tensor of
    ``shape`` with a ``bits``-wide payload."""
    payload = float(math.prod(shape)) * bits / 8
    return 2.0 * payload * (n_devices - 1) / n_devices


def grad_allreduce(mesh):
    """Mean-all-reduce over per-partition gradient trees (data-parallel GNN
    scale-out, core/multipart.py).

    Returns ``fn(trees) -> tree`` averaging identically-structured gradient
    trees, one per partition: ``sum(xs) / n`` leaf by leaf, summed in
    partition order from Python's 0 (so a -0.0 mean is +0.0).  On a
    host-simulated mesh ``trees`` holds every partition's tree; on a
    ``GroupMesh`` it is a one-element list, this process's tree, and every
    process gets the same mean (one ``all_gather`` of the tree's bytes,
    then the same sum on the leaves' device).  One partition's tree comes
    back as it is."""
    group = _is_group(mesh)

    def host_mean(trees: List):
        n = float(len(trees))
        if len(trees) == 1:
            return trees[0]
        return unflatten(trees[0], [sum(xs) / n for xs in
                                    zip(*map(leaves, trees), strict=True)])

    def group_mean(trees: List):
        if len(trees) != 1:
            raise ValueError(f"{len(trees)} gradient trees: a member of a "
                             f"GroupMesh passes its own, as a 1-list")
        members = all_gather_tensors(mesh, leaves(trees[0]))
        return host_mean([unflatten(trees[0], m) for m in members])
    return group_mean if group else host_mean


def _routing(plan):
    """Global→local index map plus, per (src q → dst p) pair, the rows
    q sends (q-local ids) and where p scatters them (halo positions)."""
    parts = plan.parts
    loc = np.zeros(len(plan.owner), np.int64)
    for ns in plan.node_sets:
        loc[ns] = np.arange(len(ns))
    send = [[None] * parts for _ in range(parts)]   # send[q][p]
    put = [[None] * parts for _ in range(parts)]    # put[p][q]
    for p, hs in enumerate(plan.halo_sets):
        owners = plan.owner[hs] if len(hs) else np.zeros(0, np.int32)
        for q in range(parts):
            pos = np.where(owners == q)[0]
            send[q][p] = loc[hs[pos]]
            put[p][q] = pos
    return send, put


def _volume(plan, feat_dim: int) -> int:
    return plan.halo_rows * feat_dim * 4


def halo_all_to_all(mesh):
    """Bounded halo-feature exchange over the partition mesh.

    Returns ``fn(plan, part_feats) -> (halo_feats, volume_bytes)`` where
    ``part_feats[p]`` are partition p's OWNED feature rows in local order
    and ``halo_feats[p]`` are the rows for ``plan.halo_sets[p]`` in halo
    order — every row is owned by another partition, so all of them cross
    a boundary (``volume_bytes`` counts exactly that traffic, the HitGNN
    inter-device term the ``halo_budget`` knob caps).  On a host-simulated
    mesh the routing runs as host-side numpy gathers, row for row those of
    the JAX package.  On a ``GroupMesh`` it runs as the JAX package's
    real-mesh exchange does: member r reads only ``part_feats[r]``, packs
    the rows it ships to each member into a (parts, pad, F) buffer padded
    to the largest pair, ``all_to_all_single`` swaps the blocks, and only
    ``halo_feats[r]`` is filled (the other entries are None); the rows are
    the same, bit for bit."""
    if _is_group(mesh):
        return _group_exchange(mesh)

    def host_exchange(plan, part_feats):
        send, put = _routing(plan)
        halo_feats = []
        for p, hs in enumerate(plan.halo_sets):
            rows = np.zeros((len(hs), part_feats[p].shape[1]), np.float32)
            for q in range(plan.parts):
                if len(put[p][q]):
                    rows[put[p][q]] = part_feats[q][send[q][p]]
            halo_feats.append(rows)
        return halo_feats, _volume(plan, part_feats[0].shape[1])
    return host_exchange


def _group_exchange(mesh: GroupMesh):
    import torch.distributed as dist
    r = mesh.rank

    def exchange(plan, part_feats):
        if plan.parts != mesh.size:
            raise ValueError(f"plan has {plan.parts} partitions for a "
                             f"{mesh.size}-member group")
        send, put = _routing(plan)
        own = np.asarray(part_feats[r])
        feat_dim = own.shape[1]
        pad = max((len(send[q][p]) for q in range(plan.parts)
                   for p in range(plan.parts)), default=0)
        halo_feats = [None] * plan.parts
        if pad == 0:
            halo_feats[r] = np.zeros((0, feat_dim), np.float32)
            return halo_feats, 0
        buf = np.zeros((plan.parts, pad, feat_dim), np.float32)
        for p in range(plan.parts):            # block p: rows r ships to p
            buf[p, :len(send[r][p])] = own[send[r][p]]
        out = torch.from_numpy(buf).to(mesh.comm_device)
        got = torch.empty_like(out)
        dist.all_to_all_single(got, out,       # got[q] = block q shipped to r
                               group=mesh.group)
        recv = got.cpu().numpy()
        rows = np.zeros((len(plan.halo_sets[r]), feat_dim), np.float32)
        for q in range(plan.parts):
            if len(put[r][q]):
                rows[put[r][q]] = recv[q, :len(put[r][q])]
        halo_feats[r] = rows
        return halo_feats, _volume(plan, feat_dim)
    return exchange


# ---------------------------------------------------------------------------
# The traffic of the sharded step
# ---------------------------------------------------------------------------

# DTensor's functional collectives → the JAX package's op names, each with
# its volume factor (``src/repro/launch/dryrun.py:62-69``: result bytes,
# twice for a reduction; ring algorithms, (n-1)/n taken as 1)
_TRAFFIC_OPS = {
    "all_gather_into_tensor": ("all-gather", 1),
    "all_gather_into_tensor_coalesced": ("all-gather", 1),
    "all_reduce": ("all-reduce", 2),
    "all_reduce_coalesced": ("all-reduce", 2),
    "reduce_scatter_tensor": ("reduce-scatter", 2),
    "reduce_scatter_tensor_coalesced": ("reduce-scatter", 2),
    "all_to_all_single": ("all-to-all", 1),
    "shard_dim_alltoall": ("all-to-all", 1),
}


def _group_size(func, args) -> int:
    """The size of the group a functional collective runs over (its last
    argument names it)."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    name = args[-1]
    if isinstance(name, str):
        return _resolve_process_group(name).size()
    return name.size()


class CollectiveTraffic:
    """Counts, while entered, the functional collectives that DTensor
    issues beneath it, by the JAX package's op names: ``per_op`` {op:
    bytes} and ``counts`` {op: calls}, ``total`` their sum.  An op's bytes
    are its result's, twice for ``all-reduce`` and ``reduce-scatter``; a
    collective over a group of one moves nothing and is not counted.  A
    ``TorchDispatchMode`` that lets DTensor run first (it returns
    ``NotImplemented`` to a DTensor), so it sees the collectives of the
    redistributions DTensor makes.  With ``sites``, ``summary()`` also
    lists every collective with the port's innermost frames that issued it
    (``sites``: op, bytes, shape, dtype, ``at``)."""

    def __init__(self, sites: bool = False):
        self.per_op: Dict[str, int] = defaultdict(int)
        self.counts: Dict[str, int] = defaultdict(int)
        self.sites: Optional[list] = [] if sites else None
        self._mode = None

    @property
    def total(self) -> int:
        return sum(self.per_op.values())

    def summary(self) -> dict:
        out = {"per_op": dict(self.per_op), "counts": dict(self.counts),
               "total": self.total}
        if self.sites is not None:
            out["sites"] = self.sites
        return out

    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        counter = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if any(t.__name__ == "DTensor" for t in types):
                    return NotImplemented
                out = func(*args, **(kwargs or {}))
                counter._saw(func, args, out)
                return out
        self._mode = _Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)
        self._mode = None
        return False

    def _saw(self, func, args, out):
        ns = func.namespace
        if ns not in ("_c10d_functional", "_dtensor"):
            return
        kind = _TRAFFIC_OPS.get(func._opname)
        if kind is None or _group_size(func, args) <= 1:
            return
        op, factor = kind
        outs = out if isinstance(out, (list, tuple)) else [out]
        nbytes = factor * sum(o.numel() * o.element_size() for o in outs)
        self.per_op[op] += nbytes
        self.counts[op] += 1
        if self.sites is not None:
            import traceback
            # the port's frames, less its dispatch modes' own
            at = [f"{f.filename.split('repro_torch/')[-1]}:{f.lineno} "
                  f"{f.name}" for f in traceback.extract_stack()
                  if "repro_torch/" in f.filename
                  and not f.filename.endswith(("distributed/collectives.py",
                                               "launch/footprint.py"))]
            self.sites.append({"op": op, "bytes": nbytes,
                               "shape": list(outs[0].shape),
                               "dtype": str(outs[0].dtype).split(".")[-1],
                               "at": at[-3:]})
