"""Meshes: the partition mesh of the multi-partition GNN path, and the
JAX package's production and host LM meshes as device-free meshes.

The partition mesh is a ``HostSimMesh`` (every partition in one process,
on one device) or a ``GroupMesh`` (one process per partition, joined by a
``torch.distributed`` group; ``launch/group.py`` spawns the processes).
A ``GroupMesh`` may span the first P ranks of a larger group: its
collectives then run on a process group of those ranks, made once per P
(``partition_group``), and the ranks past P hold no partition.
Functions (not module-level constants) so importing this module never
touches device state.  ``make_production_mesh`` and ``make_host_mesh``
return an :class:`AbstractMesh`: the axis names and sizes of the JAX
package's meshes ((16, 16) ``("data", "model")``, (2, 16, 16) ``("pod",
"data", "model")``, (1, 1)) with no devices behind them, which
``distributed/sharding.py`` resolves partition specs against and the
dry-run (launch/dryrun.py) sizes each device's share by.  ``axis_sizes``
is the one accessor of a mesh's axis sizes for every kind of mesh.
"""
from __future__ import annotations

import math
from collections.abc import Mapping
from dataclasses import dataclass, replace
from typing import Dict, Tuple

import torch


@dataclass(frozen=True)
class HostSimMesh:
    """Host-simulated device mesh for the multi-partition GNN path.

    When the process has fewer devices than partitions (one card, or the
    CPU), collectives cannot run over a device group; this stand-in carries
    the same (axis name, size) topology, and the collectives
    (distributed/collectives.py) compute their results as host-side
    arithmetic over the partitions' tensors — every partition's tensors on
    the trainer's one device.  One process holds every member: its
    ``rank`` is 0.
    """
    size: int
    axis: str = "part"
    rank = 0

    @property
    def axis_names(self):
        return (self.axis,)

    @property
    def shape(self):
        return {self.axis: self.size}


@dataclass(frozen=True)
class GroupMesh:
    """A 1-D mesh whose members are the first ``size`` processes of the
    default ``torch.distributed`` group: this process is rank ``rank`` of
    the group and, where ``rank < size``, holds member ``rank``'s tensors
    only.

    ``world_size`` is the default group's size (0: ``size``, the mesh is
    the whole group).  A mesh over fewer ranks runs its collectives on
    ``group``, the process group of ranks 0..size-1; a rank past ``size``
    holds no partition (``holds_partition``) and takes part in none of
    them.  ``world`` is the default group as a mesh, for what every rank
    must agree on.  ``comm_device`` is where the collectives' buffers
    live: the CPU under ``gloo``, this process's card under ``nccl``.  The
    collectives (distributed/collectives.py) compute on the tensors' own
    device and move only the exchanged buffers to ``comm_device``."""
    size: int
    rank: int
    axis: str
    backend: str
    comm_device: torch.device
    world_size: int = 0

    @property
    def axis_names(self):
        return (self.axis,)

    @property
    def shape(self):
        return {self.axis: self.size}

    @property
    def holds_partition(self) -> bool:
        return self.rank < self.size

    @property
    def spans_world(self) -> bool:
        return self.world_size in (0, self.size)

    @property
    def group(self):
        """The mesh's process group: None (the default group) where the
        mesh spans it, else the one ``partition_group(size)`` made."""
        if self.spans_world:
            return None
        found = _SUBGROUPS["groups"].get(self.size)
        if found is not None:
            return found
        raise RuntimeError(f"no process group of ranks 0..{self.size - 1}: "
                           f"make_partition_mesh({self.size}) makes it on "
                           f"every rank")

    @property
    def world(self) -> "GroupMesh":
        return self if self.spans_world else replace(
            self, size=self.world_size, world_size=0)


@dataclass(frozen=True)
class AbstractMesh:
    """A mesh of named axes with no devices behind it."""
    sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of an ``AbstractMesh``, a ``HostSimMesh``, a
    ``GroupMesh`` (their ``shape`` mapping), a ``DeviceMesh`` (its
    ``mesh_dim_names``) or any mesh with ``axis_names`` and a
    ``devices.shape``."""
    shape = getattr(mesh, "shape", None)
    if isinstance(shape, Mapping):
        return dict(shape)
    if getattr(mesh, "mesh_dim_names", None):
        # ``size(i)``, not ``mesh.shape``: a DeviceMesh's ``mesh`` makes a
        # tensor of its ranks at each read, which a memory trace counts
        return {a: mesh.size(i) for i, a in enumerate(mesh.mesh_dim_names)}
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """The JAX package's production mesh: a 16 x 16 pod, two with
    ``multi_pod``."""
    if multi_pod:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


def make_host_mesh() -> AbstractMesh:
    """One device, the production mesh's axis names kept."""
    return AbstractMesh((1, 1), ("data", "model"))


def _mesh_device_type(device) -> str:
    """The ``DeviceMesh`` device type for tensors on ``device``: a
    ``meta`` trace's mesh is a CPU one (its collectives never run)."""
    kind = torch.device(device).type
    return "cpu" if kind == "meta" else kind


def device_mesh(mesh, device="cuda"):
    """A ``torch.distributed`` ``DeviceMesh`` with the axis names and sizes
    of ``mesh`` (an ``AbstractMesh`` or any mesh ``axis_sizes`` reads) over
    the default group, whose size must be the mesh's, ranks laid out
    row-major (the last axis fastest, as ``jax.make_mesh`` lays devices
    out); its device type is that of the tensors it will hold."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    sizes = axis_sizes(mesh)
    n = math.prod(sizes.values())
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("device_mesh needs an initialised default "
                           "torch.distributed group")
    if dist.get_world_size() != n:
        raise ValueError(f"a mesh of {sizes} needs {n} ranks, not "
                         f"{dist.get_world_size()}")
    return DeviceMesh(_mesh_device_type(device),
                      torch.arange(n).view(*sizes.values()),
                      mesh_dim_names=tuple(sizes))


# the fake group this process made for the dry-run, {"size": ranks}
_FAKE: Dict = {"size": None}


def fake_production_mesh(multi_pod: bool = False):
    """``make_production_mesh``'s (16, 16) ``("data", "model")``, or (2,
    16, 16) ``("pod", "data", "model")``, as a ``DeviceMesh`` over a
    ``fake`` group of 256 or 512 ranks (this process is rank 0; its
    collectives move nothing), for the dry-run's trace on ``meta``
    tensors.  The group is this process's own: it is made here, or remade
    at another size, and never inside a group something else made, which
    raises ``RuntimeError``."""
    return fake_device_mesh(make_production_mesh(multi_pod=multi_pod))


def fake_device_mesh(mesh):
    """``mesh``'s axes as a ``DeviceMesh`` over a ``fake`` group of its
    size, made by this process (see ``fake_production_mesh``)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    n = math.prod(axis_sizes(mesh).values())
    if dist.is_initialized():
        if _FAKE["size"] is None:
            raise RuntimeError("a torch.distributed group made elsewhere is "
                               "running: the dry-run's fake group needs a "
                               "process of its own")
        if _FAKE["size"] != n:
            dist.destroy_process_group()
            _FAKE["size"] = None
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=n)
        _FAKE["size"] = n
    return device_mesh(mesh, "meta")


def release_fake_group():
    """Leave the fake group ``fake_device_mesh`` made in this process, if
    any (a group made elsewhere is left alone)."""
    import torch.distributed as dist
    if _FAKE["size"] is not None and dist.is_initialized():
        dist.destroy_process_group()
    _FAKE["size"] = None


def device_count(device="cuda") -> int:
    """Devices of ``device``'s kind the process sees (the CPU is one)."""
    if torch.device(device).type == "cuda":
        return torch.cuda.device_count()
    return 1


# the process groups of the first P ranks, {P: group}, of the default
# group they were made in (a new default group starts a new map)
_SUBGROUPS: Dict = {"world": None, "groups": {}}


def partition_group(size: int):
    """The process group of ranks 0..size-1 of the default group, made on
    its first call for ``size`` and cached.  ``dist.new_group`` is a
    collective of the default group: every rank calls this, for the same
    sizes in the same order, members or not."""
    import torch.distributed as dist
    if _SUBGROUPS["world"] is not dist.group.WORLD:
        _SUBGROUPS.update(world=dist.group.WORLD, groups={})
    groups = _SUBGROUPS["groups"]
    if size not in groups:
        groups[size] = dist.new_group(list(range(size)))
    return groups[size]


def world_mesh(axis: str = "part"):
    """The default ``torch.distributed`` group as a ``GroupMesh``, or None
    outside one."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return group_mesh(axis)
    return None


def group_mesh(axis: str = "part") -> GroupMesh:
    """The default ``torch.distributed`` group as a ``GroupMesh``."""
    import torch.distributed as dist
    backend = str(dist.get_backend())
    comm = (torch.device("cuda", torch.cuda.current_device())
            if backend == "nccl" else torch.device("cpu"))
    return GroupMesh(dist.get_world_size(), dist.get_rank(), axis, backend,
                     comm)


def make_partition_mesh(num_partitions: int, device="cuda",
                        axis: str = "part"):
    """1-D mesh over the data-parallel GNN partitions, decided in this
    order:

    * inside an initialised default ``torch.distributed`` group of W
      processes, a ``GroupMesh`` over its first ``num_partitions`` ranks
      (one partition a process; the group itself where W equals it, else
      ``partition_group``'s, which every rank makes here: every rank
      calls this, and ranks past ``num_partitions`` get a mesh that holds
      no partition); more partitions than W raise ``ValueError`` (the
      JAX package falls back to its host-simulated mesh there; a group
      process drives one card);
    * for one partition, or where the process sees fewer devices of
      ``device``'s kind than partitions (one card, the CPU), a
      ``HostSimMesh``: every partition on the one device, as the JAX
      package does with fewer devices than partitions;
    * a device per partition and no group raises: a process drives one
      card, and ``launch.train`` spawns one process per partition
      (``launch/group.py``) where it finds the cards."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size()
        if num_partitions > world:
            raise ValueError(f"{num_partitions} partitions in a "
                             f"torch.distributed group of {world}: a group "
                             f"holds one partition a process")
        mesh = group_mesh(axis)
        if num_partitions == world:
            return mesh
        partition_group(num_partitions)
        return replace(mesh, size=num_partitions, world_size=world)
    if num_partitions <= 1 or device_count(device) < num_partitions:
        return HostSimMesh(num_partitions, axis)
    raise RuntimeError(
        f"{num_partitions} partitions on {device_count(device)} cards need "
        f"one process per partition in a torch.distributed group: "
        f"python -m repro_torch.launch.train --partitions "
        f"{num_partitions} spawns them (launch/group.spawn_partitions)")
