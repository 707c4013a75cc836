"""Meshes: the partition mesh of the multi-partition GNN path, and the
JAX package's production and host LM meshes as device-free meshes.

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
from dataclasses import dataclass
from typing import Dict, Tuple

import torch

MULTI_CARD = ("a mesh of one card per partition is not ported yet — see "
              "ROADMAP.md (the real multi-card grad_allreduce and "
              "halo_all_to_all)")


@dataclass(frozen=True)
class HostSimMesh:
    """Host-simulated device mesh for the multi-partition GNN path.

    When the process has fewer devices than partitions (one card, or the
    CPU), collectives cannot run over a device group; this stand-in carries
    the same (axis name, size) topology, and the collectives
    (distributed/collectives.py) compute their results as host-side
    arithmetic over the partitions' tensors — every partition's tensors on
    the trainer's one device.
    """
    size: int
    axis: str = "part"

    @property
    def axis_names(self):
        return (self.axis,)

    @property
    def shape(self):
        return {self.axis: self.size}


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
    """{axis name: size} of an ``AbstractMesh``, a ``HostSimMesh`` (their
    ``shape`` mapping) or any mesh with ``axis_names`` and a
    ``devices.shape``."""
    shape = getattr(mesh, "shape", None)
    if isinstance(shape, Mapping):
        return dict(shape)
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


def device_count(device="cuda") -> int:
    """Devices of ``device``'s kind the process sees (the CPU is one)."""
    if torch.device(device).type == "cuda":
        return torch.cuda.device_count()
    return 1


def make_partition_mesh(num_partitions: int, device="cuda",
                        axis: str = "part"):
    """1-D mesh over the data-parallel GNN partitions.

    ``HostSimMesh`` when the process sees fewer devices of ``device``'s kind
    than partitions, and for one partition (a mean over one tree and an
    exchange with no peer need no device group): the one-card machine and
    the CPU always take it.  With a device per partition the real mesh
    would be a ``torch.distributed`` group, which is not ported: that
    raises rather than quietly running the partitions on one device."""
    if num_partitions <= 1 or device_count(device) < num_partitions:
        return HostSimMesh(num_partitions, axis)
    raise NotImplementedError(f"{num_partitions} partitions on "
                              f"{device_count(device)} devices: {MULTI_CARD}")
