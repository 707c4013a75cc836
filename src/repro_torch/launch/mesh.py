"""The partition mesh of the multi-partition GNN path.

A function (not a module-level constant) so importing this module never
touches device state.  Only the partition mesh is here: the JAX package's
production and host LM meshes are LM sharding, which the port has not
taken (ROADMAP.md, slice 8).
"""
from __future__ import annotations

from dataclasses import dataclass

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
