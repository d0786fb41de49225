"""Named-axis device mesh — counterpart of ``deepspeed_tpu/comm/mesh.py``
(``MESH_AXES`` / ``ZERO_AXES`` / ``BATCH_AXES`` :29-39, ``MeshManager``
:101-196, ``init_mesh`` / ``get_mesh`` / ``set_mesh`` :198-215).

The JAX package lays every parallel dimension out as an axis of one
``jax.sharding.Mesh`` and runs collectives over axis names. Here the same
axes are the dims of one ``torch.distributed.device_mesh.DeviceMesh`` over
the ranks of the default process group (row-major over ``MESH_AXES``, as
``init_device_mesh`` lays it out), and an axis name, or a tuple of them,
selects a process group: a single axis the mesh's own group, a tuple of
several non-trivial axes a group made here for every such combination when
the mesh is created (every rank must create every group, in one order).

A :class:`MeshManager` also exists without a process group
(:meth:`MeshManager.from_sizes`): its axis sizes and the world sizes derived
from them work, so the partitioner can be driven in one process, and a
collective over an axis of size 1 is the identity; a collective over a
larger axis raises.
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from ..utils.logging import log_dist

MESH_AXES: Tuple[str, ...] = ("data", "zero_shard", "expert", "pipe", "seq",
                              "tensor")

# ZeRO shards parameters and optimizer state over the whole data-parallel
# product; 'zero_shard' is the MiCS / hpZ sub-axis of data (not ported: its
# size stays 1)
ZERO_AXES: Tuple[str, ...] = ("data", "zero_shard", "expert", "seq")
# the micro-batch's leading dim is split over these
BATCH_AXES: Tuple[str, ...] = ("data", "zero_shard", "expert")

AxisName = Union[str, Sequence[str]]

_global_mesh: Optional["MeshManager"] = None


def _names(axis: AxisName) -> Tuple[str, ...]:
    names = (axis,) if isinstance(axis, str) else tuple(axis)
    bad = [a for a in names if a not in MESH_AXES]
    if bad:
        raise ValueError(f"unknown mesh axes {bad} (axes: {MESH_AXES})")
    return names


@dataclass
class MeshManager:
    """The axis sizes, and over a process group the ``DeviceMesh`` and the
    groups of tuple axes. The reference's ``groups._get_*_world_size()``
    helpers are properties here."""

    sizes: Dict[str, int]
    device_mesh: Optional[object] = None        # DeviceMesh over MESH_AXES
    groups: Dict[Tuple[str, ...], object] = field(default_factory=dict)

    @staticmethod
    def _sizes(axis_sizes: Dict[str, int]) -> Dict[str, int]:
        _names(tuple(axis_sizes))
        sizes = {a: int(axis_sizes.get(a, 1)) for a in MESH_AXES}
        if any(s < 1 for s in sizes.values()):
            raise ValueError(f"mesh sizes must be positive: {sizes}")
        return sizes

    @classmethod
    def from_sizes(cls, axis_sizes: Dict[str, int]) -> "MeshManager":
        """A mesh of sizes only, with no process group behind it."""
        return cls(sizes=cls._sizes(axis_sizes))

    @classmethod
    def create(cls, axis_sizes: Dict[str, int],
               device_type: Optional[str] = None) -> "MeshManager":
        """The mesh over the default process group, whose world size must
        be the product of the sizes. ``device_type`` defaults to ``cuda``
        for an NCCL group and ``cpu`` otherwise."""
        sizes = cls._sizes(axis_sizes)
        total = math.prod(sizes.values())
        if not dist.is_initialized():
            raise RuntimeError(f"mesh {sizes} needs a process group: call "
                               "comm.init_distributed() first (or "
                               "MeshManager.from_sizes for sizes alone)")
        world = dist.get_world_size()
        if total != world:
            raise ValueError(f"mesh sizes {sizes} product {total} != world size {world}")
        from torch.distributed.device_mesh import init_device_mesh

        if device_type is None:
            device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
        dm = init_device_mesh(device_type, tuple(sizes[a] for a in MESH_AXES),
                              mesh_dim_names=MESH_AXES)
        # groups over two or more non-trivial axes (in MESH_AXES order);
        # each new_subgroups call is collective over the world
        live = [a for a in MESH_AXES if sizes[a] > 1]
        ranks = torch.arange(world).reshape([sizes[a] for a in MESH_AXES])
        groups = {}
        for n in range(2, len(live) + 1):
            for combo in itertools.combinations(live, n):
                dims = [MESH_AXES.index(a) for a in combo]
                rest = [d for d in range(len(MESH_AXES)) if d not in dims]
                rows = ranks.permute(rest + dims).reshape(-1, math.prod(
                    sizes[a] for a in combo)).tolist()
                groups[combo], _ = dist.new_subgroups_by_enumeration(rows)
        log_dist(f"mesh {sizes} over {world} ranks ({dist.get_backend()}, {device_type})")
        return cls(sizes=sizes, device_mesh=dm, groups=groups)

    # --- axis sizes (groups.py parity) ---
    def axis_size(self, axis: AxisName) -> int:
        return math.prod(self.sizes[a] for a in _names(axis))

    @property
    def dp_world_size(self) -> int:
        """Replication degree of the batch: the product of BATCH_AXES."""
        return self.axis_size(BATCH_AXES)

    @property
    def zero_world_size(self) -> int:
        return self.axis_size(ZERO_AXES)

    @property
    def mics_shard_size(self) -> int:
        return self.sizes["zero_shard"]

    @property
    def tp_world_size(self) -> int:
        return self.sizes["tensor"]

    @property
    def pp_world_size(self) -> int:
        return self.sizes["pipe"]

    @property
    def sp_world_size(self) -> int:
        return self.sizes["seq"]

    @property
    def ep_world_size(self) -> int:
        return self.sizes["expert"]

    @property
    def world_size(self) -> int:
        return math.prod(self.sizes.values())

    # --- process groups ---
    def group(self, axis: AxisName):
        """The process group of ``axis`` (a name or a tuple of names, in
        ``MESH_AXES`` order), or ``None`` when the mesh has no process group
        and the axis has one member. Raises for a larger axis without one."""
        names = _names(axis)
        live = tuple(a for a in names if self.sizes[a] > 1)
        if self.device_mesh is None:
            if live:
                raise RuntimeError(f"axis {names} has {self.axis_size(names)} members "
                                   "but the mesh has no process group")
            return None
        if len(live) > 1:
            if live not in self.groups:
                raise ValueError(f"axes {names} are not in MESH_AXES order {MESH_AXES}")
            return self.groups[live]
        # one live axis, or none: its (or the first axis's) group of size 1
        return self.device_mesh.get_group((live or names)[0])

    def axis_index(self, axis: AxisName) -> int:
        """This rank's index along ``axis`` (row-major over a tuple)."""
        names = _names(axis)
        if self.device_mesh is None:
            return 0
        coord = self.device_mesh.get_coordinate()
        idx = 0
        for a in names:
            idx = idx * self.sizes[a] + coord[MESH_AXES.index(a)]
        return idx


def init_mesh(axis_sizes: Dict[str, int], device_type: Optional[str] = None) -> MeshManager:
    """Build the mesh over the default process group and install it."""
    global _global_mesh
    _global_mesh = MeshManager.create(axis_sizes, device_type)
    return _global_mesh


def get_mesh() -> MeshManager:
    """The installed mesh; without one, a ``data`` mesh over every rank of
    the process group (or a one-member mesh of sizes when there is none)."""
    global _global_mesh
    if _global_mesh is None:
        if dist.is_initialized():
            _global_mesh = MeshManager.create({"data": dist.get_world_size()})
        else:
            _global_mesh = MeshManager.from_sizes({"data": 1})
    return _global_mesh


def set_mesh(mm: Optional[MeshManager]) -> None:
    """Install (or with None, reset) the process-global mesh."""
    global _global_mesh
    _global_mesh = mm
