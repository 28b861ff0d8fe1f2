"""Named logical parallelism axes (counterpart of
``ray_tpu/parallel/mesh.py``).

``MeshSpec`` is copied (``ray_tpu/parallel/mesh.py:25``, numpy only).
A JAX mesh is an array of devices with named axes, and one program runs
over it.  The port runs one process per rank, so its ``Mesh`` is a small
class of its own (not ``torch.distributed.device_mesh``, which opens a
sub-group for every axis up front): the gang's ``torch.distributed``
process group with the spec's axes solved against its world size, and
this rank's coordinate on each axis (row-major over ``CANONICAL_AXES``,
the JAX layout's order).  ``axis_group`` opens an axis's sub-group when a
collective over that axis first asks for it (ring and Ulysses attention
over ``sequence``, the expert-parallel MoE over ``expert``).  Without a
process group the mesh is this process alone, every axis of size 1.

Copied from ``ray_tpu/parallel/mesh.py`` (the JAX package), with
``make_mesh`` building that class.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

# Canonical axis order: outer (slow) -> inner (fast).  data-parallel
# outermost, model/tensor innermost.
CANONICAL_AXES = ("pipe", "data", "fsdp", "expert", "sequence", "model")


@dataclass
class MeshSpec:
    """Named axis sizes; -1 means "absorb remaining devices" (<= one axis)."""

    axes: Dict[str, int] = field(default_factory=dict)

    def __post_init__(self):
        for name in self.axes:
            if name not in CANONICAL_AXES:
                raise ValueError(
                    f"unknown mesh axis {name!r}; valid: {CANONICAL_AXES}")
        if sum(1 for v in self.axes.values() if v == -1) > 1:
            raise ValueError("at most one axis may be -1")

    def solve(self, num_devices: int) -> "MeshSpec":
        sizes = dict(self.axes)
        known = 1
        wild = None
        for k, v in sizes.items():
            if v == -1:
                wild = k
            else:
                known *= v
        if wild is not None:
            if num_devices % known:
                raise ValueError(
                    f"{num_devices} devices not divisible by fixed axes {sizes}")
            sizes[wild] = num_devices // known
        else:
            total = int(np.prod(list(sizes.values()))) if sizes else 1
            if total != num_devices:
                raise ValueError(
                    f"mesh {sizes} needs {total} devices, have {num_devices}")
        return MeshSpec(sizes)

    def ordered(self) -> List[Tuple[str, int]]:
        return [(a, self.axes[a]) for a in CANONICAL_AXES if a in self.axes]

    @property
    def size(self) -> int:
        return int(np.prod([v for _, v in self.ordered()])) if self.axes else 1


class Mesh:
    """A process group with named axes: ``shape`` maps each axis to its
    size (``jax.sharding.Mesh.shape``), ``coords`` this rank's index on
    each, ``group`` the ``torch.distributed`` group (None: the default
    group, or no group at world 1)."""

    def __init__(self, spec: MeshSpec, group=None):
        import torch.distributed as dist

        self.group = group
        live = dist.is_available() and dist.is_initialized()
        self.world = dist.get_world_size(group) if live else 1
        self.rank = dist.get_rank(group) if live else 0
        spec = spec.solve(self.world)
        ordered = spec.ordered() or [("data", self.world)]
        self.axis_names = tuple(a for a, _ in ordered)
        self.shape = dict(ordered)
        sizes = [n for _, n in ordered]
        idx = np.unravel_index(self.rank, sizes)
        self.coords = {a: int(i) for a, i in zip(self.axis_names, idx)}
        self._axis_groups: Dict[str, object] = {}

    @property
    def size(self) -> int:
        return self.world

    def index_over(self, axes) -> Tuple[int, int]:
        """(this rank's index, count) over the product of ``axes``
        present in the mesh, row-major in the mesh's axis order."""
        index, count = 0, 1
        for a in self.axis_names:
            if a in axes:
                index = index * self.shape[a] + self.coords[a]
                count *= self.shape[a]
        return index, count

    def axis_group(self, axis: str):
        """The process group of this rank's line along ``axis``: the ranks
        whose coordinates differ from this one's on ``axis`` alone, in
        their order on it (what a JAX collective over the named axis
        reaches).  A group of its own even when the line is the whole
        mesh, so that its traffic never interleaves with the default
        group's (DDP's gradient buckets).  Every rank of the mesh must
        make the first call for an axis together (``new_group`` is
        collective); the group is cached.  None when the axis has one
        rank."""
        if self.shape.get(axis, 1) == 1:
            return None
        groups = self._axis_groups
        if axis not in groups:
            import torch.distributed as dist

            sizes = [self.shape[a] for a in self.axis_names]
            at = self.axis_names.index(axis)
            ranks = np.arange(self.world).reshape(sizes)
            lines = np.moveaxis(ranks, at, -1).reshape(-1, sizes[at])
            for line in lines:  # every rank makes every group, in order
                members = [r if self.group is None else
                           dist.get_global_rank(self.group, int(r))
                           for r in line]
                g = dist.new_group([int(r) for r in members])
                if self.rank in line:
                    groups[axis] = g
        return groups[axis]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"


def make_mesh(spec: MeshSpec, group=None) -> Mesh:
    """The mesh of ``group``'s ranks with ``spec``'s axes; a spec with no
    axes is one ``data`` axis over the whole group."""
    return Mesh(spec, group)


def local_mesh(**axes) -> Mesh:
    """Mesh over this process's group: ``local_mesh(data=-1)`` is pure
    data parallelism."""
    return make_mesh(MeshSpec(axes))


def host_local_device_count() -> int:
    """The CUDA devices this process sees (1 on the CPU)."""
    import torch

    return torch.cuda.device_count() if torch.cuda.is_available() else 1
