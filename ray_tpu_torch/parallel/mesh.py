"""Named logical parallelism axes (counterpart of
``ray_tpu/parallel/mesh.py``).

Only ``MeshSpec`` is copied (``ray_tpu/parallel/mesh.py:25``, numpy
only): ``ScalingConfig`` carries one.  Building a device mesh from it
(``make_mesh``, ``local_mesh``) belongs to data parallelism, ROADMAP
Queue 1 item 6.

Copied from ``ray_tpu/parallel/mesh.py`` (the JAX package).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

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
