"""Sharding rules: logical array axes to mesh axes (counterpart of
``ray_tpu/parallel/sharding.py``).

Parameters and activations carry *logical* axis names ("batch", "embed",
"mlp", "heads", ...), and a rule table maps those to mesh axes.  In the
JAX package a spec places an array on the device mesh and XLA inserts
the collectives.  In the port a mesh is a process group (``mesh.Mesh``)
and a rank holds plain tensors, so a spec says which slice of an array
this rank holds: a dim mapped to ``data``/``fsdp`` is cut into equal
slices by the rank's index over those axes; every other dim is whole.
Mesh axes the port has no parallelism for (``model``, ``sequence``,
``expert``, ``pipe``) degrade to replication, as ``spec_for`` does in
the JAX package for an axis the mesh lacks (``sharding.py:31-50``).

Without annotations ``shard_params`` broadcasts rank 0's parameters in
place, which is what the JAX package's replicated placement guarantees:
every rank holds the same values.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

# Default logical->mesh rules for transformer-family models.
DEFAULT_RULES: Tuple[Tuple[str, Any], ...] = (
    ("batch", ("data", "fsdp")),
    ("seq", "sequence"),
    ("embed", None),
    ("embed_fsdp", "fsdp"),
    ("heads", "model"),
    ("kv", None),
    ("mlp", "model"),
    ("vocab", "model"),
    ("expert", "expert"),
    ("stage", "pipe"),
)

# The mesh axes a rank's slice is cut along; the rest replicate.
DATA_AXES = ("data", "fsdp")


class Sharding:
    """One array's placement on a mesh: ``spec[d]`` is the tuple of mesh
    axes dim ``d`` is cut along (empty: whole)."""

    def __init__(self, mesh, spec: Sequence[Tuple[str, ...]]):
        self.mesh = mesh
        self.spec = tuple(tuple(s) for s in spec)

    def place(self, x):
        """This rank's slice of the (global) array ``x``."""
        for d, axes in enumerate(self.spec):
            if not axes or d >= len(getattr(x, "shape", ())):
                continue
            index, count = self.mesh.index_over(axes)
            if count == 1:
                continue
            n = int(x.shape[d])
            if n % count:
                raise ValueError(f"dim {d} of size {n} does not divide "
                                 f"over {count} ranks ({axes})")
            step = n // count
            x = x[(slice(None),) * d + (slice(index * step,
                                                (index + 1) * step),)]
        return x

    def __repr__(self) -> str:
        return f"Sharding({self.spec})"


class ShardingRules:
    def __init__(self, rules: Sequence[Tuple[str, Any]] = DEFAULT_RULES):
        self.table: Dict[str, Any] = dict(rules)

    def spec_for(self, logical_axes: Sequence[Optional[str]], mesh
                 ) -> Tuple[Tuple[str, ...], ...]:
        """Per dim, the mesh axes it is cut along.  Mesh axes absent from
        ``mesh``, and axes other than ``data``/``fsdp``, degrade to
        replication, so the same model code runs on one rank and on
        many."""
        entries = []
        for ax in logical_axes:
            mapped = self.table.get(ax) if ax is not None else None
            if mapped is None:
                entries.append(())
                continue
            mapped = mapped if isinstance(mapped, tuple) else (mapped,)
            entries.append(tuple(m for m in mapped if m in mesh.axis_names
                                 and m in DATA_AXES))
        return tuple(entries)

    def sharding_for(self, logical_axes: Sequence[Optional[str]],
                     mesh) -> Sharding:
        return Sharding(mesh, self.spec_for(logical_axes, mesh))


def batch_sharding(mesh, ndim: int = 2) -> Sharding:
    """Dim 0 cut over the data axes; the rest whole."""
    data_axes = tuple(a for a in DATA_AXES if a in mesh.axis_names)
    return Sharding(mesh, (data_axes,) + ((),) * (ndim - 1))


def replicated(mesh) -> Sharding:
    return Sharding(mesh, ())


def shard_params(params, mesh, rules: Optional[ShardingRules] = None,
                 annotations=None):
    """Place a parameter tree on the mesh.

    Every tensor leaf first takes rank 0's values (a broadcast over the
    mesh's group, in place), so the ranks agree whatever each drew.
    ``annotations`` is a matching tree of logical-axis tuples (or None for
    replicated): an annotated leaf comes back as this rank's slice.
    Without annotations everything is replicated: correct, just not
    memory-scaled (pure data parallelism)."""
    import torch

    from ray_tpu_torch.ops import collectives
    from ray_tpu_torch.parallel.zero import tree_flatten, tree_unflatten

    rules = rules or ShardingRules()
    paths, leaves, treedef = tree_flatten(params)
    if mesh.world > 1:
        for leaf in leaves:
            if isinstance(leaf, torch.Tensor):
                collectives.broadcast_(leaf.data, 0, mesh.group)
    if annotations is None:
        return params

    def annotation_at(path):
        ann = annotations
        for k in path:
            if ann is None:
                return None
            ann = ann[k]
        return ann

    placed = [x if annotation_at(p) is None
              else rules.sharding_for(annotation_at(p), mesh).place(x)
              for p, x in zip(paths, leaves)]
    return tree_unflatten(treedef, placed)


def constraint(x, logical_axes, mesh, rules: Optional[ShardingRules] = None):
    """``with_sharding_constraint`` by logical axis names.  In JAX it
    changes an array's layout, never its values; eager PyTorch has no
    layout to constrain, so ``x`` comes back as it is (the spec is checked
    against the mesh)."""
    (rules or ShardingRules()).spec_for(logical_axes, mesh)
    return x
