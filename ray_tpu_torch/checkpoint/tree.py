"""Pytree flatten/unflatten + shard-index helpers (numpy-only, jax-free).

Paths are JSON-encoded key lists (``["params","dense",0]``) — unambiguous
for any mix of str/int keys, stable across processes, and reversible, so a
checkpoint can be restored into a nested dict/list skeleton without
pickling a structure template.

Shard indices are per-dimension ``[start, stop]`` pairs against the array's
GLOBAL shape.  ``index is None`` marks a replicated array (every rank holds
the full value): only rank 0 persists its bytes, the other ranks record
metadata only — which is what makes replicated-parameter saves cost one
rank's write instead of N identical ones.

Copied from ``ray_tpu/checkpoint/tree.py`` (the JAX package).
"""
from __future__ import annotations

import json
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

# index_fn(path, local_array) -> (global_shape, index) | None for replicated
IndexFn = Callable[[str, np.ndarray], Optional[Tuple[tuple, list]]]


def _is_leaf(node: Any) -> bool:
    if isinstance(node, (dict,)) or hasattr(node, "items"):
        return False
    if isinstance(node, (list, tuple)):
        return False
    return True


def flatten_with_paths(tree: Any) -> List[Tuple[str, Any]]:
    """Flatten nested Mappings/lists/tuples into (path, leaf) pairs in a
    deterministic order (mapping keys sorted).  ``None`` leaves are kept —
    the saver skips them, the restorer leaves the target's value in place."""
    out: List[Tuple[str, Any]] = []

    def rec(node, keys):
        if hasattr(node, "items") and not _is_leaf(node):
            for k in sorted(node.keys(), key=lambda x: (str(type(x)), x)):
                rec(node[k], keys + [k])
        elif isinstance(node, (list, tuple)):
            for i, child in enumerate(node):
                rec(child, keys + [i])
        else:
            out.append((json.dumps(keys), node))

    rec(tree, [])
    return out


def path_keys(path: str) -> List[Any]:
    return json.loads(path)


def nest_from_paths(values: Dict[str, Any]) -> Any:
    """Rebuild a nested structure from path->value (dicts for str keys,
    lists for int keys).  Tuples/namedtuples degrade to lists — restore
    with a ``target`` to preserve exact container types."""
    if not values:
        return {}
    items = [(path_keys(p), v) for p, v in values.items()]
    if any(not ks for ks, _ in items):
        if len(items) != 1:
            raise ValueError("mixed root leaf and nested paths")
        return items[0][1]

    def build(entries):
        first_keys = {ks[0] for ks, _ in entries}
        as_list = all(isinstance(k, int) for k in first_keys)
        groups: Dict[Any, list] = {}
        for ks, v in entries:
            groups.setdefault(ks[0], []).append((ks[1:], v))
        def value_of(sub):
            if len(sub) == 1 and not sub[0][0]:
                return sub[0][1]
            return build(sub)
        if as_list:
            return [value_of(groups[i]) for i in sorted(groups)]
        return {k: value_of(groups[k]) for k in groups}

    return build(items)


def unflatten_like(target: Any, values: Dict[str, Any]) -> Any:
    """Rebuild ``target``'s structure with leaves replaced from ``values``
    (missing paths keep the target's leaf).  Container types are mirrored:
    Mappings via ``type(target)(dict)`` (falling back to dict), namedtuples
    via ``type(*children)``, lists/tuples as themselves."""

    def rec(node, keys):
        if hasattr(node, "items") and not _is_leaf(node):
            rebuilt = {k: rec(v, keys + [k]) for k, v in node.items()}
            try:
                return type(node)(rebuilt)
            except Exception:
                return rebuilt
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            children = [rec(c, keys + [i]) for i, c in enumerate(node)]
            return type(node)(*children)
        if isinstance(node, (list, tuple)):
            children = [rec(c, keys + [i]) for i, c in enumerate(node)]
            return type(node)(children)
        path = json.dumps(keys)
        if path in values:
            loaded = values[path]
            if node is None:
                return loaded
            # Match the target leaf's flavor: arrays come back as loaded
            # (the caller moves them to its device), python scalars stay
            # scalars.
            if isinstance(node, (int, float, bool)) and np.ndim(loaded) == 0:
                return type(node)(loaded.item() if hasattr(loaded, "item")
                                  else loaded)
            return loaded
        return node

    return rec(target, [])


# ---- shard index helpers ----
def full_index(shape) -> list:
    return [[0, int(d)] for d in shape]


def axis0_shard_index(rank: int, world_size: int,
                      should_shard: Optional[Callable[[str], bool]] = None
                      ) -> IndexFn:
    """Save-side index_fn for the even axis-0 split (each rank holds
    ``global_dim0 / world`` rows): derives the global shape from the local
    shard.  Scalars/0-d leaves — and paths ``should_shard`` rejects (e.g.
    replicated biases/optimizer scalars in a mixed layout) — fall back to
    replicated."""

    def fn(path: str, arr: np.ndarray):
        if arr.ndim == 0:
            return None
        if should_shard is not None and not should_shard(path):
            return None
        local0 = int(arr.shape[0])
        gshape = (local0 * world_size,) + tuple(int(d) for d in arr.shape[1:])
        index = full_index(gshape)
        index[0] = [rank * local0, (rank + 1) * local0]
        return gshape, index

    return fn


def axis0_restore_index(rank: int, world_size: int):
    """Restore-side index_fn: which slice of each GLOBAL array this rank
    wants (even split with the remainder spread over the low ranks —
    handles N→M resizes where M doesn't divide the global dim)."""

    def fn(path: str, global_shape) -> Optional[list]:
        if not global_shape:
            return None  # scalar: replicated everywhere
        n = int(global_shape[0])
        base, rem = divmod(n, world_size)
        start = rank * base + min(rank, rem)
        stop = start + base + (1 if rank < rem else 0)
        index = full_index(global_shape)
        index[0] = [start, stop]
        return index

    return fn


def slice_from_index(arr: np.ndarray, index: Optional[list]) -> np.ndarray:
    if index is None:
        return arr
    return arr[tuple(slice(s, e) for s, e in index)]
