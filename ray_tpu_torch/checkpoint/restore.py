"""Resharded restore: N-rank checkpoints onto M-rank gangs.

Every array in a committed manifest carries its GLOBAL shape plus, per
saving rank, the ``[start, stop]`` index of the shard that rank held.
Restore therefore doesn't care what the saving topology was: it assembles
each global array from whichever shards cover it (replicated arrays come
from rank 0's chunks alone), then hands the restoring rank the slice IT
wants via a restore-side index_fn — so a 4-rank save restores onto 2
ranks, 8 ranks, or a single process unchanged.

Copied from ``ray_tpu/checkpoint/restore.py`` (the JAX package).
"""
from __future__ import annotations

import pickle
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ray_tpu_torch.checkpoint.chunks import ChunkStore
from ray_tpu_torch.checkpoint import manifest as mf
from ray_tpu_torch.checkpoint.tree import nest_from_paths, slice_from_index, \
    unflatten_like


# Dtypes numpy lacks, stored as raw bytes under the tensor dtype's name
# (``saver.RawArray``): the numpy dtype their bytes are read into.
RAW_DTYPES = {"bfloat16": np.uint16}


def _storage_dtype(name: str) -> np.dtype:
    return np.dtype(RAW_DTYPES.get(name, name))


def _from_raw(arr: np.ndarray, name: str):
    """A raw-bytes array back to a tensor of its dtype, bit for bit."""
    import torch

    return torch.from_numpy(arr.view(np.int16)).view(getattr(torch, name))


def _resolve_step(root: str, step: Optional[int]) -> int:
    if step is None:
        step = mf.latest_committed_step(root)
        if step is None:
            raise FileNotFoundError(
                f"no committed checkpoint under {root!r}")
    return int(step)


def assemble_arrays(root: str, step: Optional[int] = None,
                    paths: Optional[List[str]] = None,
                    replicated_out: Optional[Dict[str, bool]] = None,
                    raw_out: Optional[Dict[str, str]] = None
                    ) -> Dict[str, np.ndarray]:
    """Reassemble full GLOBAL arrays from a committed step's shards.
    ``paths`` restricts to a subset (all arrays otherwise);
    ``replicated_out`` — when given — collects each array's replicated
    flag from the shard metadata.  A bfloat16 array comes back as a
    ``torch.Tensor`` (numpy has no bfloat16) unless ``raw_out`` is given:
    then it stays raw bytes and ``raw_out`` collects its dtype name."""
    step = _resolve_step(root, step)
    store = ChunkStore(root)
    metas = mf.load_rank_metas(root, step)
    out: Dict[str, np.ndarray] = {}
    filled: Dict[str, int] = {}
    for meta in metas:
        for path, entry in meta.get("arrays", {}).items():
            if paths is not None and path not in paths:
                continue
            if replicated_out is not None:
                replicated_out[path] = bool(entry.get("replicated"))
            if entry.get("chunks") is None:
                continue  # replicated shadow entry (rank>0): no bytes
            gshape = tuple(entry["global_shape"])
            dtype = _storage_dtype(entry["dtype"])
            if path not in out:
                out[path] = np.empty(gshape, dtype=dtype)
                filled[path] = 0
            if entry.get("replicated") and filled[path]:
                continue  # already assembled from another rank
            dest = out[path][tuple(slice(s, e) for s, e in entry["index"])]
            shard = np.empty(tuple(entry["shape"]), dtype=dtype)
            store.read_into(entry["chunks"], shard)
            dest[...] = shard
            filled[path] += int(shard.nbytes)
    for path, arr in out.items():
        if filled[path] < arr.nbytes:
            raise ValueError(
                f"checkpoint step {step} array {path!r} is under-covered: "
                f"{filled[path]}/{arr.nbytes} bytes of the global shape "
                f"were persisted")
    raw = {p: e["dtype"] for meta in metas
           for p, e in meta.get("arrays", {}).items()
           if e["dtype"] in RAW_DTYPES and p in out}
    if raw_out is not None:
        raw_out.update(raw)
        return out
    return {p: _from_raw(a, raw[p]) if p in raw else a
            for p, a in out.items()}


def restore_tree(root: str, step: Optional[int] = None,
                 target: Any = None,
                 index_fn: Optional[Callable] = None) -> Any:
    """Restore a committed checkpoint, optionally resharded.

    ``index_fn(path, global_shape) -> index | None`` picks the restoring
    rank's slice of each global array (None = the full array; the default
    for replicated restores) — build one with ``axis0_restore_index(rank,
    world_size)`` for the even data-parallel split.  With ``target`` the
    exact container structure
    (FrozenDicts, namedtuple optimizer states, scalars) is mirrored;
    without it a nested dict/list skeleton is rebuilt from the paths.

    Dict-kind checkpoints (driver-side ``persist_dict_checkpoint``) return
    the unpickled payload dict.
    """
    step = _resolve_step(root, step)
    manifest = mf.read_manifest(root, step)
    if manifest.get("kind") == "dict":
        import os

        with open(os.path.join(mf.step_dir(root, step),
                               mf.DICT_PAYLOAD), "rb") as f:
            return pickle.load(f)
    replicated: Dict[str, bool] = {}
    raw: Dict[str, str] = {}
    arrays = assemble_arrays(root, step, replicated_out=replicated,
                             raw_out=raw)
    if index_fn is not None:
        # Arrays the manifest marks replicated restore in full on every
        # rank; the index_fn only reshards the genuinely sharded ones.
        arrays = {p: (a if replicated.get(p) else np.ascontiguousarray(
                      slice_from_index(a, index_fn(p, a.shape))))
                  for p, a in arrays.items()}
    arrays = {p: _from_raw(a, raw[p]) if p in raw else a
              for p, a in arrays.items()}
    if target is not None:
        return unflatten_like(target, arrays)
    return nest_from_paths(arrays)
