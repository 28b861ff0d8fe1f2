"""Universal Checkpoint: dict ⇄ directory, with torch state dicts.

Reference: ray.air.Checkpoint (python/ray/air/checkpoint.py:63) — the
dict/directory/URI-interconvertible checkpoint that flows worker → driver →
tune → storage.  Where the reference stores jax pytrees with flax's
msgpack (``from_pytree``/``to_pytree``), the port stores a torch state
dict: ``from_state_dict`` moves every tensor to the CPU and writes the
dict with ``torch.save`` to bytes, and ``to_state_dict`` reads them back
with ``torch.load(weights_only=True)``, which unpickles only tensors and
plain containers.  ``ShardedCheckpoint`` (the committed step of a
``ray_tpu_torch.checkpoint`` store) keeps the reference's shape.

Copied from ``ray_tpu/air/checkpoint.py`` (the JAX package).
"""
from __future__ import annotations

import io
import os
import pickle
import shutil
import tempfile
import uuid
from typing import Any, Dict, Optional

_STATE_KEY = "__state_dict__"
_DICT_FILE = "checkpoint.pkl"


def _tensors_to_cpu(obj):
    import torch

    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu")
    if isinstance(obj, dict):
        return type(obj)((k, _tensors_to_cpu(v)) for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return type(obj)(_tensors_to_cpu(v) for v in obj)
    return obj


class Checkpoint:
    def __init__(self, data: Optional[Dict[str, Any]] = None,
                 directory: Optional[str] = None):
        if (data is None) == (directory is None):
            raise ValueError("exactly one of data / directory required")
        self._data = data
        self._dir = directory

    # ---- constructors ----
    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "Checkpoint":
        return cls(data=dict(data))

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(directory=path)

    @classmethod
    def from_state_dict(cls, state: Dict[str, Any],
                        extra: Optional[dict] = None) -> "Checkpoint":
        """Store a torch state dict (a module's or an optimizer's; tensors
        on any device, nested in dicts, lists and tuples) as the bytes of
        ``torch.save`` of its CPU copy."""
        import torch

        buf = io.BytesIO()
        torch.save(_tensors_to_cpu(state), buf)
        return cls(data={_STATE_KEY: buf.getvalue(), **(extra or {})})

    @classmethod
    def from_sharded(cls, root: str, step: Optional[int] = None) -> "Checkpoint":
        """Open a committed step of a distributed sharded checkpoint store
        (``ray_tpu_torch.checkpoint``): ``step=None`` means the latest
        committed manifest.  ``to_pytree`` reassembles the full global tree
        from the per-rank shards (resharded restore: pass rank/world via
        ``to_pytree_resharded``)."""
        return ShardedCheckpoint(root, step)

    # ---- accessors ----
    def to_dict(self) -> Dict[str, Any]:
        if self._data is not None:
            return dict(self._data)
        path = os.path.join(self._dir, _DICT_FILE)
        if os.path.exists(path):
            with open(path, "rb") as f:
                return pickle.load(f)
        raise ValueError(
            f"checkpoint directory {self._dir!r} does not contain "
            f"{_DICT_FILE!r} — not a checkpoint "
            f"(was the directory partially written or already deleted?)")

    def to_state_dict(self, map_location=None) -> Dict[str, Any]:
        """Restore the stored state dict, its tensors on the CPU (or on
        ``map_location``)."""
        import torch

        return torch.load(io.BytesIO(self.to_dict()[_STATE_KEY]),
                          map_location=map_location, weights_only=True)

    def extra(self) -> Dict[str, Any]:
        return {k: v for k, v in self.to_dict().items() if k != _STATE_KEY}

    def to_directory(self, path: Optional[str] = None) -> str:
        path = path or os.path.join(tempfile.gettempdir(),
                                    f"rttp_ckpt_{uuid.uuid4().hex[:8]}")
        os.makedirs(path, exist_ok=True)
        if self._dir is not None:
            if os.path.abspath(self._dir) != os.path.abspath(path):
                shutil.copytree(self._dir, path, dirs_exist_ok=True)
        else:
            with open(os.path.join(path, _DICT_FILE), "wb") as f:
                pickle.dump(self._data, f)
        return path

    def delete(self) -> None:
        """Remove the checkpoint's on-disk footprint (no-op for in-memory
        dict checkpoints).  Used by CheckpointManager eviction so
        ``num_to_keep`` actually reclaims disk, not just list slots."""
        if self._dir is not None:
            shutil.rmtree(self._dir, ignore_errors=True)

    def __repr__(self):
        kind = "dict" if self._data is not None else f"dir:{self._dir}"
        return f"Checkpoint({kind})"


class ShardedCheckpoint(Checkpoint):
    """A committed step of a distributed sharded checkpoint store.

    Directory-backed on the step dir, but the authoritative reader is the
    manifest + chunk store: ``to_pytree`` reassembles global arrays from
    every rank's shards (``ray_tpu_torch.checkpoint.restore``)."""

    def __init__(self, root: str, step: Optional[int] = None):
        from ray_tpu_torch.checkpoint import manifest as mf

        if step is None:
            step = mf.latest_committed_step(root)
            if step is None:
                raise FileNotFoundError(
                    f"no committed checkpoint manifest under {root!r}")
        super().__init__(directory=mf.step_dir(root, step))
        self.root = root
        self.step = int(step)

    def manifest(self) -> Dict[str, Any]:
        from ray_tpu_torch.checkpoint import manifest as mf

        return mf.read_manifest(self.root, self.step)

    def to_dict(self) -> Dict[str, Any]:
        m = self.manifest()
        if m.get("kind") == "dict":
            return super().to_dict()
        return {"__sharded__": True, "root": self.root, "step": self.step,
                **m.get("meta", {})}

    def to_pytree(self, target: Any = None) -> Any:
        from ray_tpu_torch.checkpoint.restore import restore_tree

        return restore_tree(self.root, step=self.step, target=target)

    def to_pytree_resharded(self, target: Any = None, rank: int = 0,
                            world_size: int = 1, index_fn=None) -> Any:
        """Restore this rank's reshard of the checkpoint (an N-rank save
        onto an M-rank gang).  Default resharding is the even axis-0
        split; pass ``index_fn`` for custom layouts."""
        from ray_tpu_torch.checkpoint.restore import restore_tree
        from ray_tpu_torch.checkpoint.tree import axis0_restore_index

        if index_fn is None and world_size > 1:
            index_fn = axis0_restore_index(rank, world_size)
        return restore_tree(self.root, step=self.step, target=target,
                            index_fn=index_fn)

    def extra(self) -> Dict[str, Any]:
        return dict(self.manifest().get("meta", {}))

    def delete(self) -> None:
        """Evict this step: remove its dir, then sweep chunks no other
        committed manifest references."""
        from ray_tpu_torch.checkpoint import manifest as mf

        mf.delete_step(self.root, self.step)
        try:
            mf.gc_chunks(self.root)
        except Exception:
            pass

    def __repr__(self):
        return f"ShardedCheckpoint(root={self.root!r}, step={self.step})"
