"""Worker-facing training session facade (reference: python/ray/air/
session.py:41 — report, get_checkpoint, get_dataset_shard, rank queries).

The active session is installed per-process by the Train worker loop or the
Tune function-trainable wrapper; the same `report()` works in both, exactly
like the reference.

Copied from ``ray_tpu/air/session.py`` (the JAX package).
"""
from __future__ import annotations

import threading
from typing import Any, Dict, Optional

from ray_tpu_torch.air.checkpoint import Checkpoint

_session = threading.local()


class _Session:
    def __init__(self, report_fn, world_rank=0, world_size=1,
                 checkpoint: Optional[Checkpoint] = None,
                 dataset_shards: Optional[Dict[str, Any]] = None,
                 trial_info: Optional[dict] = None,
                 storage_path: Optional[str] = None):
        self.report_fn = report_fn
        self.world_rank = world_rank
        self.world_size = world_size
        self.loaded_checkpoint = checkpoint
        self.dataset_shards = dataset_shards or {}
        self.trial_info = trial_info or {}
        self.storage_path = storage_path


def init_session(**kw):
    _session.value = _Session(**kw)


def shutdown_session():
    _session.value = None


def _get() -> Optional[_Session]:
    return getattr(_session, "value", None)


def report(metrics: Dict[str, Any],
           checkpoint: Optional[Checkpoint] = None) -> None:
    s = _get()
    if s is None:
        raise RuntimeError("session.report() called outside a training session")
    s.report_fn(dict(metrics), checkpoint)


def get_checkpoint() -> Optional[Checkpoint]:
    s = _get()
    return s.loaded_checkpoint if s else None


def get_dataset_shard(name: str = "train"):
    s = _get()
    if s is None:
        raise RuntimeError("no active session")
    return s.dataset_shards.get(name)


def get_world_rank() -> int:
    s = _get()
    return s.world_rank if s else 0


def get_world_size() -> int:
    s = _get()
    return s.world_size if s else 1


def get_trial_name() -> Optional[str]:
    s = _get()
    return s.trial_info.get("name") if s else None


def get_storage_path() -> Optional[str]:
    """The experiment's checkpoint store root (RunConfig.storage_path),
    exported to every training worker — rank loops use it to save per-rank
    shards directly (``ray_tpu_torch.checkpoint.ShardWriter(get_storage_path(),
    get_world_rank(), get_world_size())``) instead of shipping full state
    through ``session.report``."""
    import os

    s = _get()
    if s is not None and s.storage_path:
        return s.storage_path
    return os.environ.get("RTTP_CHECKPOINT_ROOT") or None


def sharded_writer():
    """Convenience: a ``ShardWriter`` for this worker's (rank, world) into
    the session's storage path.  Raises when no storage path is set."""
    root = get_storage_path()
    if not root:
        raise RuntimeError(
            "session.sharded_writer() needs RunConfig.storage_path (or "
            "RTTP_CHECKPOINT_ROOT) to be set")
    from ray_tpu_torch.checkpoint.saver import ShardWriter

    return ShardWriter(root, get_world_rank(), get_world_size())
