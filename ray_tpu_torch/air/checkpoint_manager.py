"""Top-K checkpoint retention (reference: air/_internal/checkpoint_manager.py
:233 — keep best K by score attribute, delete the rest).

Two behaviors beyond the in-memory list:

- **Eviction deletes from disk.**  ``num_to_keep`` used to only truncate
  the entry list, leaking every evicted directory-backed checkpoint;
  evicted entries now have their on-disk footprint removed via
  ``Checkpoint.delete()`` (sharded steps additionally sweep
  now-unreferenced chunks).
- **Durable latest-pointer.**  With a ``storage_path``, every registered
  checkpoint is persisted into the sharded store's commit protocol
  (dict payload + atomic manifest), so ``discover_latest_checkpoint``
  recovers the latest checkpoint after a full driver process restart —
  the in-memory ``latest`` is a cache, not the source of truth.

Copied from ``ray_tpu/air/checkpoint_manager.py`` (the JAX package).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.air.config import CheckpointConfig


def discover_latest_checkpoint(storage_path: str) -> Optional[Checkpoint]:
    """The latest COMMITTED checkpoint under ``storage_path`` (manifest
    discovery — survives driver restarts; partial saves are invisible).
    Returns None when the store holds no committed step."""
    from ray_tpu_torch.checkpoint import manifest as mf

    step = mf.latest_committed_step(storage_path)
    if step is None:
        return None
    return Checkpoint.from_sharded(storage_path, step)


class CheckpointManager:
    def __init__(self, config: Optional[CheckpointConfig] = None,
                 storage_path: Optional[str] = None):
        self.config = config or CheckpointConfig()
        self.storage_path = storage_path
        # (score, seq, checkpoint, metrics)
        self._entries: List[Tuple[float, int, Checkpoint, dict]] = []
        # Seed the sequence from the store: register() uses it as the
        # persisted step number, and a fresh manager (elastic retry or
        # driver restart) starting back at 0 would overwrite committed
        # step dirs while manifest discovery kept resuming from the
        # stale, highest-numbered pre-restart checkpoint.
        self._seq = 0
        if storage_path:
            try:
                from ray_tpu_torch.checkpoint import manifest as mf

                self._seq = mf.latest_committed_step(storage_path) or 0
            except Exception:
                pass
        self.latest: Optional[Checkpoint] = None

    def _persist(self, checkpoint: Checkpoint, metrics: dict,
                 step: int) -> Checkpoint:
        """Spill a driver-side checkpoint into the sharded store (commit
        protocol), returning the durable handle.  Sharded checkpoints
        already live in a store — they pass through."""
        from ray_tpu_torch.air.checkpoint import ShardedCheckpoint
        from ray_tpu_torch.checkpoint.saver import persist_dict_checkpoint

        if isinstance(checkpoint, ShardedCheckpoint):
            return checkpoint
        meta = {k: v for k, v in metrics.items()
                if isinstance(v, (int, float, str, bool))}
        persist_dict_checkpoint(self.storage_path, step,
                                checkpoint.to_dict(), meta=meta)
        return Checkpoint.from_sharded(self.storage_path, step)

    def register(self, checkpoint: Checkpoint, metrics: dict,
                 step: Optional[int] = None):
        self._seq += 1
        if self.storage_path:
            try:
                checkpoint = self._persist(
                    checkpoint, metrics,
                    self._seq if step is None else step)
            except Exception:
                pass  # durability is best-effort; in-memory flow continues
        self.latest = checkpoint
        attr = self.config.checkpoint_score_attribute
        score = float(metrics.get(attr, self._seq)) if attr else float(self._seq)
        if self.config.checkpoint_score_order == "min":
            score = -score
        self._entries.append((score, self._seq, checkpoint, dict(metrics)))
        self._entries.sort(key=lambda e: (e[0], e[1]))
        k = self.config.num_to_keep
        if k is not None and len(self._entries) > k:
            evicted, self._entries = self._entries[:-k], self._entries[-k:]
            kept = {id(e[2]) for e in self._entries}
            for _, _, ckpt, _ in evicted:
                # Never delete the resume source out from under a restart.
                if ckpt is self.latest or id(ckpt) in kept:
                    continue
                try:
                    ckpt.delete()
                except Exception:
                    pass

    @property
    def best(self) -> Optional[Checkpoint]:
        return self._entries[-1][2] if self._entries else None

    @property
    def best_metrics(self) -> Optional[dict]:
        return self._entries[-1][3] if self._entries else None

    def checkpoints(self) -> List[Checkpoint]:
        return [e[2] for e in self._entries]
