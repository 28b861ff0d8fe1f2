"""Run/scaling/failure/checkpoint configs (reference: python/ray/air/config.py
ScalingConfig :79, FailureConfig :483, CheckpointConfig :542, RunConfig :670).

``ScalingConfig`` speaks of GPUs where the reference speaks of TPU chips
(``use_tpu``, ``chips_per_worker``): ``use_gpu`` and ``gpus_per_worker``
give ``{"GPU": n}`` in ``worker_resources()``, which the runtime grants
by ``CUDA_VISIBLE_DEVICES``.  Like every entry point of the port it asks
for the card unless told otherwise: the default is one GPU a worker, and
a CPU-only run passes ``use_gpu=False``.

Copied from ``ray_tpu/air/config.py`` (the JAX package).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

from ray_tpu_torch.parallel.mesh import MeshSpec


@dataclasses.dataclass
class ScalingConfig:
    """num_workers = training processes, each granted ``gpus_per_worker``
    GPUs when ``use_gpu``; mesh describes the logical parallelism over all
    devices of the group.

    ``num_workers`` may be an ``(min, max)`` tuple for an *elastic* gang:
    BackendExecutor starts as many workers as the cluster can place right
    now (probing max→min) and never below min."""

    num_workers: Union[int, Tuple[int, int]] = 1
    use_gpu: bool = True
    gpus_per_worker: int = 1
    resources_per_worker: Optional[Dict[str, float]] = None
    mesh: Optional[MeshSpec] = None
    placement_strategy: str = "PACK"

    def worker_range(self) -> Tuple[int, int]:
        """(min, max) worker count — a fixed ``num_workers=n`` is the
        degenerate range (n, n)."""
        nw = self.num_workers
        if isinstance(nw, int):
            if nw < 1:
                raise ValueError(f"num_workers must be >= 1, got {nw}")
            return (nw, nw)
        lo, hi = int(nw[0]), int(nw[1])
        if not 1 <= lo <= hi:
            raise ValueError(f"bad elastic num_workers range {nw!r}")
        return (lo, hi)

    @property
    def min_workers(self) -> int:
        return self.worker_range()[0]

    @property
    def max_workers(self) -> int:
        return self.worker_range()[1]

    def worker_resources(self) -> Dict[str, float]:
        res = dict(self.resources_per_worker or {})
        res.setdefault("CPU", 1.0)
        if self.use_gpu and self.gpus_per_worker:
            res["GPU"] = float(self.gpus_per_worker)
        return res


@dataclasses.dataclass
class FailureConfig:
    max_failures: int = 0  # -1 = unlimited trial retries


@dataclasses.dataclass
class CheckpointConfig:
    num_to_keep: Optional[int] = None
    checkpoint_score_attribute: Optional[str] = None
    checkpoint_score_order: str = "max"
    checkpoint_frequency: int = 0


@dataclasses.dataclass
class RunConfig:
    name: Optional[str] = None
    storage_path: Optional[str] = None  # local dir (cloud URI round-2)
    failure_config: Optional[FailureConfig] = None
    checkpoint_config: Optional[CheckpointConfig] = None
    stop: Optional[Dict[str, Any]] = None
    verbose: int = 1
    # Mirror the experiment dir to durable storage after each state save
    # (reference: SyncConfig/Syncer, python/ray/tune/syncer.py).
    sync_config: Optional["SyncConfig"] = None


@dataclasses.dataclass
class SyncConfig:
    upload_dir: Optional[str] = None
    sync_period_s: float = 0.0  # 0 = sync on every experiment-state save
