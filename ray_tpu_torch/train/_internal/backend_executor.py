"""BackendExecutor: placement group + worker group + rendezvous + training
loop results (reference: python/ray/train/_internal/backend_executor.py:43 —
PG creation :138, rank assignment :245, start_training :315; restart :571).

Gang fault tolerance: every fan-out to the worker gang resolves through
``mesh_group.gang_get`` (eager rank-death detection — see the fault
tolerance section of ray_tpu_torch/parallel/mesh_group.py), and any
gang-poisoning failure (``MeshGroupError``, actor/worker death, deadline)
is converted into ``TrainingWorkerError`` so ``BaseTrainer.fit`` can tear
the executor down and elastically restart from the latest checkpoint.

A gang that asks for more GPUs than the cluster has is refused at
``start()`` (``_check_gpus``), naming CUDA, before anything waits on a
placement that can never happen.

Copied from ``ray_tpu/train/_internal/backend_executor.py`` (the JAX
package).
"""
from __future__ import annotations

import traceback
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch import exceptions as exc
from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.air.config import ScalingConfig
from ray_tpu_torch.parallel.mesh_group import gang_get, is_transport_abort
from ray_tpu_torch.train.backend import Backend, BackendConfig
from ray_tpu_torch.train._internal.worker_group import WorkerGroup
from ray_tpu_torch.util.placement_group import (
    placement_group as _create_pg,
    remove_placement_group as _remove_pg,
)


class TrainingWorkerError(Exception):
    """``transport_abort`` marks the gloo TCP race (see
    ``mesh_group.is_transport_abort``): the gang needs a rebuild but the
    failure is environmental, so ``BaseTrainer.fit`` charges it against a
    separate transport budget instead of ``FailureConfig.max_failures``."""

    def __init__(self, cause, tb: str, transport_abort: bool = False):
        self.cause = cause
        self.tb = tb
        self.transport_abort = transport_abort
        super().__init__(f"training worker failed:\n{tb}")


# Failures that mean the gang (not the user code) is broken and a fresh
# worker group + rendezvous can recover.
_GANG_FAILURES = (exc.MeshGroupError, exc.ActorDiedError,
                  exc.ActorUnavailableError, exc.WorkerCrashedError,
                  exc.ObjectLostError)


class BackendExecutor:
    def __init__(self, backend_config: BackendConfig,
                 scaling_config: ScalingConfig, generation: int = 0,
                 storage_path: Optional[str] = None):
        self.backend_config = backend_config
        self.backend: Backend = backend_config.backend_cls()()
        self.scaling = scaling_config
        # Actual gang size; start() resolves it inside the elastic range.
        self.num_workers = scaling_config.max_workers
        self.worker_group: Optional[WorkerGroup] = None
        self.pg = None
        # Elastic-restart incarnation index (0 on the first attempt);
        # exported to workers so chaos schedules can target one gang.
        self.generation = generation
        # Checkpoint store root, exported to every worker as
        # RTTP_CHECKPOINT_ROOT: rank loops save per-rank shards directly
        # into it (ray_tpu_torch.checkpoint.ShardWriter) and elastic resume
        # discovers the latest committed manifest there.
        self.storage_path = storage_path

    def _gang_failure(self, e: BaseException) -> TrainingWorkerError:
        """Wrap a gang-poisoning failure so the trainer's elastic-restart
        loop (which catches TrainingWorkerError) handles dead ranks the
        same way it handles in-band worker errors."""
        try:
            self.backend.on_training_failure(self.worker_group,
                                             self.backend_config, e)
        except Exception:
            pass
        return TrainingWorkerError(e, traceback.format_exc(),
                                   transport_abort=is_transport_abort(e))

    @staticmethod
    def _check_gpus(per_worker: float, workers: int) -> None:
        """A gang that asks for more GPUs than the cluster has can never
        be placed (with one worker there is not even a placement group to
        time out): refuse it here, before anything waits on it."""
        if not per_worker:
            return
        have = ray_tpu_torch.cluster_resources().get("GPU", 0.0)
        if have < per_worker * workers:
            raise RuntimeError(
                f"ScalingConfig asks for {per_worker:g} GPU(s) for each of "
                f"{workers} worker(s), but the cluster has {have:g}: no "
                "CUDA device to train on (pass ScalingConfig(use_gpu=False)"
                " to train on the CPU)")

    def start(self):
        """Reserve placement + spawn the gang.  With an elastic
        ``num_workers=(min, max)`` range, probe sizes max→min and take
        the largest the cluster can place NOW (never below min —
        min's placement failure propagates)."""
        res = self.scaling.worker_resources()
        lo, hi = self.scaling.worker_range()
        self._check_gpus(res.get("GPU", 0.0), lo)
        self.num_workers = lo
        for n in range(hi, lo - 1, -1):
            if n == 1:
                self.num_workers = 1
                break
            bundles = [dict(res) for _ in range(n)]
            pg = _create_pg(bundles,
                            strategy=self.scaling.placement_strategy)
            try:
                # The floor size gets the full grace period; larger probe
                # sizes fail fast so a tight cluster degrades quickly.
                pg.ready(timeout=60 if n == lo else 10)
            except Exception:
                try:
                    _remove_pg(pg)
                except Exception:
                    pass
                if n == lo:
                    raise
                continue
            self.pg = pg
            self.num_workers = n
            break
        self.worker_group = WorkerGroup(self.num_workers, res,
                                        self.pg, generation=self.generation)
        if self.storage_path:
            try:
                gang_get([w.setup_env.remote(
                    {"RTTP_CHECKPOINT_ROOT": self.storage_path})
                    for w in self.worker_group.workers], timeout=30.0)
            except _GANG_FAILURES as e:
                raise self._gang_failure(e) from e
        # Gang rendezvous (the process group's address on worker 0) is the
        # backend's job: see ray_tpu_torch/train/torch/config.py.  A rank
        # dying inside the rendezvous is a recoverable gang failure, not a
        # user error.
        try:
            self.backend.on_start(self.worker_group, self.backend_config)
        except _GANG_FAILURES as e:
            raise self._gang_failure(e) from e

    def start_training(self, train_fn: Callable, config: dict,
                       checkpoint: Optional[Checkpoint] = None,
                       dataset_shards: Optional[List[dict]] = None):
        self.backend.on_training_start(self.worker_group, self.backend_config)
        try:
            gang_get([
                w.start_training.remote(
                    train_fn, config, checkpoint,
                    dataset_shards[i] if dataset_shards else None)
                for i, w in enumerate(self.worker_group.workers)
            ])
        except _GANG_FAILURES as e:
            raise self._gang_failure(e) from e

    def get_next_results(self, timeout: float = 600.0) -> Optional[List[tuple]]:
        """Blocks for one result per worker. Returns None when all done.
        Raises TrainingWorkerError on any worker error — in-band ("error"
        results) or out-of-band (a rank's process died: gang_get detects
        it eagerly instead of blocking on the surviving, possibly
        collective-stuck, peers)."""
        try:
            # Slack past the workers' own queue timeout: a healthy worker
            # answers ("timeout", ...) in-band at `timeout`; the gang_get
            # deadline only fires for ranks that can't answer at all.
            results = gang_get([w.next_result.remote(timeout)
                                for w in self.worker_group.workers],
                               timeout=timeout + 30.0)
        except _GANG_FAILURES as e:
            raise self._gang_failure(e) from e
        kinds = {r[0] for r in results}
        if "error" in kinds:
            for r in results:
                if r[0] == "error":
                    raise TrainingWorkerError(
                        r[1], r[2],
                        transport_abort=is_transport_abort(r[1]))
        if kinds == {"done"}:
            return None
        if "timeout" in kinds:
            raise TimeoutError("training workers produced no result in time")
        return results

    def ping_workers(self, deadline: float = 10.0) -> List[int]:
        """Health-probe the gang (MeshGroup.health_check shape); raises
        MeshGroupError naming dead/unresponsive ranks."""
        return gang_get([w.ping.remote()
                         for w in self.worker_group.workers],
                        timeout=deadline)

    def shutdown(self):
        if self.worker_group is not None:
            self.backend.on_shutdown(self.worker_group, self.backend_config)
            self.worker_group.shutdown()
            self.worker_group = None
        if self.pg is not None:
            try:
                _remove_pg(self.pg)
            except Exception:
                pass
            self.pg = None
