"""BaseTrainer / DataParallelTrainer.

Reference: python/ray/train/base_trainer.py:39 (fit :344) and
data_parallel_trainer.py:56 (training_loop :347).  One deliberate
divergence: the reference routes EVERY fit() through Tune
(base_trainer.py:344-363 constructs a Tuner even for a single run); here
fit() drives the executor directly and `as_trainable()` provides the Tune
integration — same capability, less layering in the common path.

Copied from ``ray_tpu/train/base_trainer.py`` (the JAX package).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.air.checkpoint_manager import (
    CheckpointManager,
    discover_latest_checkpoint,
)
from ray_tpu_torch.air.config import FailureConfig, RunConfig, ScalingConfig
from ray_tpu_torch.air.result import Result
from ray_tpu_torch.train.backend import BackendConfig
from ray_tpu_torch.train._internal.backend_executor import (
    BackendExecutor,
    TrainingWorkerError,
)


class BaseTrainer:
    def __init__(self, *, scaling_config: Optional[ScalingConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 resume_from_checkpoint: Optional[Checkpoint] = None):
        self.scaling_config = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self.resume_from_checkpoint = resume_from_checkpoint

    def _discover_checkpoint(self) -> Optional[Checkpoint]:
        """Latest COMMITTED checkpoint manifest under storage_path — the
        durable resume pointer.  Survives a full driver process restart
        (the in-memory ``_latest_checkpoint`` does not), and two-phase
        commit guarantees it never names a partially-written save."""
        storage = self.run_config.storage_path
        if not storage:
            return None
        try:
            return discover_latest_checkpoint(storage)
        except Exception:
            return None

    def fit(self) -> Result:
        import time

        failure = self.run_config.failure_config or FailureConfig()
        failure_budget = failure.max_failures \
            if failure.max_failures >= 0 else 10**9
        # The gloo TCP abort (mesh_group.is_transport_abort) is an
        # environmental hiccup the backend already retries in place; if
        # one still escapes, the rebuild is charged HERE, not against the
        # user's FailureConfig — tests no longer need per-test headroom.
        transport_budget = 2
        failures = transports = 0
        last_error: Optional[BaseException] = None
        checkpoint = self.resume_from_checkpoint
        if checkpoint is None:
            # Fresh driver process against an existing experiment dir:
            # resume where the last committed checkpoint left off.
            checkpoint = self._discover_checkpoint()
        attempt = 0
        while True:
            # Incarnation index: the executor exports it to the gang so
            # chaos kill schedules can target exactly one generation, and
            # operators can tell restarts apart in worker logs.
            self._elastic_generation = attempt
            if attempt:
                # Exponential backoff between elastic restarts — a
                # crash-looping gang (bad host, leaked coordinator port)
                # must not hot-spin placement groups.
                time.sleep(min(0.2 * 2 ** (attempt - 1), 10.0))
            try:
                return self._run(checkpoint)
            except TrainingWorkerError as e:
                last_error = e
                if getattr(e, "transport_abort", False):
                    transports += 1
                    if transports > transport_budget:
                        break
                else:
                    failures += 1
                    if failures > failure_budget:
                        break
                # Elastic restart resumes from the latest checkpoint: the
                # next _run() builds a FRESH executor + worker gang (new
                # processes re-run the process-group rendezvous).  Disk
                # manifest discovery outranks the in-memory cache — with a
                # storage_path every registered checkpoint is committed
                # there, and workers may have sharded-saved past the last
                # driver-observed report.
                checkpoint = (self._discover_checkpoint()
                              or getattr(self, "_latest_checkpoint", None)
                              or checkpoint)
                try:
                    from ray_tpu_torch.util.metrics import Counter

                    Counter("train_elastic_restarts_total",
                            "Train gang restarts after worker failure").inc()
                except Exception:
                    pass
            attempt += 1
        return Result(metrics={}, checkpoint=checkpoint, error=last_error)

    def _run(self, checkpoint: Optional[Checkpoint]) -> Result:
        raise NotImplementedError

    def as_trainable(self):
        """Wrap for Tune: returns a function-trainable closing over self
        (reference: TrainTrainable wrapper, base_trainer.py:431)."""
        trainer = self

        def train_func(config: Dict[str, Any]):
            from ray_tpu_torch.air import session

            t = trainer.with_updated_config(config)
            result = t.fit()
            if result.error:
                raise result.error
            session.report(result.metrics, checkpoint=result.checkpoint)

        return train_func

    def with_updated_config(self, config: Dict[str, Any]) -> "BaseTrainer":
        return self


class DataParallelTrainer(BaseTrainer):
    def __init__(self, train_loop_per_worker: Callable,
                 *, train_loop_config: Optional[Dict[str, Any]] = None,
                 backend_config: Optional[BackendConfig] = None,
                 datasets: Optional[Dict[str, Any]] = None,
                 **kwargs):
        super().__init__(**kwargs)
        self.train_loop_per_worker = train_loop_per_worker
        self.train_loop_config = train_loop_config or {}
        self.backend_config = backend_config or BackendConfig()
        self.datasets = datasets or {}

    def with_updated_config(self, config: Dict[str, Any]):
        import copy

        t = copy.copy(self)
        t.train_loop_config = {**self.train_loop_config, **config}
        return t

    def _run(self, checkpoint: Optional[Checkpoint]) -> Result:
        executor = BackendExecutor(
            self.backend_config, self.scaling_config,
            generation=getattr(self, "_elastic_generation", 0),
            storage_path=self.run_config.storage_path)
        ckpt_mgr = CheckpointManager(self.run_config.checkpoint_config,
                                     storage_path=self.run_config.storage_path)
        history = []
        final_metrics: Dict[str, Any] = {}
        try:
            executor.start()
            # Shard datasets over the size the executor actually got (the
            # elastic range may have landed below max_workers).
            shards = self._dataset_shards(executor.num_workers)
            executor.start_training(self.train_loop_per_worker,
                                    self.train_loop_config, checkpoint, shards)
            stop = self.run_config.stop or {}
            while True:
                results = executor.get_next_results()
                if results is None:
                    break
                # rank-0 metrics are canonical (all ranks report in lockstep).
                kind, metrics, ckpt = results[0]
                if kind != "report":
                    continue
                for _, _, c in results:
                    if c is not None:
                        ckpt_mgr.register(c, metrics)
                        self._latest_checkpoint = c
                final_metrics = metrics
                history.append(metrics)
                if any(metrics.get(k) is not None and metrics[k] >= v
                       for k, v in stop.items()):
                    break
        finally:
            executor.shutdown()
        return Result(metrics=final_metrics,
                      checkpoint=ckpt_mgr.latest or checkpoint,
                      metrics_history=history)

    def _dataset_shards(self, n: int):
        if not self.datasets:
            return None
        shards = [dict() for _ in range(n)]
        for name, ds in self.datasets.items():
            if hasattr(ds, "split"):
                for i, piece in enumerate(ds.split(n, equal=True)):
                    shards[i][name] = piece
            else:
                for i in range(n):
                    shards[i][name] = ds
        return shards
