"""WorkerGroup: the gang of training-worker actors.

Reference: python/ray/train/_internal/worker_group.py:92 (plain actors with
execute/execute_async).  Here each worker is a TrainWorker actor
(max_concurrency=2 so result polling overlaps the training loop), spawned
under a placement group for gang scheduling.  A worker granted GPUs
sees them, and only them, through ``CUDA_VISIBLE_DEVICES`` (the
runtime's raylet sets it), where the reference's worker is one TPU
host's process.

The training loop runs on a ``flow.Stage(sink=True)`` (the dataflow
substrate's terminal stage: one background worker consuming a single-item
source by side effect) rather than a hand-rolled ``threading.Thread``;
results still flow to the driver through the ``queue.Queue`` result
mailbox — a mailbox, not a pipeline, so it stays.

Copied from ``ray_tpu/train/_internal/worker_group.py`` (the JAX package).
"""
from __future__ import annotations

import queue
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.air import session as air_session
from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.parallel import flow


@ray_tpu_torch.remote
class TrainWorker:
    """Actor hosting one training process (and the GPUs it was granted)."""

    def __init__(self, rank: int, world_size: int, generation: int = 0):
        import os

        from ray_tpu_torch._private import chaos

        self.rank = rank
        self.world_size = world_size
        self.generation = generation
        self._results: "queue.Queue" = queue.Queue()
        self._stage: Optional[flow.Stage] = None
        self._env: Dict[str, str] = {}
        # Gang generation: lets the chaos kill schedule target exactly one
        # incarnation, so an elastically-restarted gang survives.
        os.environ[chaos.GENERATION_ENV] = str(generation)

    def ping(self) -> int:
        """Liveness probe; answers on the spare concurrency slot even
        while the training loop runs."""
        return self.rank

    def setup_env(self, env: Dict[str, str]):
        import os

        self._env.update(env)
        os.environ.update(env)
        return True

    def node_info(self) -> dict:
        import os
        import socket

        return {"rank": self.rank, "pid": os.getpid(),
                "host": socket.gethostname(),
                "visible": os.environ.get("CUDA_VISIBLE_DEVICES", "")}

    def execute(self, fn: Callable, *args, **kwargs):
        """Run an arbitrary function in the worker (reference
        WorkerGroup.execute)."""
        return fn(*args, **kwargs)

    def start_training(self, train_fn: Callable, config: dict,
                      checkpoint: Optional[Checkpoint],
                      dataset_shards: Optional[dict] = None) -> bool:
        """Launch the user loop on a sink stage; results flow via
        next_result."""

        def report_fn(metrics, ckpt):
            from ray_tpu_torch._private import chaos

            # Chaos kill site: a schedule entry "train_report:<rank>:<nth>"
            # SIGKILLs this host at its nth report — the deterministic
            # stand-in for a host preemption mid-training.
            chaos.maybe_die("train_report", self.rank)
            self._results.put(("report", metrics, ckpt))

        def run(_item):
            import inspect
            import os

            from ray_tpu_torch.air import session as air_session

            air_session.init_session(
                report_fn=report_fn, world_rank=self.rank,
                world_size=self.world_size, checkpoint=checkpoint,
                dataset_shards=dataset_shards,
                storage_path=os.environ.get("RTTP_CHECKPOINT_ROOT"))
            try:
                wants_arg = True
                try:
                    wants_arg = len(inspect.signature(train_fn).parameters) >= 1
                except (TypeError, ValueError):
                    pass
                out = train_fn(config) if wants_arg else train_fn()
                self._results.put(("done", out, None))
            except BaseException as e:  # noqa: BLE001 — shipped to driver
                import traceback

                self._results.put(("error", e, traceback.format_exc()))
            finally:
                air_session.shutdown_session()

        if self._stage is not None:
            self._stage.close()
        # One-item source, sink=True: the stage's single worker runs the
        # whole training loop as the side effect of consuming that item.
        self._stage = flow.Stage(iter([None]), run, sink=True, workers=1,
                                 depth=1, name="train-loop",
                                 export_metrics=False)
        return True

    def next_result(self, timeout: float = 3600.0):
        try:
            return self._results.get(timeout=timeout)
        except queue.Empty:
            return ("timeout", None, None)


class WorkerGroup:
    def __init__(self, num_workers: int, resources_per_worker: Dict[str, float],
                 placement_group=None, generation: int = 0):
        opts: Dict[str, Any] = {"max_concurrency": 2}
        cpu = resources_per_worker.get("CPU", 1.0)
        opts["num_cpus"] = cpu
        if resources_per_worker.get("GPU"):
            opts["num_gpus"] = resources_per_worker["GPU"]
        extra = {k: v for k, v in resources_per_worker.items()
                 if k not in ("CPU", "GPU")}
        if extra:
            opts["resources"] = extra
        if placement_group is not None:
            from ray_tpu_torch.util import PlacementGroupSchedulingStrategy

            opts["scheduling_strategy"] = PlacementGroupSchedulingStrategy(
                placement_group)
        self.workers = [
            TrainWorker.options(**opts).remote(rank, num_workers, generation)
            for rank in range(num_workers)
        ]
        self.num_workers = num_workers
        self.resources_per_worker = dict(resources_per_worker)
        self.generation = generation

    def execute(self, fn: Callable, *args, **kwargs) -> List[Any]:
        return ray_tpu_torch.get([w.execute.remote(fn, *args, **kwargs)
                            for w in self.workers])

    def execute_async(self, fn: Callable, *args, **kwargs):
        return [w.execute.remote(fn, *args, **kwargs) for w in self.workers]

    def execute_single(self, rank: int, fn: Callable, *args, **kwargs):
        return ray_tpu_torch.get(self.workers[rank].execute.remote(fn, *args, **kwargs))

    def shutdown(self):
        for w in self.workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:
                pass
        self.workers = []
