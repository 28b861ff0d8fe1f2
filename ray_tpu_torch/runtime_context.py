"""Runtime context (reference: python/ray/runtime_context.py).

Copied from ``ray_tpu/runtime_context.py`` (the JAX package).
"""
from __future__ import annotations

from typing import Optional


class RuntimeContext:
    def __init__(self, worker):
        self._worker = worker

    @property
    def job_id(self):
        return self._worker.job_id

    @property
    def node_id(self):
        return self._worker.node_id

    def get_task_id(self) -> Optional[str]:
        t = self._worker.ctx.task_id
        return t.hex() if t else None

    def get_actor_id(self) -> Optional[str]:
        for actor_id in self._worker.actors:
            return actor_id.hex()
        return None

    def get_worker_id(self) -> str:
        return self._worker.worker_id.hex()

    def get_node_id(self) -> str:
        return self._worker.node_id.hex()


def get_runtime_context() -> RuntimeContext:
    from ray_tpu_torch._private.worker import global_worker

    if global_worker is None:
        raise RuntimeError("ray_tpu_torch.init() has not been called")
    return RuntimeContext(global_worker)
