"""TorchConfig backend: the process group of a Train gang (counterpart of
``ray_tpu/train/jax/config.py``; reference: python/ray/train/torch/
config.py:69-132, MASTER_ADDR from worker 0 and
``dist.init_process_group`` on every worker).

As the JAX package's backend delegates its gang's rendezvous to
``mesh_group.rendezvous``, so does the port's: worker 0 picks an address
and a free port, and every worker calls
``torch.distributed.init_process_group`` at it with its rank.  The
backend follows the workers' cards (``mesh_group.process_group_backend``):
NCCL when each worker has a card of its own; gloo when the workers share
a card (a fraction of one each, ``ScalingConfig(gpus_per_worker=0.5)``:
NCCL refuses two ranks on one device) or run on the CPU; any other
layout raises before a group forms.  The group's timeout
(``DEFAULT_TIMEOUT_S``) bounds the rendezvous and every collective.
``on_shutdown`` destroys the group, so a second ``fit`` in fresh workers
starts clean.  Gradients are synchronised over the group by
``prepare_model`` (DDP) or ``compile_zero_step`` (ZeRO).
"""
from __future__ import annotations

import logging

from ray_tpu_torch.parallel.mesh_group import (
    DEFAULT_TIMEOUT_S,
    destroy_process_group,
    gang_get,
    rendezvous,
)
from ray_tpu_torch.train.backend import Backend, BackendConfig

logger = logging.getLogger(__name__)


class TorchConfig(BackendConfig):
    """The gang's process group; its backend follows the workers' cards
    (``process_group_backend``), so there is nothing to set."""

    def backend_cls(self):
        return _TorchBackend


class _TorchBackend(Backend):
    def on_start(self, worker_group, backend_config: TorchConfig):
        rendezvous(worker_group.workers,
                   worker_group.resources_per_worker.get("GPU", 0.0),
                   timeout=DEFAULT_TIMEOUT_S)

    def on_training_failure(self, worker_group, backend_config: TorchConfig,
                            error: BaseException):
        # A dead rank invalidates the whole process group; the executor
        # tears the gang down right after this and fresh processes form a
        # new group on the next attempt.
        logger.warning("torch.distributed gang failed (%s); the worker "
                       "group will be rebuilt and training resumed from "
                       "the latest checkpoint", error)

    def on_shutdown(self, worker_group, backend_config: TorchConfig):
        # Best effort: the workers are killed right after, and a dead rank
        # must not keep the executor from releasing the rest.
        try:
            gang_get([w.execute.remote(destroy_process_group)
                      for w in worker_group.workers], timeout=30.0)
        except Exception as e:  # noqa: BLE001 — teardown must go on
            logger.warning("destroy_process_group failed: %s", e)
