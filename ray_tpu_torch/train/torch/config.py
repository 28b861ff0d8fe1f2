"""TorchConfig backend: the process group of a Train gang (counterpart of
``ray_tpu/train/jax/config.py``; reference: python/ray/train/torch/
config.py:69-132, MASTER_ADDR from worker 0 and
``dist.init_process_group`` on every worker).

Where the JAX package joins the gang into one ``jax.distributed`` world
through ``mesh_group.rendezvous``, the port does what the reference's
torch backend does: worker 0 publishes its address and a free port, and
every worker calls ``torch.distributed.init_process_group`` at that
address with its rank, over NCCL when the worker sees a GPU and gloo
otherwise.  ``on_shutdown`` destroys the group, so a second ``fit`` in
fresh workers starts clean.  Gradient synchronisation over the group
(DDP, ZeRO) is data parallelism, ROADMAP Queue 1 item 6.
"""
from __future__ import annotations

import logging

import ray_tpu_torch
from ray_tpu_torch.parallel.mesh_group import gang_get
from ray_tpu_torch.train.backend import Backend, BackendConfig

logger = logging.getLogger(__name__)

# Bounds the rendezvous and every collective of the group.
_TIMEOUT_S = 120.0


def _address(loopback: bool) -> str:
    """``ip:port`` of a free port, picked inside the rank-0 worker (the
    port has to be free on rank 0's machine, and the address one that the
    other hosts can reach)."""
    import socket

    from ray_tpu_torch._private.transfer import routable_ip

    with socket.socket() as s:
        s.bind(("", 0))
        port = s.getsockname()[1]
    return f"{'127.0.0.1' if loopback else routable_ip()}:{port}"


def _init_process_group(address: str, world_size: int, rank: int) -> str:
    """NCCL in a worker that sees a GPU, gloo in one that does not."""
    import datetime

    import torch
    import torch.distributed as dist

    backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(0)  # the first of the GPUs this worker sees
    dist.init_process_group(
        backend, init_method=f"tcp://{address}", world_size=world_size,
        rank=rank, timeout=datetime.timedelta(seconds=_TIMEOUT_S))
    return backend


def _destroy_process_group() -> None:
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


class TorchConfig(BackendConfig):
    """The gang's process group; its backend follows what each worker
    sees (NCCL with a GPU, gloo without), so there is nothing to set."""

    def backend_cls(self):
        return _TorchBackend


class _TorchBackend(Backend):
    def on_start(self, worker_group, backend_config: TorchConfig):
        workers = worker_group.workers
        hosts = {i["host"] for i in gang_get(
            [w.node_info.remote() for w in workers], timeout=_TIMEOUT_S)}
        address = ray_tpu_torch.get(workers[0].execute.remote(
            _address, len(hosts) == 1), timeout=_TIMEOUT_S)
        gang_get([w.execute.remote(_init_process_group, address,
                                   len(workers), rank)
                  for rank, w in enumerate(workers)], timeout=_TIMEOUT_S)

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
            gang_get([w.execute.remote(_destroy_process_group)
                      for w in worker_group.workers], timeout=30.0)
        except Exception as e:  # noqa: BLE001 — teardown must go on
            logger.warning("destroy_process_group failed: %s", e)
