"""Backend interface (reference: python/ray/train/backend.py Backend/
BackendConfig; the torch/NCCL impl it replaces: train/torch/config.py:69).

Copied from ``ray_tpu/train/backend.py`` (the JAX package).
"""
from __future__ import annotations

from typing import Any, Dict, List


class BackendConfig:
    def backend_cls(self):
        return Backend


class Backend:
    """Hooks run by the BackendExecutor around worker-group lifetime."""

    def on_start(self, worker_group, backend_config: BackendConfig):
        pass

    def on_training_start(self, worker_group, backend_config: BackendConfig):
        pass

    def on_training_failure(self, worker_group, backend_config: BackendConfig,
                            error: BaseException):
        """Called when the executor detects a gang-poisoning failure (a
        rank's process died, or the group missed its deadline) BEFORE the
        worker group is torn down for an elastic restart.  Backends log /
        record state here; the group itself is unusable — surviving ranks
        may be stuck in a dead collective (reference:
        BackendExecutor._increment_failures + backend failure handling)."""
        pass

    def on_shutdown(self, worker_group, backend_config: BackendConfig):
        pass


class TestConfig(BackendConfig):
    """No-op backend for executor tests (reference:
    python/ray/train/tests/test_backend.py:45)."""

    def backend_cls(self):
        return Backend
