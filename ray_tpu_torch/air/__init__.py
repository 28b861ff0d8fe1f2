"""AIR-equivalent glue: configs, Checkpoint, session, Result.

Reference: python/ray/air/ (Checkpoint air/checkpoint.py:63, configs
air/config.py:79-670, session air/session.py:41).

Copied from ``ray_tpu/air/__init__.py`` (the JAX package).
"""
from ray_tpu_torch.air.checkpoint import Checkpoint, ShardedCheckpoint  # noqa: F401
from ray_tpu_torch.air.config import (  # noqa: F401
    CheckpointConfig,
    FailureConfig,
    RunConfig,
    SyncConfig,
    ScalingConfig,
)
from ray_tpu_torch.air.result import Result  # noqa: F401
from ray_tpu_torch.air import session  # noqa: F401
