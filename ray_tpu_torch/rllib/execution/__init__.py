"""Execution-plane building blocks for the rllib stack (counterpart of
``ray_tpu/rllib/execution``; reference: rllib/execution/ — replay ops,
learner threads, rollout ops).  Here the package holds the distributed
replay plane (replay_plane.py)."""
from ray_tpu_torch.rllib.execution.replay_plane import (  # noqa: F401
    ReplayBatch,
    ReplayPlane,
    ReplayShard,
    ShardCore,
    compute_nstep,
    run_actor_replay_iter,
)
