"""Reinforcement learning of the port (counterpart of ``ray_tpu/rllib``).

Two execution modes, as in the JAX package: Anakin mode, with the envs
batched on the device (``env/torch_envs.py``): PPO with a feedforward,
recurrent (LSTM) or attention-memory (GTrXL) policy, IMPALA and APPO with
V-trace, and greedy ``evaluate``; and actor mode, in which CPU rollout
actors step numpy envs (``env/py_envs.py``) and stream fragments through
the object store to a learner on the device (``evaluation/worker_set.py``,
``evaluation/sample_stream.py``, ``core/learner.py``): PPO (lockstep or
streaming), IMPALA and APPO.  The off-policy actor path and the other
algorithms follow in later slices (ROADMAP, Queue 1).

The names below load on first use, so that importing a numpy module of
this package (an env subprocess unpickling ``env/py_envs.py``) does not
import torch.
"""
import importlib

_EXPORTS = {
    "Algorithm": "ray_tpu_torch.rllib.algorithms.algorithm",
    "AlgorithmConfig": "ray_tpu_torch.rllib.algorithms.algorithm_config",
    "APPO": "ray_tpu_torch.rllib.algorithms.appo",
    "APPOConfig": "ray_tpu_torch.rllib.algorithms.appo",
    "IMPALA": "ray_tpu_torch.rllib.algorithms.impala",
    "IMPALAConfig": "ray_tpu_torch.rllib.algorithms.impala",
    "PPO": "ray_tpu_torch.rllib.algorithms.ppo",
    "PPOConfig": "ray_tpu_torch.rllib.algorithms.ppo",
    "TorchLearner": "ray_tpu_torch.rllib.core.learner",
    "LearnerGroup": "ray_tpu_torch.rllib.core.learner",
    "DiscreteActorCritic": "ray_tpu_torch.rllib.core.rl_module",
    "RLModuleSpec": "ray_tpu_torch.rllib.core.rl_module",
    "MultiAgentBatch": "ray_tpu_torch.rllib.policy.sample_batch",
    "SampleBatch": "ray_tpu_torch.rllib.policy.sample_batch",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(_EXPORTS[name]), name)
    globals()[name] = value
    return value
