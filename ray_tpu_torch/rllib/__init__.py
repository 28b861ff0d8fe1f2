"""Reinforcement learning of the port (counterpart of ``ray_tpu/rllib``).

Two execution modes, as in the JAX package: Anakin mode, with the envs
batched on the device (``env/torch_envs.py``): PPO with a feedforward,
recurrent (LSTM) or attention-memory (GTrXL) policy, IMPALA and APPO with
V-trace, greedy ``evaluate``, and the replay family with its replay ring
on the device: DQN, SAC, TD3 and DDPG; and actor mode, in which CPU
rollout actors step numpy envs (``env/py_envs.py``) and stream fragments
through the object store to a learner on the device
(``evaluation/worker_set.py``, ``evaluation/sample_stream.py``,
``core/learner.py``): PPO (lockstep or streaming), IMPALA and APPO, and
DQN, SAC, TD3 and DDPG through the replay plane
(``execution/replay_plane.py``).  The other algorithms follow in later
slices (ROADMAP, Queue 1).

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
    "DDPG": "ray_tpu_torch.rllib.algorithms.td3",
    "DDPGConfig": "ray_tpu_torch.rllib.algorithms.td3",
    "DQN": "ray_tpu_torch.rllib.algorithms.dqn",
    "DQNConfig": "ray_tpu_torch.rllib.algorithms.dqn",
    "IMPALA": "ray_tpu_torch.rllib.algorithms.impala",
    "IMPALAConfig": "ray_tpu_torch.rllib.algorithms.impala",
    "PPO": "ray_tpu_torch.rllib.algorithms.ppo",
    "PPOConfig": "ray_tpu_torch.rllib.algorithms.ppo",
    "SAC": "ray_tpu_torch.rllib.algorithms.sac",
    "SACConfig": "ray_tpu_torch.rllib.algorithms.sac",
    "TD3": "ray_tpu_torch.rllib.algorithms.td3",
    "TD3Config": "ray_tpu_torch.rllib.algorithms.td3",
    "TorchLearner": "ray_tpu_torch.rllib.core.learner",
    "LearnerGroup": "ray_tpu_torch.rllib.core.learner",
    "DiscreteActorCritic": "ray_tpu_torch.rllib.core.rl_module",
    "RLModuleSpec": "ray_tpu_torch.rllib.core.rl_module",
    "MultiAgentBatch": "ray_tpu_torch.rllib.policy.sample_batch",
    "SampleBatch": "ray_tpu_torch.rllib.policy.sample_batch",
}

# The registry (``ALGORITHMS``: name -> config class, loaded on first
# use) holds the algorithms the port has; the JAX package's others come
# with later slices.
_REGISTRY = ("PPO", "IMPALA", "DQN", "SAC", "APPO", "TD3", "DDPG")

__all__ = sorted([*_EXPORTS, "ALGORITHMS", "get_algorithm_config"])


def get_algorithm_config(name: str):
    """Registry lookup (reference: rllib/algorithms/registry.py)."""
    if name not in _REGISTRY:
        raise ValueError(f"unknown algorithm {name!r}; have "
                         f"{list(_REGISTRY)}")
    return __getattr__(f"{name}Config")()


def __getattr__(name):
    if name == "ALGORITHMS":
        value = {n: __getattr__(f"{n}Config") for n in _REGISTRY}
    elif name in _EXPORTS:
        value = getattr(importlib.import_module(_EXPORTS[name]), name)
    else:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    globals()[name] = value
    return value
