"""Reinforcement learning of the port (counterpart of ``ray_tpu/rllib``):
feedforward PPO in Anakin mode, with the envs batched on the device
(``env/torch_envs.py``).  IMPALA/APPO, the other algorithms, actor mode
and the rest follow in later slices (ROADMAP, Queue 1)."""
from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm  # noqa: F401
from ray_tpu_torch.rllib.algorithms.algorithm_config import (  # noqa: F401
    AlgorithmConfig,
)
from ray_tpu_torch.rllib.algorithms.ppo import PPO, PPOConfig  # noqa: F401
from ray_tpu_torch.rllib.core.rl_module import (  # noqa: F401
    DiscreteActorCritic,
    RLModuleSpec,
)
