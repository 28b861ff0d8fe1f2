"""Reinforcement learning of the port (counterpart of ``ray_tpu/rllib``),
in Anakin mode, with the envs batched on the device
(``env/torch_envs.py``): PPO with a feedforward, recurrent (LSTM) or
attention-memory (GTrXL) policy, IMPALA and APPO with V-trace, and greedy
``evaluate``.  Actor mode, checkpoints and the other algorithms follow in
later slices (ROADMAP, Queue 1)."""
from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm  # noqa: F401
from ray_tpu_torch.rllib.algorithms.algorithm_config import (  # noqa: F401
    AlgorithmConfig,
)
from ray_tpu_torch.rllib.algorithms.appo import APPO, APPOConfig  # noqa: F401
from ray_tpu_torch.rllib.algorithms.impala import (  # noqa: F401
    IMPALA,
    IMPALAConfig,
)
from ray_tpu_torch.rllib.algorithms.ppo import PPO, PPOConfig  # noqa: F401
from ray_tpu_torch.rllib.core.rl_module import (  # noqa: F401
    DiscreteActorCritic,
    RLModuleSpec,
)
