"""RLHF: PPO fine-tuning of an LM whose rollouts run through the serving
engine (counterpart of ``ray_tpu/rllib/algorithms/rlhf``).

Generation rides the continuous-batching decode engine (behavior
logprobs and weight versions captured per token), learning rides
``run_ppo_sgd`` on ``GPT2WithValue`` (on the card: the flash forward, dq
and dkv kernels at a padded length of 1024 or more), and fresh weights
flow learner -> engine through ``LLMEngine.swap_weights``, a
token-boundary hot swap off a one-put broadcast.
"""
from ray_tpu_torch.rllib.algorithms.rlhf.ppo_seq import (  # noqa: F401
    SeqPPOLearner,
    sequence_logprobs,
    sequence_ppo_loss,
)
from ray_tpu_torch.rllib.algorithms.rlhf.reward import (  # noqa: F401
    RewardScorer,
    target_token_reward,
    token_set_reward,
)
from ray_tpu_torch.rllib.algorithms.rlhf.loop import (  # noqa: F401
    RLHFConfig,
    RLHFLoop,
)
from ray_tpu_torch.rllib.algorithms.rlhf.rollout_engine import (  # noqa: F401
    EngineHost,
    RemoteEngine,
)
