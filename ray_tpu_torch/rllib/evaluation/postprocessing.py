"""GAE advantage estimation (counterpart of
``ray_tpu/rllib/evaluation/postprocessing.py``; reference:
rllib/evaluation/postprocessing.py compute_advantages).  ``gae_torch``
runs inside the Anakin train step on the device and in the CPU rollout
workers on their fragments (where the JAX package runs ``gae_jax``); the
numpy ``compute_gae`` works in place on one time-ordered ``SampleBatch``.
"""
from __future__ import annotations

import numpy as np
import torch

from ray_tpu_torch.rllib.policy.sample_batch import (
    ADVANTAGES,
    DONES,
    REWARDS,
    SampleBatch,
    VALUE_TARGETS,
    VF_PREDS,
)


def compute_gae(batch: SampleBatch, last_value: float, gamma: float = 0.99,
                lambda_: float = 0.95) -> SampleBatch:
    """In-place GAE over a time-ordered fragment (dones mark resets), in
    float64, stored as float32."""
    rewards = batch[REWARDS].astype(np.float64)
    values = batch[VF_PREDS].astype(np.float64)
    dones = batch[DONES].astype(np.float64)
    n = len(rewards)
    adv = np.zeros(n)
    last_gae = 0.0
    next_value = last_value
    for t in range(n - 1, -1, -1):
        nonterminal = 1.0 - dones[t]
        delta = rewards[t] + gamma * next_value * nonterminal - values[t]
        last_gae = delta + gamma * lambda_ * nonterminal * last_gae
        adv[t] = last_gae
        next_value = values[t]
    batch[ADVANTAGES] = adv.astype(np.float32)
    batch[VALUE_TARGETS] = (adv + values).astype(np.float32)
    return batch


def gae_torch(rewards: torch.Tensor, values: torch.Tensor,
              dones: torch.Tensor, last_value: torch.Tensor,
              gamma: float = 0.99, lambda_: float = 0.95):
    """rewards/values/dones: ``[T, N]`` time-major; last_value ``[N]``.
    Returns (advantages, value_targets), ``[T, N]``.  A reversed loop over
    T with ``gae_jax``'s scan body, operation for operation."""
    nonterminal = 1.0 - dones.to(torch.float32)
    adv = torch.empty_like(values)
    last_gae = torch.zeros_like(last_value)
    next_value = last_value
    for t in range(rewards.shape[0] - 1, -1, -1):
        nt = nonterminal[t]
        delta = rewards[t] + gamma * next_value * nt - values[t]
        last_gae = delta + gamma * lambda_ * nt * last_gae
        adv[t] = last_gae
        next_value = values[t]
    return adv, adv + values
