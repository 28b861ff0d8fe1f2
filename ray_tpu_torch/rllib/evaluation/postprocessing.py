"""GAE advantage estimation inside the Anakin train step (counterpart of
``gae_jax`` in ``ray_tpu/rllib/evaluation/postprocessing.py``).  The
numpy ``compute_gae`` serves the actor path, which the port does not have
yet."""
from __future__ import annotations

import torch


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
