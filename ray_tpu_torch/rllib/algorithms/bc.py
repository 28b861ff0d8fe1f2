"""The greedy evaluator of ``ray_tpu/rllib/algorithms/bc.py`` (BC itself
comes with the rest of RLlib, ROADMAP Queue 1 item 7)."""
from __future__ import annotations

from typing import Any, Callable, Tuple

import torch

from ray_tpu_torch.rllib.env.torch_envs import (
    count_episodes,
    vector_reset,
    vector_step,
)


Policy = Callable[[Any, torch.Tensor, torch.Tensor],
                  Tuple[Any, torch.Tensor]]


def greedy_eval_rollout(env, policy: Policy,
                        init_memory: Callable[[int, torch.device], Any],
                        num_eval_envs: int = 16
                        ) -> Callable[[torch.Generator, int], torch.Tensor]:
    """``eval_rollout(generator, num_steps)``: ``num_eval_envs`` envs reset
    and stepped from ``generator`` (on the policy's device) for
    ``num_steps`` steps, each action from ``policy(memory, obs,
    prev_done) -> (memory, action)``, the memory starting as
    ``init_memory(num_eval_envs, device)``.  Returns the mean return of
    the episodes that ended (0 if none did), a 0-d tensor on the
    device."""

    @torch.no_grad()
    def eval_rollout(generator: torch.Generator, num_steps: int):
        device = generator.device
        env_states, obs = vector_reset(env, generator, num_eval_envs, device)
        memory = init_memory(num_eval_envs, device)
        done = torch.zeros(num_eval_envs, dtype=torch.bool, device=device)
        ep_ret = torch.zeros(num_eval_envs, device=device)
        dsum = torch.zeros((), device=device)
        dcnt = torch.zeros((), device=device)
        for _ in range(num_steps):
            memory, action = policy(memory, obs, done)
            env_states, obs, reward, done, _ = vector_step(
                env, env_states, action, generator)
            ep_ret, dsum, dcnt = count_episodes(ep_ret, dsum, dcnt, reward,
                                                done)
        return dsum / dcnt.clamp_min(1.0)

    return eval_rollout


def make_greedy_eval_rollout(env, module, num_eval_envs: int = 16):
    """The greedy rollout of a memoryless module
    (``module.forward_inference``)."""
    return greedy_eval_rollout(
        env, lambda memory, obs, done: (None, module.forward_inference(obs)),
        lambda n, device: None, num_eval_envs)
