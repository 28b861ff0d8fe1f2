"""Multi-agent envs on the device (counterpart of
``ray_tpu/rllib/env/multi_agent.py``; reference surface: MultiAgentEnv,
rllib/env/multi_agent_env.py — dict obs/rewards keyed by agent id,
per-agent done).

As in the JAX package, agents are a leading array axis, not dict keys;
and as ``torch_envs.py`` does for the single-agent envs, the env is
written for the batch of G games: ``reset(num_games, generator, device)
-> (state, obs [G, M, obs_dim])``, ``step(state, actions [G, M],
generator) -> (state, obs [G, M, d], rewards [G, M], done [G], info)``.

``CoordinationGame``: the canonical shared-policy testbed.  M agents each
pick an action; everyone is rewarded when ALL picked the SAME action.
Observations carry the one-hot previous joint action plus the agent's own
one-hot id, so a shared policy must use the id/history to coordinate.
Its steps draw nothing (the generator is taken for the protocol), so its
trajectories are the JAX env's bit for bit.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

State = Dict[str, torch.Tensor]


class CoordinationGame:
    num_agents = 2
    num_actions = 2
    max_steps = 16

    @property
    def obs_dim(self) -> int:
        # one-hot previous joint action (A^M) + one-hot agent id (M)
        return self.num_actions ** self.num_agents + self.num_agents

    def _obs(self, prev_joint: torch.Tensor) -> torch.Tensor:
        """[G, M, obs_dim] from the previous joint-action indices [G]."""
        G, M = prev_joint.shape[0], self.num_agents
        joint_oh = F.one_hot(prev_joint.to(torch.int64),
                             self.num_actions ** M).to(torch.float32)
        ids = torch.eye(M, device=prev_joint.device)
        return torch.cat([joint_oh[:, None, :].expand(G, M, -1),
                          ids[None].expand(G, M, M)], -1)

    def reset_state(self, num_games: int, generator: torch.Generator,
                    device) -> State:
        zeros = torch.zeros(num_games, dtype=torch.int32, device=device)
        return {"prev_joint": zeros, "t": zeros.clone()}

    def reset(self, num_games: int, generator: torch.Generator, device
              ) -> Tuple[State, torch.Tensor]:
        state = self.reset_state(num_games, generator, device)
        return state, self._obs(state["prev_joint"])

    def step(self, state: State, actions: torch.Tensor,
             generator: torch.Generator):
        """actions: [G, M] integers."""
        M = self.num_agents
        match = (actions == actions[:, :1]).all(-1)
        rewards = torch.where(match, 1.0, 0.0)[:, None].expand(
            -1, M).contiguous()
        powers = self.num_actions ** torch.arange(M, device=actions.device)
        joint = (actions * powers).sum(-1).to(torch.int32)
        t = state["t"] + 1
        done = t >= self.max_steps
        fresh = self.reset_state(actions.shape[0], generator, actions.device)
        new_state = {
            "prev_joint": torch.where(done, fresh["prev_joint"], joint),
            "t": torch.where(done, fresh["t"], t),
        }
        obs = torch.where(done[:, None, None],
                          self._obs(fresh["prev_joint"]), self._obs(joint))
        return new_state, obs, rewards, done, {}


MA_REGISTRY = {
    "CoordinationGame-v0": CoordinationGame,
}


def make_ma_env(name: str):
    if name not in MA_REGISTRY:
        raise ValueError(
            f"unknown multi-agent env {name!r}; have {list(MA_REGISTRY)}")
    return MA_REGISTRY[name]()


def ma_vector_reset(env, generator: torch.Generator, num_games: int, device):
    """[G] games -> (states, obs [G, M, d])."""
    return env.reset(num_games, generator, device)


def ma_vector_step(env, states: State, actions: torch.Tensor,
                   generator: torch.Generator):
    """actions [G, M] -> (states, obs [G, M, d], rewards [G, M], done [G],
    info)."""
    return env.step(states, actions, generator)
