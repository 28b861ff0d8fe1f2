"""QMIX: cooperative multi-agent Q-learning with monotonic value mixing
(counterpart of ``ray_tpu/rllib/algorithms/qmix.py``; reference:
rllib/algorithms/qmix/ — QMixTorchPolicy: per-agent Q networks and a
state-conditioned hypernetwork mixer whose non-negative weights keep
argmax_a Q_tot = the per-agent argmaxes).

On the array-axis multi-agent protocol (``env/multi_agent.py``): agents
are a leading axis, the per-agent net is weight-shared (the agent id
rides in the observation), and the global state is the agents'
observations concatenated.  The step is the replay family's
(``dqn.make_anakin_offpolicy``): the rollout writes each game's step into
the device ring (obs ``[M, obs_dim]``, actions ``[M]``, the shared team
reward, done), then ``num_updates_per_iter`` mixed TD updates on uniform
draws, each with the soft target update at ``target_network_tau``
(``AnakinUpdates``: a CUDA graph on the card).  The optimizer is
``adam(lr)`` without clipping, as the JAX package's.
"""
from __future__ import annotations

import copy
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch.models.mlp import MLP
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.dqn import (
    Metrics,
    ReplayAlgorithm,
    ReplayLearner,
    epsilon_greedy,
    make_anakin_offpolicy,
    polyak_,
)
from ray_tpu_torch.rllib.env.multi_agent import make_ma_env
from ray_tpu_torch.rllib.utils import mesh as mesh_util
from ray_tpu_torch.rllib.utils.cuda_graphs import capturable_adam


class QMixConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(algo_class=QMix)
        self.env = "CoordinationGame-v0"
        self.lr = 5e-4
        self.buffer_size = 20_000
        self.learning_starts = 500
        self.target_network_tau = 0.01
        self.epsilon_final = 0.05
        self.epsilon_decay_steps = 30_000
        self.num_updates_per_iter = 4
        self.qmix_batch_size = 128
        self.mixing_embed_dim = 32
        self.num_envs = 32
        self.unroll_length = 16


class Mixer(nn.Module):
    """Monotonic mixing network: Q_tot = w2(s)^T elu(W1(s) q + b1) + b2,
    with |W1|, |w2| enforcing dQ_tot/dQ_i >= 0 (reference: qmix/model.py
    QMixer).  Each hypernetwork is an ``MLP`` of one 64-wide layer."""

    def __init__(self, num_agents: int, state_dim: int, embed: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.M, self.embed = num_agents, embed
        self.hyper_w1 = MLP(state_dim, (64,), num_agents * embed,
                            generator=generator)
        self.hyper_b1 = MLP(state_dim, (64,), embed, generator=generator)
        self.hyper_w2 = MLP(state_dim, (64,), embed, generator=generator)
        self.hyper_b2 = MLP(state_dim, (64,), 1, generator=generator)

    def forward(self, qs: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
        """qs: [B, M] chosen per-agent values; state: [B, s]."""
        B = qs.shape[0]
        w1 = self.hyper_w1(state).abs().view(B, self.M, self.embed)
        b1 = self.hyper_b1(state)
        w2 = self.hyper_w2(state).abs()
        b2 = self.hyper_b2(state)[:, 0]
        h = F.elu(torch.einsum("bm,bme->be", qs, w1) + b1)
        return torch.einsum("be,be->b", h, w2) + b2


class QMixNet(nn.Module):
    """The shared agent Q net (``agent``: obs ``[..., M, obs_dim]`` ->
    ``[..., M, A]``) and the mixer (``mixer``), the JAX package's
    ``{"agent": ..., "mixer": ...}``."""

    def __init__(self, num_agents: int, obs_dim: int, num_actions: int,
                 hiddens, embed: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.agent = MLP(obs_dim, tuple(hiddens), num_actions,
                         generator=generator)
        self.mixer = Mixer(num_agents, num_agents * obs_dim, embed,
                           generator=generator)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        return self.agent(obs)


class QMixLearner(ReplayLearner):
    """``QMixNet``, its target copy and ``adam(lr)`` on ``device``: an
    update is one mixed double-Q TD step and the polyak sync."""

    def __init__(self, config, num_agents: int, obs_dim: int,
                 num_actions: int, device,
                 generator: Optional[torch.Generator] = None):
        super().__init__(config, device)
        self.module = QMixNet(num_agents, obs_dim, num_actions,
                              config.hiddens, config.mixing_embed_dim,
                              generator).to(device)
        self.target = copy.deepcopy(self.module).requires_grad_(False)
        self._params = list(self.module.parameters())
        self._target_params = list(self.target.parameters())
        self._update_fn, self.optimizer = mesh_util.build_update_plan(
            config, config.lr, None, self._params)
        capturable_adam(self.optimizer, self.device)

    def td_loss(self, batch) -> torch.Tensor:
        B = batch["obs"].shape[0]
        state_dim = batch["obs"][0].numel()
        qs = self.module.agent(batch["obs"])                      # [B, M, A]
        chosen = qs.gather(-1, batch["actions"][..., None])[..., 0]
        q_tot = self.module.mixer(chosen, batch["obs"].reshape(B, state_dim))
        with torch.no_grad():
            na = self.module.agent(batch["next_obs"]).argmax(-1)  # [B, M]
            nv = self.target.agent(batch["next_obs"]).gather(
                -1, na[..., None])[..., 0]
            nq_tot = self.target.mixer(
                nv, batch["next_obs"].reshape(B, state_dim))
            # CoordinationGame's reward is shared: the team reward is any
            # agent's.
            target = batch["rewards"] + self.config.gamma * (
                1.0 - batch["dones"]) * nq_tot
        return ((q_tot - target) ** 2).mean()

    def device_update(self, batch, noise=(), kind=None) -> Metrics:
        loss = self.td_loss(batch)
        self._update_fn(torch.autograd.grad(loss, self._params))
        polyak_(self._target_params, self._params,
                self.config.target_network_tau)
        return {"total_loss": loss.detach()}

    def checkpoint_state(self) -> Dict[str, Any]:
        return self.module.state_dict()

    def load_checkpoint_state(self, state: Dict[str, Any]) -> None:
        self.module.load_state_dict(state)


class TeamReward:
    """The multi-agent env as the replay rollout steps it: the shared
    reward of each game (agent 0's) in place of the ``[G, M]`` rewards."""

    def __init__(self, env):
        self.env = env

    def step(self, state, actions, generator):
        state, obs, rewards, done, info = self.env.step(state, actions,
                                                        generator)
        return state, obs, rewards[:, 0], done, info

    def __getattr__(self, name):
        return getattr(self.env, name)


def make_anakin_qmix(config: QMixConfig, device):
    """Builds the initial state (the networks from ``config.seed`` through
    a CPU generator) and the train step on ``device``: per-agent epsilon
    greedy on a schedule over env steps (games stepped), the mixed TD
    updates on uniform draws of ``qmix_batch_size``.  Returns ``(state,
    step, env steps an iteration)``: N * T * M agent steps, as the JAX
    package counts them."""
    env = make_ma_env(config.env) if isinstance(config.env, str) \
        else config.env
    M, A, obs_dim = env.num_agents, env.num_actions, env.obs_dim
    learner = QMixLearner(config, M, obs_dim, A, device,
                          torch.Generator().manual_seed(config.seed))
    agent = learner.module.agent
    N = config.num_envs

    def act(obs, gen, tick):
        eps = min(max(1.0 - (1.0 - config.epsilon_final) * tick * N
                      / config.epsilon_decay_steps,
                      config.epsilon_final), 1.0)
        return epsilon_greedy(agent(obs), gen, eps)

    state, step, _ = make_anakin_offpolicy(
        config, device, TeamReward(env), learner, act,
        config.qmix_batch_size, action_shape=(M,),
        loss_names=("total_loss",), obs_shape=(M, obs_dim))
    return state, step, N * config.unroll_length * M


class QMix(ReplayAlgorithm):
    _default_config_cls = QMixConfig
    _make_anakin = make_anakin_qmix
    _batch_key = "qmix_batch_size"

    def _setup_actor_mode(self):
        raise NotImplementedError("QMix has no actor mode (anakin only, as "
                                  "in the JAX package)")
