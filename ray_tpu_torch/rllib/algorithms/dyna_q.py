"""Dyna-Q: model-based DQN, the Dyna architecture (counterpart of
``ray_tpu/rllib/algorithms/dyna_q.py``; reference family: rllib's
model-based algorithms, MBMPO, rllib/algorithms/mbmpo/ — learn a dynamics
model from real transitions, train the policy on imagined ones).

Built on the port's DQN (``dqn.py``): the same epsilon-greedy rollout
into the device ring with its host cursor, then, each iteration,
``model_updates_per_iter`` fits of the dynamics model on real replayed
transitions (``(obs, one-hot action) -> (delta obs, reward, done
logit)``, ``adam(model_lr)``), then, once the ring holds
``learning_starts`` rows, ``num_updates_per_iter`` double-Q updates
(mean squared TD error, ``adam(lr)``, the soft target update), each on
a real minibatch plus ``imagined_ratio`` times as many imagined rows:
real replayed states, an action epsilon-greedy (0.1) under the current
Q net, the model's prediction.  Both kinds of update draw their rows and
noise through ``AnakinUpdates``, which on the card replays each from a
CUDA graph of its own.  Neither optimizer clips, as in the JAX package.
"""
from __future__ import annotations

import copy
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ray_tpu_torch.models.mlp import MLP
from ray_tpu_torch.rllib.algorithms.algorithm import make_env
from ray_tpu_torch.rllib.algorithms.dqn import (
    AnakinUpdates,
    DQNConfig,
    Metrics,
    QNetwork,
    ReplayAlgorithm,
    ReplayLearner,
    epsilon_greedy,
    make_anakin_offpolicy,
    polyak_,
    stack_means,
)
from ray_tpu_torch.rllib.utils import mesh as mesh_util
from ray_tpu_torch.rllib.utils.cuda_graphs import capturable_adam

IMAGINED_EPSILON = 0.1


class DynaQConfig(DQNConfig):
    def __init__(self):
        super().__init__()
        self.algo_class = DynaQ
        # Model-based knobs: imagined minibatches per real update and
        # the dynamics-model learning rate.
        self.model_lr = 1e-3
        self.imagined_ratio = 1.0   # imagined batch size / real batch size
        self.model_updates_per_iter = 4


class DynamicsModel(torch.nn.Module):
    """``(obs, action) -> (next obs, reward, done logit)``: an ``MLP``
    (``net``) over the obs and the one-hot action predicting the obs's
    change, the reward and the done logit."""

    def __init__(self, obs_dim: int, num_actions: int, hiddens,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.obs_dim, self.num_actions = obs_dim, num_actions
        self.net = MLP(obs_dim + num_actions, tuple(hiddens), obs_dim + 2,
                       generator=generator)

    def forward(self, obs: torch.Tensor, action: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        onehot = F.one_hot(action.to(torch.int64),
                           self.num_actions).to(obs.dtype)
        out = self.net(torch.cat([obs, onehot], -1))
        d = self.obs_dim
        return obs + out[..., :d], out[..., d], out[..., d + 1]

    def loss(self, batch) -> torch.Tensor:
        next_pred, r_pred, d_logit = self(batch["obs"], batch["actions"])
        l_obs = ((next_pred - batch["next_obs"]) ** 2).mean()
        l_r = ((r_pred - batch["rewards"]) ** 2).mean()
        l_d = F.binary_cross_entropy_with_logits(d_logit, batch["dones"])
        return l_obs + l_r + l_d


class DynamicsLearner(ReplayLearner):
    """The dynamics model and ``adam(model_lr)``: an update is one fit on
    a real replayed minibatch."""

    def __init__(self, config, obs_dim: int, num_actions: int, device,
                 generator: Optional[torch.Generator] = None):
        super().__init__(config, device)
        self.module = DynamicsModel(obs_dim, num_actions, config.hiddens,
                                    generator).to(device)
        self._params = list(self.module.parameters())
        self._update_fn, self.optimizer = mesh_util.build_update_plan(
            config, config.model_lr, None, self._params)
        capturable_adam(self.optimizer, self.device)

    def device_update(self, batch, noise=(), kind=None) -> Metrics:
        loss = self.module.loss(batch)
        self._update_fn(torch.autograd.grad(loss, self._params))
        return {"model_loss": loss.detach()}


class DynaQLearner(ReplayLearner):
    """The Q network, its target copy, ``adam(lr)`` and the dynamics
    model (``model``, a ``DynamicsLearner``); ``replay`` is the ring the
    imagined rows start from.  An update draws the imagined rows' ring
    indices, exploration uniforms and random actions (``draw_specs``)."""

    def __init__(self, config, obs_dim: int, num_actions: int, device,
                 generator: Optional[torch.Generator] = None):
        super().__init__(config, device)
        self.module = QNetwork(obs_dim, num_actions, tuple(config.hiddens),
                               generator).to(device)
        self.target = copy.deepcopy(self.module).requires_grad_(False)
        self._params = list(self.module.parameters())
        self._target_params = list(self.target.parameters())
        self._update_fn, self.optimizer = mesh_util.build_update_plan(
            config, config.lr, None, self._params)
        capturable_adam(self.optimizer, self.device)
        self.model = DynamicsLearner(config, obs_dim, num_actions, device,
                                     generator)
        self.num_actions = num_actions
        self.replay = None

    def draw_specs(self, batch_size: int):
        n = int(batch_size * self.config.imagined_ratio)
        return [("rows", (n,)), ("uniform", (n,)), (self.num_actions, (n,))]

    @torch.no_grad()
    def imagine(self, idx, explore_u, random_a) -> Dict[str, torch.Tensor]:
        """Dyna imagination: start from REAL replayed states (rows
        ``idx``), act epsilon-greedily with the CURRENT Q net, step the
        MODEL."""
        obs = self.replay.obs[idx]
        greedy = self.module(obs).argmax(-1)
        act = torch.where(explore_u < IMAGINED_EPSILON, random_a, greedy)
        next_obs, reward, done_logit = self.model.module(obs, act)
        return {"obs": obs, "actions": act, "rewards": reward,
                "next_obs": next_obs,
                "dones": (torch.sigmoid(done_logit) > 0.5).to(torch.float32)}

    def q_loss(self, batch) -> torch.Tensor:
        q = self.module(batch["obs"]).gather(
            1, batch["actions"][:, None]).squeeze(1)
        with torch.no_grad():
            # Double-Q: online argmax, target evaluation.
            na = self.module(batch["next_obs"]).argmax(-1)
            nv = self.target(batch["next_obs"]).gather(
                1, na[:, None]).squeeze(1)
            target = batch["rewards"] + self.config.gamma * (
                1.0 - batch["dones"]) * nv
        return ((q - target) ** 2).mean()

    def device_update(self, batch, noise=(), kind=None) -> Metrics:
        imag = self.imagine(*noise)
        full = {k: torch.cat([batch[k], imag[k]]) for k in batch}
        loss = self.q_loss(full)
        self._update_fn(torch.autograd.grad(loss, self._params))
        polyak_(self._target_params, self._params,
                self.config.target_network_tau)
        return {"total_loss": loss.detach()}

    def checkpoint_state(self) -> Dict[str, Any]:
        # The Q network and the dynamics model.
        return {**{f"q.{k}": v for k, v in self.module.state_dict().items()},
                **{f"model.{k}": v
                   for k, v in self.model.module.state_dict().items()}}

    def load_checkpoint_state(self, state: Dict[str, Any]) -> None:
        for prefix, module in (("q.", self.module),
                               ("model.", self.model.module)):
            module.load_state_dict({k[len(prefix):]: v
                                    for k, v in state.items()
                                    if k.startswith(prefix)})


def make_anakin_dynaq(config: DynaQConfig, device):
    """Builds the initial state (the Q net and the model from
    ``config.seed`` through a CPU generator) and the train step on
    ``device``: DQN's rollout, then the model fits, then the Q updates.
    Returns ``(state, step, env steps an iteration)``."""
    env = make_env(config)
    learner = DynaQLearner(config, env.obs_dim, env.num_actions, device,
                           torch.Generator().manual_seed(config.seed))
    module = learner.module
    N = config.num_envs

    def act(obs, gen, tick):
        eps = min(max(1.0 - (1.0 - config.epsilon_final) * tick * N
                      / config.epsilon_decay_steps,
                      config.epsilon_final), 1.0)
        return epsilon_greedy(module(obs), gen, eps)

    model_updates = []

    def fit_model(state) -> Dict[str, torch.Tensor]:
        return stack_means([
            model_updates[0].update(state.replay.size, state.generator)
            for _ in range(config.model_updates_per_iter)])

    state, step, steps = make_anakin_offpolicy(
        config, device, env, learner, act, config.dqn_batch_size,
        loss_names=("total_loss",), before_updates=fit_model)
    # The ring's tensors never move: the imagination and the model's
    # updates read them through the first state's ring.
    learner.replay = state.replay
    model_updates.append(AnakinUpdates(learner.model, state.replay,
                                       config.dqn_batch_size))
    state.learner.model_updates = model_updates[0]
    return state, step, steps


class DynaQ(ReplayAlgorithm):
    _default_config_cls = DynaQConfig
    _make_anakin = make_anakin_dynaq
    _batch_key = "dqn_batch_size"

    def _setup_actor_mode(self):
        raise NotImplementedError("DynaQ has no actor mode (anakin only, "
                                  "as in the JAX package)")
