"""SAC, soft actor-critic (counterpart of
``ray_tpu/rllib/algorithms/sac.py``; reference: rllib/algorithms/sac/ —
config surface: twin_q, target entropy 'auto', tau, initial_alpha; loss
structure sac_torch_policy.py actor/critic/alpha losses).

Continuous control with a squashed-Gaussian policy, twin Q heads, polyak
targets and the automatic entropy temperature (a plain Adam step on
``log_alpha``).  Anakin mode runs env stepping, the replay ring and the
updates on the device (``dqn.make_anakin_offpolicy``); actor mode takes
the replay family's CPU workers and replay plane (``dqn.ReplayAlgorithm``).

What differs from the JAX package: the losses take their Gaussian noise
as tensors (the JAX losses draw it from a key), and an update draws it
from a ``torch.Generator`` on the device.
"""
from __future__ import annotations

import copy
import math
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch.models.mlp import MLP
from ray_tpu_torch.rllib.algorithms.algorithm import make_env
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.dqn import (
    Metrics,
    ReplayAlgorithm,
    ReplayLearner,
    make_anakin_offpolicy,
    polyak_,
)

LOG_STD_MIN, LOG_STD_MAX = -10.0, 2.0


class SACConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(algo_class=SAC)
        self.lr = 3e-4
        self.buffer_size = 100_000
        self.learning_starts = 1_000
        self.tau = 0.005
        self.initial_alpha = 1.0
        self.target_entropy = "auto"  # -action_dim
        self.num_updates_per_iter = 8
        self.sac_batch_size = 256


def _bound(value, action_dim: int) -> torch.Tensor:
    return torch.as_tensor(np.asarray(value, np.float32)).expand(
        action_dim).clone()


class SquashedGaussianPolicy(nn.Module):
    """MLP → (mu, log_std); tanh squash scaled to the action bounds
    (``low``, ``high``: scalars or ``[action_dim]``)."""

    def __init__(self, obs_dim: int, action_dim: int, hiddens, low, high,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.net = MLP(obs_dim, tuple(hiddens), 2 * action_dim,
                       generator=generator)
        self.action_dim = action_dim
        low, high = _bound(low, action_dim), _bound(high, action_dim)
        self.register_buffer("scale", (high - low) / 2.0, persistent=False)
        self.register_buffer("center", (high + low) / 2.0, persistent=False)

    def dist_params(self, obs: torch.Tensor):
        mu, log_std = self.net(obs).chunk(2, dim=-1)
        return mu, log_std.clamp(LOG_STD_MIN, LOG_STD_MAX)

    def sample(self, obs: torch.Tensor,
               generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None):
        """Reparameterized sample + log-prob with the tanh correction;
        ``noise`` (standard normal, ``[N, action_dim]``) is drawn from
        ``generator`` when not given."""
        mu, log_std = self.dist_params(obs)
        if noise is None:
            noise = torch.randn(mu.shape, generator=generator,
                                device=mu.device)
        pre = mu + log_std.exp() * noise
        # Gaussian logp minus the tanh change-of-variables term
        # (numerically stable form: log(1 - tanh^2 x) = 2(log2 - x -
        # softplus(-2x))).
        logp = (-0.5 * noise ** 2 - log_std
                - 0.5 * math.log(2 * math.pi)).sum(-1)
        logp = logp - (2.0 * (math.log(2.0) - pre
                              - F.softplus(-2.0 * pre))).sum(-1)
        # Affine change of variables for the bound scaling: without the
        # -log(scale) term the density is off by log(scale) per action
        # dim, which skews the alpha controller's entropy target.
        logp = logp - self.scale.log().sum()
        return torch.tanh(pre) * self.scale + self.center, logp

    def mode(self, obs: torch.Tensor) -> torch.Tensor:
        mu, _ = self.dist_params(obs)
        return torch.tanh(mu) * self.scale + self.center

    forward = mode


class TwinQ(nn.Module):
    """Two independent Q(s, a) heads (reference: twin_q=True)."""

    def __init__(self, obs_dim: int, action_dim: int, hiddens,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.q1 = MLP(obs_dim + action_dim, tuple(hiddens), 1,
                      generator=generator)
        self.q2 = MLP(obs_dim + action_dim, tuple(hiddens), 1,
                      generator=generator)

    def forward(self, obs: torch.Tensor, action: torch.Tensor):
        x = torch.cat([obs, action], dim=-1)
        return self.q1(x)[..., 0], self.q2(x)[..., 0]


def make_sac_losses(pi: SquashedGaussianPolicy, q: TwinQ, q_target: TwinQ,
                    config, target_entropy: float):
    """The three SAC losses over an explicit minibatch — shared by the
    anakin path and the actor path, so the math exists once.  Each policy
    sample takes its standard-normal ``noise``; ``log_alpha`` is a 0-d
    tensor."""
    def q_loss(log_alpha, batch, noise):
        with torch.no_grad():
            next_a, next_logp = pi.sample(batch["next_obs"], noise=noise)
            tq1, tq2 = q_target(batch["next_obs"], next_a)
            target_v = torch.minimum(tq1, tq2) - log_alpha.exp() * next_logp
            target = batch["rewards"] + config.gamma * (
                1 - batch["dones"]) * target_v
        q1, q2 = q(batch["obs"], batch["actions"])
        return ((q1 - target) ** 2).mean() + ((q2 - target) ** 2).mean()

    def pi_loss(log_alpha, batch, noise):
        a, logp = pi.sample(batch["obs"], noise=noise)
        q1, q2 = q(batch["obs"], a)
        alpha = log_alpha.detach().exp()
        return (alpha * logp - torch.minimum(q1, q2)).mean(), logp

    def alpha_loss(log_alpha, logp):
        return -(log_alpha * (logp.detach() + target_entropy)).mean()

    return q_loss, pi_loss, alpha_loss


class SACLearner(ReplayLearner):
    """The policy, the twin Q and its target, ``log_alpha``, and an update
    plan for each (``clip_by_global_norm(grad_clip)`` then ``adam(lr)``)
    on ``device``: an update is the JAX step's — the critic, then the
    actor against the new critic, then alpha, then the polyak sync of the
    critic's target; its noise is two standard normals of the action's
    shape (the critic's target sample, the actor's sample)."""

    def __init__(self, config, obs_dim: int, action_dim: int, low, high,
                 device, generator: Optional[torch.Generator] = None):
        super().__init__(config, device)
        self.action_dim = action_dim
        self.module = self.pi = SquashedGaussianPolicy(
            obs_dim, action_dim, config.hiddens, low, high,
            generator).to(device)
        self.q = TwinQ(obs_dim, action_dim, config.hiddens,
                       generator).to(device)
        self.q_target = copy.deepcopy(self.q).requires_grad_(False)
        self.log_alpha = nn.Parameter(torch.tensor(
            math.log(config.initial_alpha), device=device))
        self.target_entropy = (-float(action_dim)
                               if config.target_entropy == "auto"
                               else float(config.target_entropy))
        self._pi_params = list(self.pi.parameters())
        self._q_params = list(self.q.parameters())
        self._q_target_params = list(self.q_target.parameters())
        self._pi_update, self.pi_opt = self._plan(self._pi_params)
        self._q_update, self.q_opt = self._plan(self._q_params)
        self._a_update, self.a_opt = self._plan([self.log_alpha])
        self.q_loss, self.pi_loss, self.alpha_loss = make_sac_losses(
            self.pi, self.q, self.q_target, config, self.target_entropy)

    def noise_shapes(self, batch_size: int):
        return [(batch_size, self.action_dim)] * 2

    def device_update(self, batch, noise, kind=None) -> Metrics:
        noise_q, noise_pi = noise
        ql = self.q_loss(self.log_alpha, batch, noise_q)
        self._q_update(torch.autograd.grad(ql, self._q_params))
        pl, logp = self.pi_loss(self.log_alpha, batch, noise_pi)
        self._pi_update(torch.autograd.grad(pl, self._pi_params))
        al = self.alpha_loss(self.log_alpha, logp)
        self._a_update(torch.autograd.grad(al, [self.log_alpha]))
        polyak_(self._q_target_params, self._q_params, self.config.tau)
        return {"critic_loss": ql.detach(), "actor_loss": pl.detach(),
                "alpha_loss": al.detach(),
                "alpha": self.log_alpha.detach().exp()}

    def get_weights(self) -> Dict[str, torch.Tensor]:
        """The policy's state dict, copied to the CPU."""
        return {k: v.detach().to("cpu", copy=True)
                for k, v in self.pi.state_dict().items()}

    def checkpoint_state(self) -> Dict[str, Any]:
        return {"pi": self.pi.state_dict(), "q": self.q.state_dict(),
                "q_target": self.q_target.state_dict(),
                "log_alpha": self.log_alpha.detach()}

    def load_checkpoint_state(self, state: Dict[str, Any]) -> None:
        self.pi.load_state_dict(state["pi"])
        self.q.load_state_dict(state["q"])
        self.q_target.load_state_dict(state["q_target"])
        with torch.no_grad():
            self.log_alpha.copy_(state["log_alpha"])


def continuous_space(env, algo: str):
    """(action_dim, low, high) of a continuous env; a discrete one
    raises."""
    adim = getattr(env, "action_dim", None)
    if adim is None:
        raise ValueError(f"{algo} needs a continuous (Box) action env; "
                         f"{type(env).__name__} is discrete")
    return adim, env.action_low, env.action_high


def make_anakin_sac(config: SACConfig, device):
    """Builds the initial state (the networks from ``config.seed`` through
    a CPU generator) and the train step on ``device``: the policy's
    samples as actions, the three SAC updates on uniform draws of
    ``sac_batch_size``.  Returns ``(state, step, env steps an
    iteration)``."""
    env = make_env(config)
    adim, low, high = continuous_space(env, "SAC")
    learner = SACLearner(config, env.obs_dim, adim, low, high, device,
                         torch.Generator().manual_seed(config.seed))
    pi = learner.pi
    state, step, steps = make_anakin_offpolicy(
        config, device, env, learner,
        lambda obs, gen, tick: pi.sample(obs, gen)[0],
        config.sac_batch_size, action_shape=(adim,),
        action_dtype=torch.float32,
        loss_names=("critic_loss", "actor_loss", "alpha_loss"))

    def train_step(state, on_phase=None):
        state, metrics = step(state, on_phase)
        metrics["alpha"] = learner.log_alpha.detach().exp()
        return state, metrics

    return state, train_step, steps


def policy_act_factory(policy_cls, *args) -> Callable:
    """The workers' ``act_factory`` for a continuous policy:
    ``policy_cls(*args)`` and ``act(obs, generator, explore_arg)`` from its
    ``act_fn()``."""
    def act_factory():
        policy = policy_cls(*args)
        return policy, policy.act_fn()

    return act_factory


class ContinuousReplayAlgorithm(ReplayAlgorithm):
    """SAC's and TD3's actor-mode half: a ``_learner_cls`` on the learner's
    device, the workers' ``_worker_policy_cls`` from the probe's Box
    bounds."""

    _learner_cls: type
    _worker_policy_cls: type

    def _make_learner(self, probe):
        adim, low, high = continuous_space(probe, type(self).__name__)
        return self._learner_cls(self.config, probe.obs_dim, adim, low, high,
                                 self.device,
                                 torch.Generator().manual_seed(
                                     self.config.seed))

    def _act_factory(self, probe) -> Callable:
        adim, low, high = continuous_space(probe, type(self).__name__)
        return policy_act_factory(
            self._worker_policy_cls, probe.obs_dim, adim,
            tuple(self.config.hiddens),
            np.asarray(low, np.float32).tolist(),
            np.asarray(high, np.float32).tolist())


class _SampledPolicy(SquashedGaussianPolicy):
    """The workers' SAC policy: a sample of the squashed Gaussian (the
    exploration argument is unused)."""

    def act_fn(self):
        return lambda obs, generator, _unused: self.sample(obs, generator)[0]


class SAC(ContinuousReplayAlgorithm):
    _default_config_cls = SACConfig
    _make_anakin = make_anakin_sac
    _batch_key = "sac_batch_size"
    _learner_cls = SACLearner
    _worker_policy_cls = _SampledPolicy
