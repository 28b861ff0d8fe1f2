"""TD3 / DDPG: deterministic-policy continuous control (counterpart of
``ray_tpu/rllib/algorithms/td3.py``).

Reference: rllib/algorithms/ddpg/ (ddpg.py config surface: twin_q,
policy_delay, smooth_target_policy, target_noise/clip, tau,
ou/gaussian exploration) and rllib/algorithms/td3/td3.py (TD3 = DDPG
with twin_q=True, policy_delay=2, smooth_target_policy=True defaults —
the same relationship holds here).  Loss structure per
ddpg_torch_policy.py: critic regresses the polyak target network's
Bellman backup, actor ascends Q1 of its own action.

Anakin mode runs env stepping, the replay ring and the updates on the
device (``dqn.make_anakin_offpolicy``); actor mode takes the replay
family's CPU workers and replay plane (``dqn.ReplayAlgorithm``).

What differs from the JAX package: the delayed policy update is a host
branch on the update count (the JAX step computes the policy's update
every step and masks it), so its ``actor_loss`` is the mean over the
updates that applied one; the target smoothing noise is a tensor the
critic loss takes (drawn from a ``torch.Generator`` on the device).
"""
from __future__ import annotations

import copy
from typing import Any, Dict, Optional

import torch
from torch import nn

from ray_tpu_torch.models.mlp import MLP
from ray_tpu_torch.rllib.algorithms.algorithm import make_env
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.dqn import (
    Metrics,
    ReplayLearner,
    make_anakin_offpolicy,
    polyak_,
)
from ray_tpu_torch.rllib.algorithms.sac import (
    ContinuousReplayAlgorithm,
    TwinQ,
    _bound,
    continuous_space,
)


class TD3Config(AlgorithmConfig):
    def __init__(self):
        super().__init__(algo_class=TD3)
        self.lr = 1e-3
        self.buffer_size = 100_000
        self.learning_starts = 1_000
        self.tau = 0.005
        self.twin_q = True
        self.policy_delay = 2
        self.smooth_target_policy = True
        self.target_noise = 0.2
        self.target_noise_clip = 0.5
        self.exploration_noise = 0.1
        self.num_updates_per_iter = 8
        self.td3_batch_size = 256


class DDPGConfig(TD3Config):
    """Reference relationship inverted but equivalent: DDPG is TD3 minus
    the three TD3 tricks (rllib/algorithms/td3/td3.py defaults)."""

    def __init__(self):
        super().__init__()
        self.algo_class = DDPG
        self.twin_q = False
        self.policy_delay = 1
        self.smooth_target_policy = False


class DeterministicPolicy(nn.Module):
    """MLP → tanh-squashed action scaled to the bounds."""

    def __init__(self, obs_dim: int, action_dim: int, hiddens, low, high,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.net = MLP(obs_dim, tuple(hiddens), action_dim,
                       generator=generator)
        low, high = _bound(low, action_dim), _bound(high, action_dim)
        self.register_buffer("low", low, persistent=False)
        self.register_buffer("high", high, persistent=False)
        self.register_buffer("scale", (high - low) / 2.0, persistent=False)
        self.register_buffer("center", (high + low) / 2.0, persistent=False)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.net(obs)) * self.scale + self.center

    # Algorithm.compute_single_action protocol
    mode = forward

    def explore(self, obs: torch.Tensor, generator: torch.Generator,
                noise_scale: float) -> torch.Tensor:
        """The action plus Gaussian noise of ``noise_scale`` of the half
        range, clipped to the bounds."""
        action = self(obs)
        noise = noise_scale * self.scale * torch.randn(
            action.shape, generator=generator, device=action.device)
        return torch.clamp(action + noise, self.low, self.high)

    def act_fn(self):
        return self.explore


def make_td3_losses(pi: DeterministicPolicy, pi_target: DeterministicPolicy,
                    q: TwinQ, q_target: TwinQ, config):
    """TD3's two losses over an explicit minibatch — shared by the anakin
    and actor paths so the Bellman-target math exists once.  ``noise``
    (standard normal, the action's shape) smooths the target policy."""
    scale, low, high = pi.scale, pi.low, pi.high

    def q_loss(batch, noise):
        with torch.no_grad():
            next_a = pi_target(batch["next_obs"])
            if config.smooth_target_policy:
                # Target policy smoothing (TD3 trick #3): clipped noise on
                # the target action regularizes the critic against sharp
                # Q peaks.
                eps = torch.clamp(config.target_noise * scale * noise,
                                  -config.target_noise_clip * scale,
                                  config.target_noise_clip * scale)
                next_a = torch.clamp(next_a + eps, low, high)
            tq1, tq2 = q_target(batch["next_obs"], next_a)
            target_v = torch.minimum(tq1, tq2) if config.twin_q else tq1
            target = batch["rewards"] + config.gamma * (
                1 - batch["dones"]) * target_v
        q1, q2 = q(batch["obs"], batch["actions"])
        loss = ((q1 - target) ** 2).mean()
        if config.twin_q:
            loss = loss + ((q2 - target) ** 2).mean()
        return loss

    def pi_loss(batch):
        q1, _ = q(batch["obs"], pi(batch["obs"]))
        return -q1.mean()

    return q_loss, pi_loss


class TD3Learner(ReplayLearner):
    """The policy and its target, the twin Q and its target, and an update
    plan for each (``clip_by_global_norm(grad_clip)`` then ``adam(lr)``)
    on ``device``.  An update: the critic's step; then, every
    ``policy_delay``-th update (TD3 trick #2: ``step_kind`` True), the
    policy's step against the new critic and the policy target's polyak
    sync; the critic target's sync every update.  Its noise is one
    standard normal of the action's shape (the target smoothing)."""

    def __init__(self, config, obs_dim: int, action_dim: int, low, high,
                 device, generator: Optional[torch.Generator] = None):
        super().__init__(config, device)
        self.action_dim = action_dim
        self.module = self.pi = DeterministicPolicy(
            obs_dim, action_dim, config.hiddens, low, high,
            generator).to(device)
        self.q = TwinQ(obs_dim, action_dim, config.hiddens,
                       generator).to(device)
        self.pi_target = copy.deepcopy(self.pi).requires_grad_(False)
        self.q_target = copy.deepcopy(self.q).requires_grad_(False)
        self.update_count = 0
        self.policy_updates = 0
        self._pi_params = list(self.pi.parameters())
        self._q_params = list(self.q.parameters())
        self._pi_update, self.pi_opt = self._plan(self._pi_params)
        self._q_update, self.q_opt = self._plan(self._q_params)
        self.q_loss, self.pi_loss = make_td3_losses(
            self.pi, self.pi_target, self.q, self.q_target, config)

    def noise_shapes(self, batch_size: int):
        return [(batch_size, self.action_dim)]

    def step_kind(self) -> bool:
        return self.update_count % self.config.policy_delay == 0

    def after_update(self, kind: bool) -> None:
        self.update_count += 1
        self.policy_updates += int(kind)

    def device_update(self, batch, noise, kind: bool) -> Metrics:
        c = self.config
        ql = self.q_loss(batch, noise[0])
        # Without twin_q the second head takes no part in the loss, and
        # its gradient is zero (as jax.grad gives it).
        grads = torch.autograd.grad(ql, self._q_params, allow_unused=True)
        self._q_update([torch.zeros_like(p) if g is None else g
                        for p, g in zip(self._q_params, grads)])
        out = {"critic_loss": ql.detach()}
        if kind:
            pl = self.pi_loss(batch)
            self._pi_update(torch.autograd.grad(pl, self._pi_params))
            polyak_(list(self.pi_target.parameters()), self._pi_params,
                    c.tau)
            out["actor_loss"] = pl.detach()
        polyak_(list(self.q_target.parameters()), self._q_params, c.tau)
        return out

    def get_weights(self) -> Dict[str, torch.Tensor]:
        """The policy's state dict, copied to the CPU."""
        return {k: v.detach().to("cpu", copy=True)
                for k, v in self.pi.state_dict().items()}

    def checkpoint_state(self) -> Dict[str, Any]:
        """Full training state: params + BOTH optimizer moment states +
        update_count (the policy-delay phase).  Replay contents stay
        excluded by design — a resumed run restarts collection, which is
        documented resume behavior (fresh transitions under the restored
        policy), not silent state loss."""
        return {"pi": self.pi.state_dict(),
                "pi_target": self.pi_target.state_dict(),
                "q": self.q.state_dict(),
                "q_target": self.q_target.state_dict(),
                "pi_opt": self.pi_opt.state_dict(),
                "q_opt": self.q_opt.state_dict(),
                "update_count": self.update_count}

    def load_checkpoint_state(self, state: Dict[str, Any]) -> None:
        for name in ("pi", "pi_target", "q", "q_target"):
            getattr(self, name).load_state_dict(state[name])
        self._load_optimizer(self.pi_opt, state["pi_opt"])
        self._load_optimizer(self.q_opt, state["q_opt"])
        self.update_count = int(state["update_count"])


def make_anakin_td3(config: TD3Config, device):
    """Builds the initial state (the networks from ``config.seed`` through
    a CPU generator) and the train step on ``device``: the policy's action
    plus ``exploration_noise`` as actions, TD3's (or DDPG's) updates on
    uniform draws of ``td3_batch_size``.  Returns ``(state, step, env
    steps an iteration)``."""
    env = make_env(config)
    adim, low, high = continuous_space(env, "TD3")
    learner = TD3Learner(config, env.obs_dim, adim, low, high, device,
                         torch.Generator().manual_seed(config.seed))
    pi = learner.pi
    return make_anakin_offpolicy(
        config, device, env, learner,
        lambda obs, gen, tick: pi.explore(obs, gen,
                                          config.exploration_noise),
        config.td3_batch_size, action_shape=(adim,),
        action_dtype=torch.float32,
        loss_names=("critic_loss", "actor_loss"))


class TD3(ContinuousReplayAlgorithm):
    _default_config_cls = TD3Config
    _make_anakin = make_anakin_td3
    _batch_key = "td3_batch_size"
    _learner_cls = TD3Learner
    _worker_policy_cls = DeterministicPolicy

    def _explore_arg(self) -> float:
        return self.config.exploration_noise


class DDPG(TD3):
    _default_config_cls = DDPGConfig
