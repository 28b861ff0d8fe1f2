"""Contextual bandits: LinUCB and Linear Thompson Sampling (counterpart of
``ray_tpu/rllib/algorithms/bandit.py``; reference:
rllib/algorithms/bandit/ — BanditLinUCB / BanditLinTS over
DiscreteOnlineLinearRegression, bandit_torch_model.py, one interaction a
training_step).

As in the JAX package, an iteration is ``rounds_per_iter`` interactions
on the device: the per-arm ``(A_inv, b)`` statistics, the Sherman–Morrison
inverse update and the exploration rule never leave it, and only the
iteration's metrics reach the host.  The iteration's draws (contexts
``[R, d]``, reward noise ``[R, K]`` and, for LinTS, ``eps`` ``[R, K, d]``)
come from a generator on the device (seeded with ``config.seed``) into
static tensors first; the rounds then run eagerly on the CPU and replay
one CUDA graph on the card.  ``run_rounds`` takes the draws as arguments,
so a caller can hand in its own (the tests pass JAX's).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.utils.cuda_graphs import CapturedCalls


class LinearBanditEnv:
    """Stationary linear contextual bandit: context x ~ N(0, I_d),
    E[reward | arm] = w_arm . x with N(0, noise) observation noise.  The
    arms' weights are drawn from a CPU generator seeded with ``seed``
    (``weights`` may be given instead, as the tests give JAX's)."""

    def __init__(self, num_arms: int = 5, context_dim: int = 8,
                 noise: float = 0.1, seed: int = 0,
                 weights: Optional[torch.Tensor] = None):
        self.num_arms, self.context_dim, self.noise = (num_arms,
                                                       context_dim, noise)
        if weights is None:
            weights = torch.randn(
                (num_arms, context_dim),
                generator=torch.Generator().manual_seed(seed)) / \
                math.sqrt(context_dim)
        self.weights = weights.to(torch.float32)

    def sample_draws(self, rounds: int, generator: torch.Generator, device):
        """``rounds`` contexts ``[R, d]`` and standard normal reward noise
        ``[R, K]``."""
        x = torch.randn((rounds, self.context_dim), generator=generator,
                        device=device)
        z = torch.randn((rounds, self.num_arms), generator=generator,
                        device=device)
        return x, z

    def outcome(self, weights: torch.Tensor, x: torch.Tensor,
                z: torch.Tensor):
        """(rewards, means) ``[K]`` of one context and its noise."""
        means = weights @ x
        return means + z * self.noise, means


BANDIT_ENVS = {"LinearBandit-v0": LinearBanditEnv}


class BanditConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(algo_class=BanditLinUCB)
        self.env = "LinearBandit-v0"
        self.rounds_per_iter = 256
        self.ucb_alpha = 1.0
        self.lin_ts_sigma = 0.3
        self.ridge_lambda = 1.0


@dataclasses.dataclass
class BanditState:
    """The JAX ``BanditState`` held in place on the device (``rounds`` is
    a host count: it advances by ``rounds_per_iter``)."""
    A_inv: torch.Tensor          # [K, d, d] inverse design matrices
    b: torch.Tensor              # [K, d]
    total_reward: torch.Tensor   # 0-d
    total_regret: torch.Tensor   # 0-d
    rounds: int = 0


def choose(state: BanditState, x: torch.Tensor, explore: str, alpha: float,
           ts_sigma: float, eps: Optional[torch.Tensor] = None
           ) -> torch.Tensor:
    """The arm (a 0-d int64 tensor) for context ``x`` ``[d]``: the UCB
    rule, or a Thompson draw ``theta + sigma * chol(A_inv + 1e-6 I) eps``
    with ``eps`` ``[K, d]``."""
    theta = torch.einsum("kij,kj->ki", state.A_inv, state.b)  # [K, d]
    if explore == "ucb":
        mean = theta @ x
        var = torch.einsum("i,kij,j->k", x, state.A_inv, x)
        return torch.argmax(mean + alpha * torch.sqrt(var))
    d = x.shape[0]
    # cholesky_ex: no error check, so no sync with the host.
    chol, _ = torch.linalg.cholesky_ex(
        state.A_inv + 1e-6 * torch.eye(d, device=x.device)[None])
    theta_s = theta + ts_sigma * torch.einsum("kij,kj->ki", chol, eps)
    return torch.argmax(theta_s @ x)


def run_rounds(state: BanditState, weights: torch.Tensor, env, xs, zs,
               epss, explore: str, alpha: float, ts_sigma: float
               ) -> Dict[str, torch.Tensor]:
    """The rounds of one iteration, in place on ``state``: for each
    context ``xs[r]`` (its reward noise ``zs[r]``, its Thompson draw
    ``epss[r]`` or None), choose an arm, observe its reward, and update
    that arm's ``(A_inv, b)`` with the Sherman–Morrison rank-1 rule.
    Returns the rewards and regrets of the rounds ``[R]`` and the
    iteration's metrics."""
    R = xs.shape[0]
    rs, regs = [], []
    for r in range(R):
        x = xs[r]
        rewards, means = env.outcome(weights, x, zs[r])
        arm = choose(state, x, explore, alpha, ts_sigma,
                     None if epss is None else epss[r])
        # index_select, not [arm]: indexing by a tensor on the card may
        # read it on the host, which a CUDA graph cannot.
        at = arm.view(1)
        reward = rewards.index_select(0, at)[0]
        regret = means.max() - means.index_select(0, at)[0]
        Ai = state.A_inv.index_select(0, at)[0]
        Aix = Ai @ x
        Ai_new = Ai - torch.outer(Aix, Aix) / (1.0 + x @ Aix)
        state.A_inv.index_copy_(0, at, Ai_new[None])
        state.b.index_add_(0, at, (reward * x)[None])
        rs.append(reward)
        regs.append(regret)
    rs, regs = torch.stack(rs), torch.stack(regs)
    state.total_reward.add_(rs.sum())
    state.total_regret.add_(regs.sum())
    return {"rewards": rs, "regrets": regs,
            "episode_reward_mean": rs.mean(), "regret_this_iter": regs.sum(),
            "cumulative_regret": state.total_regret.clone()}


class BanditLinUCB(Algorithm):
    _default_config_cls = BanditConfig
    _data_mesh_capable = False
    _explore = "ucb"

    def _setup_anakin(self):
        config = self.config
        env = (BANDIT_ENVS[config.env]() if isinstance(config.env, str)
               else config.env)
        self._env = env
        K, d = env.num_arms, env.context_dim
        device = self.device
        self._weights = env.weights.to(device)
        lam = config.ridge_lambda
        self._anakin_state = BanditState(
            A_inv=(torch.eye(d, device=device)[None] / lam).repeat(K, 1, 1),
            b=torch.zeros((K, d), device=device),
            total_reward=torch.zeros((), device=device),
            total_regret=torch.zeros((), device=device))
        R = config.rounds_per_iter
        self._generator = torch.Generator(device=device).manual_seed(
            config.seed)
        self._xs = torch.zeros((R, d), device=device)
        self._zs = torch.zeros((R, K), device=device)
        self._epss = (torch.zeros((R, K, d), device=device)
                      if self._explore == "ts" else None)
        self._calls = CapturedCalls(device)
        self._steps_per_iter = R

    def rounds(self, xs, zs, epss=None) -> Dict[str, torch.Tensor]:
        """One iteration's rounds on the given draws."""
        c = self.config
        return run_rounds(self._anakin_state, self._weights, self._env, xs,
                          zs, epss, self._explore, c.ucb_alpha,
                          c.lin_ts_sigma)

    def _training_step_anakin(self) -> Dict[str, Any]:
        x, z = self._env.sample_draws(self._xs.shape[0], self._generator,
                                      self.device)
        self._xs.copy_(x)
        self._zs.copy_(z)
        if self._epss is not None:
            torch.randn(self._epss.shape, generator=self._generator,
                        device=self.device, out=self._epss)
        out = self._calls.run(
            lambda: self.rounds(self._xs, self._zs, self._epss))
        names = ("episode_reward_mean", "regret_this_iter",
                 "cumulative_regret")
        values = torch.stack([out[k] for k in names]).tolist()
        self._anakin_state.rounds += self._steps_per_iter
        metrics = dict(zip(names, values))
        metrics["rounds"] = self._anakin_state.rounds
        metrics["num_env_steps_sampled_this_iter"] = self._steps_per_iter
        return metrics

    def evaluate(self, num_steps: int = 1000) -> Dict[str, float]:
        raise NotImplementedError(
            f"{type(self).__name__} has no generic evaluator (a bandit "
            "has no episodes)")

    def save_checkpoint(self):
        from ray_tpu_torch.air.checkpoint import Checkpoint

        st = self._anakin_state
        return Checkpoint.from_state_dict(
            {"A_inv": st.A_inv, "b": st.b}, extra={"iteration":
                                                   self.iteration})

    def load_checkpoint(self, checkpoint):
        saved = checkpoint.to_state_dict()
        st = self._anakin_state
        st.A_inv.copy_(saved["A_inv"])
        st.b.copy_(saved["b"])
        self.iteration = checkpoint.extra().get("iteration", 0)


class BanditLinTSConfig(BanditConfig):
    def __init__(self):
        super().__init__()
        self.algo_class = BanditLinTS


class BanditLinTS(BanditLinUCB):
    _default_config_cls = BanditLinTSConfig
    _explore = "ts"


class BanditLinUCBConfig(BanditConfig):
    pass
