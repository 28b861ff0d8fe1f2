"""IMPALA in Anakin mode: PPO's rollout, then one V-trace-corrected update
of the whole trajectory (counterpart of
``ray_tpu/rllib/algorithms/impala.py``; reference:
rllib/algorithms/impala/impala.py:534).

With the envs on the device the asynchronous actor/learner split
dissolves: a train step samples ``T`` steps of ``N`` envs with the current
policy (``ppo.anakin_rollout``), takes the target policy's log-probability
and value of all ``T * N`` frames in one forward, corrects them with
V-trace and applies one clip + Adam update.  An iteration reads the host
once, for its metrics.

Actor mode (``rollouts(num_rollout_workers=...)``): CPU rollout workers
stream time-major fragments through a ``SampleStream`` (fragments in
flight, versioned weights, the staleness gate) to a ``TorchLearner`` on
the device, which takes one V-trace update a fragment and publishes its
weights every ``broadcast_interval`` updates.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm, make_env
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.ppo import (
    AnakinState,
    anakin_rollout,
    init_anakin,
    trajectory_buffers,
)
from ray_tpu_torch.rllib.core.rl_module import RLModuleSpec
from ray_tpu_torch.rllib.utils.vtrace import vtrace

Metrics = Dict[str, torch.Tensor]


class IMPALAConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(algo_class=IMPALA)
        self.num_sgd_iter = 1
        self.entropy_coeff = 0.01
        self.lr = 5e-4


def time_major_forward(module, batch):
    """(log-probability of the actions, value, entropy) of the target
    policy on a time-major batch: ``obs`` ``[T, N, ...]`` goes through the
    module as ``T * N`` frames; each output comes back ``[T, N]``."""
    T, N = batch["actions"].shape
    logp, value, entropy = module.forward_train(
        batch["obs"].reshape((T * N,) + tuple(batch["obs"].shape[2:])),
        batch["actions"].reshape(T * N))
    return logp.view(T, N), value.view(T, N), entropy.view(T, N)


def vtrace_targets(logp, value, batch, *, gamma, clip_rho, clip_c):
    """(vs, pg_advantages) of V-trace for the target policy's ``logp`` and
    ``value``, ``[T, N]``, without gradient."""
    return vtrace(batch["behaviour_logp"], logp, batch["rewards"], value,
                  batch["dones"], batch["last_value"], gamma, clip_rho,
                  clip_c)


def impala_objective(logp, value, entropy, vs, pg_adv, batch, *,
                     vf_loss_coeff, entropy_coeff):
    """IMPALA's loss from the forward's outputs and the V-trace targets:
    the importance-weighted policy gradient, the value error to ``vs``,
    the entropy bonus."""
    policy_loss = -(logp * pg_adv).mean()
    vf_loss = 0.5 * ((value - vs) ** 2).mean()
    ent = entropy.mean()
    total = policy_loss + vf_loss_coeff * vf_loss - entropy_coeff * ent
    return total, {"policy_loss": policy_loss, "vf_loss": vf_loss,
                   "entropy": ent}


def impala_loss(module, batch, *, gamma, clip_rho, clip_c, vf_loss_coeff,
                entropy_coeff):
    """The JAX ``impala_loss``: batch tensors are time-major ``[T, N, ...]``
    (``obs``, ``actions``, ``behaviour_logp``, ``rewards``, ``dones``) and
    ``last_value`` ``[N]``."""
    logp, value, entropy = time_major_forward(module, batch)
    vs, pg_adv = vtrace_targets(logp, value, batch, gamma=gamma,
                                clip_rho=clip_rho, clip_c=clip_c)
    return impala_objective(logp, value, entropy, vs, pg_adv, batch,
                            vf_loss_coeff=vf_loss_coeff,
                            entropy_coeff=entropy_coeff)


def time_major_loss(objective: Callable, *, gamma, clip_rho, clip_c
                    ) -> Callable:
    """``loss(module, batch)`` on one time-major batch (``impala_loss``'s):
    the target policy's forward, V-trace, then ``objective`` (IMPALA's or
    APPO's).  The actor-mode learner's loss."""
    def loss(module, batch):
        logp, value, entropy = time_major_forward(module, batch)
        vs, pg_adv = vtrace_targets(logp, value, batch, gamma=gamma,
                                    clip_rho=clip_rho, clip_c=clip_c)
        return objective(logp, value, entropy, vs, pg_adv, batch)

    return loss


def make_anakin_impala(config: AlgorithmConfig, device: torch.device,
                       objective: Callable):
    """Builds the initial ``AnakinState`` and the train step ``step(state,
    on_phase=None) -> (state, metrics)``; ``objective(logp, value,
    entropy, vs, pg_adv, batch) -> (loss, aux)`` is IMPALA's or APPO's.
    Returns ``(state, step, env steps an iteration)``.

    The update is one step over the whole ``T * N`` batch, as the JAX step
    takes it: a full-batch forward (activations of every frame held for
    the backward), V-trace, the loss, its gradient, clip and Adam."""
    env = make_env(config)
    spec = RLModuleSpec.for_env(env, tuple(config.hiddens))
    state, update_fn = init_anakin(
        config, device, env,
        spec.build(torch.Generator().manual_seed(config.seed)),
        config.grad_clip or 1e9)
    module = state.module
    params = list(module.parameters())
    N, T = config.num_envs, config.unroll_length
    traj = trajectory_buffers(T, state.obs)
    targets = functools.partial(vtrace_targets, gamma=config.gamma,
                                clip_rho=config.vtrace_clip_rho,
                                clip_c=config.vtrace_clip_c)

    def train_step(state: AnakinState,
                   on_phase: Optional[Callable[[str], None]] = None
                   ) -> Tuple[AnakinState, Metrics]:
        mark = on_phase or (lambda name: None)
        mark("start")
        state = anakin_rollout(env, state, traj)
        mark("rollout")
        with torch.no_grad():
            _, last_value = module(state.obs)
        batch = {"obs": traj["obs"], "actions": traj["actions"],
                 "behaviour_logp": traj["action_logp"],
                 "rewards": traj["rewards"], "dones": traj["dones"],
                 "last_value": last_value}
        logp, value, entropy = time_major_forward(module, batch)
        mark("forward")
        vs, pg_adv = targets(logp, value, batch)
        mark("vtrace")
        loss, aux = objective(logp, value, entropy, vs, pg_adv, batch)
        update_fn(torch.autograd.grad(loss, params))
        mark("update")
        metrics = {"total_loss": loss.detach(),
                   **{k: v.detach() for k, v in aux.items()},
                   "episode_return_sum": state.done_return_sum,
                   "episode_count": state.done_count}
        return state, metrics

    return state, train_step, N * T


class IMPALA(Algorithm):
    _default_config_cls = IMPALAConfig

    def _make_loss(self) -> Callable:
        """The objective after V-trace; APPO swaps in its clipped
        surrogate here and keeps the rest of IMPALA's step."""
        c = self.config
        return functools.partial(impala_objective,
                                 vf_loss_coeff=c.vf_loss_coeff,
                                 entropy_coeff=c.entropy_coeff)

    def _setup_anakin(self):
        self._anakin_state, self._train_step, self._steps_per_iter = \
            make_anakin_impala(self.config, self.device, self._make_loss())
        self.module = self._anakin_state.module

    # ---- actor mode ----
    def _setup_actor_mode(self):
        c = self.config
        self._setup_learner_and_workers(time_major_loss(
            self._make_loss(), gamma=c.gamma, clip_rho=c.vtrace_clip_rho,
            clip_c=c.vtrace_clip_c))
        # V-trace's behaviour/target correction absorbs staleness, so the
        # gate here is a safety bound, not a correctness requirement.
        self._start_stream("timemajor")
        self._updates_since_broadcast = 0

    def _training_step_actor(self) -> Dict[str, Any]:
        from ray_tpu_torch.rllib.core.learner import metrics_to_host

        mark = self.on_phase or (lambda name: None)
        mark("start")
        metrics: Dict[str, Any] = {}
        ep_returns = []
        target_updates = max(1, len(self.workers.workers))
        updates = steps = 0
        while updates < target_updates:
            frag = self._stream.next_fragment(timeout=120.0)
            if frag is None:
                break
            ep_returns.extend(frag.episode_returns)
            metrics = self.learner.update(frag.batch)
            updates += 1
            steps += frag.env_steps
            self._updates_since_broadcast += 1
            if self._updates_since_broadcast >= \
                    self.config.broadcast_interval:
                self._stream.publish_weights(self.learner.get_weights())
                self._updates_since_broadcast = 0
        metrics = metrics_to_host(metrics)
        mark("update")
        metrics["episode_reward_mean"] = self._episode_reward_mean(
            ep_returns)
        metrics["num_env_steps_sampled_this_iter"] = steps
        metrics.update(self._stream_metrics())
        return metrics
