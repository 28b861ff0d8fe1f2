"""PPO in Anakin mode (counterpart of ``ray_tpu/rllib/algorithms/ppo.py``;
reference: rllib/algorithms/ppo/ppo.py:350, sample -> SGD -> sync).

Anakin (Podracer, PAPERS.md): the envs are a batched state on the device,
and one train step runs the rollout of T steps, GAE, advantage
normalisation and the minibatch SGD epochs there; the ``[T, N]``
trajectory never leaves the device, and an iteration reads the host once,
for its metrics.  The JAX package jits the whole step into one program;
the port runs it eagerly, one launch per operation.

Not ported yet (ROADMAP, Queue 1 item 4): actor mode, the recurrent and
attention policies (``use_lstm``, ``use_attention``), ``evaluate`` and
checkpoints; more than one device (Queue 1 item 5).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.core.rl_module import (
    DiscreteActorCritic,
    RLModuleSpec,
)
from ray_tpu_torch.rllib.env.torch_envs import (
    make_torch_env,
    vector_reset,
    vector_step,
)
from ray_tpu_torch.rllib.evaluation.postprocessing import gae_torch
from ray_tpu_torch.rllib.utils import mesh as mesh_util

Metrics = Dict[str, torch.Tensor]


class PPOConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(algo_class=PPO)


def ppo_surrogate(logp, value, entropy, batch, *, clip_param, vf_clip_param,
                  vf_loss_coeff, entropy_coeff):
    """The clipped-surrogate objective from computed forward outputs."""
    ratio = torch.exp(logp - batch["action_logp"])
    adv = batch["advantages"]
    surr = torch.minimum(
        ratio * adv,
        torch.clamp(ratio, 1 - clip_param, 1 + clip_param) * adv)
    vf_err = torch.clamp((value - batch["value_targets"]) ** 2,
                         0.0, vf_clip_param ** 2)
    policy_loss = -surr.mean()
    vf_loss = 0.5 * vf_err.mean()
    ent = entropy.mean()
    total = policy_loss + vf_loss_coeff * vf_loss - entropy_coeff * ent
    return total, {"policy_loss": policy_loss, "vf_loss": vf_loss,
                   "entropy": ent}


def ppo_loss(module: DiscreteActorCritic, batch, *, clip_param,
             vf_clip_param, vf_loss_coeff, entropy_coeff):
    logp, value, entropy = module.forward_train(batch["obs"],
                                                batch["actions"])
    return ppo_surrogate(logp, value, entropy, batch,
                         clip_param=clip_param,
                         vf_clip_param=vf_clip_param,
                         vf_loss_coeff=vf_loss_coeff,
                         entropy_coeff=entropy_coeff)


def run_ppo_sgd(params: Sequence[torch.nn.Parameter],
                update_fn: Callable[[Sequence[torch.Tensor]], None],
                loss_fn: Callable[[Dict[str, torch.Tensor]], Tuple[Any, Any]],
                make_mb: Callable[[torch.Tensor], Dict[str, torch.Tensor]],
                total: int, mb_size: int, num_mb: int, num_sgd_iter: int,
                permute: Callable[[int], torch.Tensor]
                ) -> Tuple[torch.Tensor, Metrics]:
    """The permute -> minibatch -> update loop: each epoch takes a fresh
    ``permute(total)``, drops its remainder (``perm[: num_mb * mb_size]``)
    and, for each minibatch of indices, takes the gradient of
    ``loss_fn(make_mb(idx)) -> (loss, aux)`` with respect to ``params``
    and hands it to ``update_fn``.  Returns each epoch's mean loss
    ``[num_sgd_iter]`` and mean aux metrics, on the device."""
    losses, auxes = [], []
    for _ in range(num_sgd_iter):
        perm = permute(total)
        idxs = perm[: num_mb * mb_size].view(num_mb, mb_size)
        epoch = []
        for idx in idxs:
            loss, aux = loss_fn(make_mb(idx))
            grads = torch.autograd.grad(loss, params)
            update_fn(grads)
            epoch.append(torch.stack([loss.detach()]
                                     + [v.detach() for v in aux.values()]))
        means = torch.stack(epoch).mean(0)
        losses.append(means[0])
        auxes.append(dict(zip(aux, means[1:])))
    return torch.stack(losses), {k: torch.stack([a[k] for a in auxes])
                                 for k in auxes[0]}


@dataclasses.dataclass
class AnakinState:
    """What the JAX ``AnakinState`` carries, held in place: the module
    holds ``params``, the optimizer ``opt_state``, and ``generator`` (on
    the device) stands for ``rng``."""
    module: DiscreteActorCritic
    optimizer: torch.optim.Optimizer
    env_states: Dict[str, torch.Tensor]
    obs: torch.Tensor
    generator: torch.Generator
    ep_return: torch.Tensor        # per-env running return
    done_return_sum: torch.Tensor  # cumulative, 0-d
    done_count: torch.Tensor       # cumulative, 0-d


def make_anakin_ppo(config: AlgorithmConfig, device: torch.device):
    """Builds the initial ``AnakinState`` (from ``config.seed``) and the
    train step ``step(state, on_phase=None) -> (state, metrics)`` on
    ``device``.  Returns ``(state, step, env steps an iteration)``.

    The parameters start from ``config.seed`` through a CPU generator, so
    they are the same on every device; env resets, action draws and
    permutations come from a generator on ``device``.  ``on_phase(name)``,
    when given, is called after the step has enqueued its "rollout", its
    "gae" (last value, GAE, normalisation) and its "sgd", and with
    "start" before them: a caller can record a CUDA event at each."""
    env = make_torch_env(config.env) if isinstance(config.env, str) \
        else config.env
    obs_shape = getattr(env, "obs_shape", None)
    spec = RLModuleSpec.for_env(env, tuple(config.hiddens))

    N, T = config.num_envs, config.unroll_length
    batch_total = N * T
    mb_size = min(config.sgd_minibatch_size, batch_total)
    num_mb = batch_total // mb_size
    mesh_util.setup_data_mesh(config, N)

    module = spec.build(torch.Generator().manual_seed(config.seed)).to(device)
    params = list(module.parameters())
    update_fn, optimizer = mesh_util.build_update_plan(
        config, config.lr, config.grad_clip, params)
    generator = torch.Generator(device=device).manual_seed(config.seed)
    env_states, obs = vector_reset(env, generator, N, device)
    zero = torch.zeros((), device=device)
    state = AnakinState(module, optimizer, env_states, obs, generator,
                        torch.zeros(N, device=device), zero, zero.clone())

    # The trajectory, written in place each iteration.
    traj = {
        "obs": torch.empty((T,) + tuple(obs.shape), dtype=obs.dtype,
                           device=device),
        "actions": torch.empty((T, N), dtype=torch.int64, device=device),
        "action_logp": torch.empty((T, N), device=device),
        "values": torch.empty((T, N), device=device),
        "rewards": torch.empty((T, N), device=device),
        "dones": torch.empty((T, N), dtype=torch.bool, device=device),
    }
    loss_fn = functools.partial(
        ppo_loss, module, clip_param=config.clip_param,
        vf_clip_param=config.vf_clip_param,
        vf_loss_coeff=config.vf_loss_coeff,
        entropy_coeff=config.entropy_coeff)

    def train_step(state: AnakinState,
                   on_phase: Optional[Callable[[str], None]] = None
                   ) -> Tuple[AnakinState, Metrics]:
        mark = on_phase or (lambda name: None)
        mark("start")
        env_states, obs = state.env_states, state.obs
        ep_ret = state.ep_return
        dsum = torch.zeros((), device=device)
        dcnt = torch.zeros((), device=device)
        with torch.no_grad():
            for t in range(T):
                action, logp, value = module.forward_exploration(
                    obs, state.generator)
                env_states, next_obs, reward, done, _ = vector_step(
                    env, env_states, action, state.generator)
                ep_ret = ep_ret + reward
                dsum = dsum + torch.where(done, ep_ret, 0.0).sum()
                dcnt = dcnt + done.sum()
                ep_ret = torch.where(done, 0.0, ep_ret)
                for key, x in (("obs", obs), ("actions", action),
                               ("action_logp", logp), ("values", value),
                               ("rewards", reward), ("dones", done)):
                    traj[key][t] = x
                obs = next_obs
            mark("rollout")
            _, last_value = module(obs)
            adv, vtarg = gae_torch(traj["rewards"], traj["values"],
                                   traj["dones"], last_value,
                                   config.gamma, config.lambda_)
            adv = mesh_util.normalize_global(adv)
        flat = {
            "obs": (traj["obs"].view(batch_total, *obs_shape)
                    if obs_shape is not None
                    else traj["obs"].view(batch_total, -1)),
            "actions": traj["actions"].view(batch_total),
            "action_logp": traj["action_logp"].view(batch_total),
            "advantages": adv.view(batch_total),
            "value_targets": vtarg.view(batch_total),
        }
        mark("gae")
        losses, auxes = run_ppo_sgd(
            params, update_fn, loss_fn,
            lambda idx: {k: v[idx] for k, v in flat.items()},
            batch_total, mb_size, num_mb, config.num_sgd_iter,
            lambda n: torch.randperm(n, generator=state.generator,
                                     device=device))
        mark("sgd")
        state = dataclasses.replace(
            state, env_states=env_states, obs=obs, ep_return=ep_ret,
            done_return_sum=state.done_return_sum + dsum,
            done_count=state.done_count + dcnt)
        metrics = {
            "total_loss": losses.mean(),
            "policy_loss": auxes["policy_loss"].mean(),
            "vf_loss": auxes["vf_loss"].mean(),
            "entropy": auxes["entropy"].mean(),
            "episode_return_sum": state.done_return_sum,
            "episode_count": state.done_count,
        }
        return state, metrics

    return state, train_step, batch_total


class PPO(Algorithm):
    _default_config_cls = PPOConfig

    # Called by each train step with "start", "rollout", "gae" and "sgd"
    # (see make_anakin_ppo); None outside measurements.
    on_phase: Optional[Callable[[str], None]] = None

    def _setup_anakin(self):
        if self.config.use_lstm or self.config.use_attention:
            raise NotImplementedError(
                "use_lstm/use_attention PPO is not ported yet: the port "
                "runs the feedforward Anakin path (ROADMAP, Queue 1 item 4:"
                " ppo_rnn and ppo_attn)")
        self._anakin_state, self._train_step, self._steps_per_iter = \
            make_anakin_ppo(self.config, self.device)
        self.module = self._anakin_state.module

    def _training_step_anakin(self) -> Dict[str, Any]:
        self._anakin_state, metrics = self._train_step(self._anakin_state,
                                                       self.on_phase)
        # ONE device-to-host read for every metric: the iteration's only
        # sync with the device.
        names = list(metrics)
        values = torch.stack([metrics[k].float() for k in names]).tolist()
        metrics = self._episode_counter_metrics(dict(zip(names, values)))
        metrics["num_env_steps_sampled_this_iter"] = self._steps_per_iter
        return metrics
