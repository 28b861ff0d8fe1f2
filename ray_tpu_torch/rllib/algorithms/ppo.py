"""PPO in Anakin mode (counterpart of ``ray_tpu/rllib/algorithms/ppo.py``;
reference: rllib/algorithms/ppo/ppo.py:350, sample -> SGD -> sync).

Anakin (Podracer, PAPERS.md): the envs are a batched state on the device,
and one train step runs the rollout of T steps, GAE, advantage
normalisation and the minibatch SGD epochs there; the ``[T, N]``
trajectory never leaves the device, and an iteration reads the host once,
for its metrics.  The JAX package jits the whole step into one program;
the port runs the rollout eagerly, one launch per operation, and on CUDA
replays each minibatch update from a CUDA graph (``MinibatchGraphs``,
with Adam ``capturable``; the feedforward, recurrent, attention and
multi-agent steps alike).

The recurrent and attention policies (``use_lstm``, ``use_attention``)
are built by ``ppo_rnn.py`` and ``ppo_attn.py``; IMPALA/APPO reuse the
rollout and ``AnakinState`` below.

Actor mode (``rollouts(num_rollout_workers=...)``): CPU rollout workers
sample fragments with GAE columns, and a ``TorchLearner`` on the device
runs the shuffled minibatch epochs, in lockstep (sample, train, blocking
weight sync) or streaming (``SampleStream``: fragments in flight while the
learner trains, weights published asynchronously).  Its minibatch shuffles
draw from a numpy generator seeded with ``config.seed``, so that a
lockstep run repeats itself (the JAX package shuffles unseeded).
``num_devices`` raises (ROADMAP, Queue 1 item 6, what is left): the JAX
package shards one learner process over its local devices, and the port
runs a process per rank (``DistributedLearnerGroup``).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm, make_env
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.core.rl_module import (
    DiscreteActorCritic,
    RLModuleSpec,
)
from ray_tpu_torch.rllib.env.torch_envs import (
    count_episodes,
    vector_reset,
    vector_step,
)
from ray_tpu_torch.rllib.evaluation.postprocessing import gae_torch
from ray_tpu_torch.rllib.utils import mesh as mesh_util
from ray_tpu_torch.rllib.utils.cuda_graphs import (
    CapturedCalls,
    capturable_adam,
)

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


class MinibatchGraphs(CapturedCalls):
    """``run_ppo_sgd``'s minibatch update replayed from a CUDA graph on
    the card (``CapturedCalls``; eager on the CPU): each minibatch's
    indices are copied into the static ``idx`` first.  Everything else
    the update reads must stay in place across iterations, so an Anakin
    step that hands this to ``run_ppo_sgd`` keeps its training batch in
    static buffers and its optimizer ``capturable``."""

    def __init__(self, device, mb_size: int):
        super().__init__(device)
        self.idx = torch.zeros(mb_size, dtype=torch.int64,
                               device=torch.device(device))


def anakin_graphs(state, mb_size: int) -> MinibatchGraphs:
    """The minibatch graphs of an Anakin PPO step, its Adam made
    ``capturable`` on CUDA.  Each step function carries its graphs as
    ``train_step.graphs`` (a caller may set ``use_graphs`` off to time the
    eager updates)."""
    device = next(state.module.parameters()).device
    capturable_adam(state.optimizer, device)
    return MinibatchGraphs(device, mb_size)


def run_ppo_sgd(params: Sequence[torch.nn.Parameter],
                update_fn: Callable[[Sequence[torch.Tensor]], None],
                loss_fn: Callable[[Dict[str, torch.Tensor]], Tuple[Any, Any]],
                make_mb: Callable[[torch.Tensor], Dict[str, torch.Tensor]],
                total: int, mb_size: int, num_mb: int, num_sgd_iter: int,
                permute: Callable[[int], torch.Tensor],
                graphs: Optional[MinibatchGraphs] = None
                ) -> Tuple[torch.Tensor, Metrics]:
    """The permute -> minibatch -> update loop: each epoch takes a fresh
    ``permute(total)``, drops its remainder (``perm[: num_mb * mb_size]``)
    and, for each minibatch of indices, takes the gradient of
    ``loss_fn(make_mb(idx)) -> (loss, aux)`` with respect to ``params``
    and hands it to ``update_fn`` (through ``graphs``, when given: on
    CUDA a replayed graph).  Returns each epoch's mean loss
    ``[num_sgd_iter]`` and mean aux metrics, on the device."""

    def update(idx) -> Metrics:
        loss, aux = loss_fn(make_mb(idx))
        grads = torch.autograd.grad(loss, params)
        update_fn(grads)
        return {"loss": loss.detach(),
                **{k: v.detach() for k, v in aux.items()}}

    losses, auxes = [], []
    for _ in range(num_sgd_iter):
        perm = permute(total)
        idxs = perm[: num_mb * mb_size].view(num_mb, mb_size)
        epoch = []
        for idx in idxs:
            if graphs is None:
                out = update(idx)
            else:
                graphs.idx.copy_(idx)
                out = graphs.run(lambda: update(graphs.idx))
            # A graph's outputs are overwritten by its next replay: the
            # stack copies them first.
            epoch.append(torch.stack(list(out.values())))
        names = list(out)[1:]
        means = torch.stack(epoch).mean(0)
        losses.append(means[0])
        auxes.append(dict(zip(names, means[1:])))
    return torch.stack(losses), {k: torch.stack([a[k] for a in auxes])
                                 for k in auxes[0]}


@dataclasses.dataclass
class AnakinState:
    """What the JAX ``AnakinState`` carries, held in place: the module
    holds ``params``, the optimizer ``opt_state``, and ``generator`` (on
    the device) stands for ``rng``."""
    module: torch.nn.Module
    optimizer: torch.optim.Optimizer
    env_states: Dict[str, torch.Tensor]
    obs: torch.Tensor
    generator: torch.Generator
    ep_return: torch.Tensor        # per-env running return
    done_return_sum: torch.Tensor  # cumulative, 0-d
    done_count: torch.Tensor       # cumulative, 0-d


def init_anakin(config: AlgorithmConfig, device: torch.device, env,
                module: torch.nn.Module, grad_clip: Optional[float],
                state_cls=AnakinState, **extra):
    """The state every Anakin algorithm starts from: ``module`` on
    ``device``, its update plan (``clip_by_global_norm(grad_clip)`` when
    set, then ``adam(config.lr)``), ``config.num_envs`` envs reset from a
    generator on ``device`` seeded with ``config.seed``, and zero episode
    counters.  ``extra`` fills the fields a ``state_cls`` adds.  Returns
    ``(state, update_fn)``."""
    n = config.num_envs
    mesh_util.setup_data_mesh(config, n)
    module = module.to(device)
    update_fn, optimizer = mesh_util.build_update_plan(
        config, config.lr, grad_clip, module.parameters())
    generator = torch.Generator(device=device).manual_seed(config.seed)
    env_states, obs = vector_reset(env, generator, n, device)
    zero = torch.zeros((), device=device)
    state = state_cls(module, optimizer, env_states, obs, generator,
                      torch.zeros(n, device=device), zero, zero.clone(),
                      **extra)
    return state, update_fn


def trajectory_buffers(T: int, obs: torch.Tensor):
    """The ``[T, N]`` trajectory of a rollout (obs, actions, action_logp,
    values, rewards, dones), written in place each iteration."""
    n, device = obs.shape[0], obs.device
    return {
        "obs": torch.empty((T,) + tuple(obs.shape), dtype=obs.dtype,
                           device=device),
        "actions": torch.empty((T, n), dtype=torch.int64, device=device),
        "action_logp": torch.empty((T, n), device=device),
        "values": torch.empty((T, n), device=device),
        "rewards": torch.empty((T, n), device=device),
        "dones": torch.empty((T, n), dtype=torch.bool, device=device),
    }


@torch.no_grad()
def anakin_rollout(env, state: AnakinState, traj: Dict[str, torch.Tensor]
                   ) -> AnakinState:
    """``len(traj["actions"])`` steps of the policy in the envs, each
    step's obs, action, log-probability, value, reward and done written
    into ``traj``; returns the state after them, its episode counters
    advanced."""
    module, gen = state.module, state.generator
    env_states, obs, ep_ret = state.env_states, state.obs, state.ep_return
    dsum, dcnt = state.done_return_sum, state.done_count
    for t in range(traj["actions"].shape[0]):
        action, logp, value = module.forward_exploration(obs, gen)
        env_states, next_obs, reward, done, _ = vector_step(
            env, env_states, action, gen)
        ep_ret, dsum, dcnt = count_episodes(ep_ret, dsum, dcnt, reward,
                                            done)
        for key, x in (("obs", obs), ("actions", action),
                       ("action_logp", logp), ("values", value),
                       ("rewards", reward), ("dones", done)):
            traj[key][t] = x
        obs = next_obs
    return dataclasses.replace(state, env_states=env_states, obs=obs,
                               ep_return=ep_ret, done_return_sum=dsum,
                               done_count=dcnt)


def sgd_metrics(state: AnakinState, losses: torch.Tensor, auxes: Metrics
                ) -> Metrics:
    """An iteration's metrics from ``run_ppo_sgd``'s, on the device."""
    return {"total_loss": losses.mean(),
            **{k: auxes[k].mean() for k in ("policy_loss", "vf_loss",
                                            "entropy")},
            "episode_return_sum": state.done_return_sum,
            "episode_count": state.done_count}


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
    env = make_env(config)
    if env.num_actions is None:
        # The JAX package fails here too, building a Dense of None units.
        raise NotImplementedError(
            f"PPO's policy is categorical: the continuous env "
            f"{config.env!r} is for SAC, TD3 or DDPG")
    spec = RLModuleSpec.for_env(env, tuple(config.hiddens))
    state, update_fn = init_anakin(
        config, device, env, spec.build(torch.Generator().manual_seed(
            config.seed)), config.grad_clip)
    module = state.module
    params = list(module.parameters())
    obs_shape = spec.obs_shape or (spec.obs_dim,)

    N, T = config.num_envs, config.unroll_length
    batch_total = N * T
    mb_size = min(config.sgd_minibatch_size, batch_total)
    num_mb = batch_total // mb_size
    traj = trajectory_buffers(T, state.obs)
    # The training batch in static buffers (``MinibatchGraphs``): the
    # trajectory's views and the advantages and targets copied in.
    adv_buf = torch.empty((T, N), device=device)
    vtarg_buf = torch.empty((T, N), device=device)
    flat = {
        "obs": traj["obs"].view(batch_total, *obs_shape),
        "actions": traj["actions"].view(batch_total),
        "action_logp": traj["action_logp"].view(batch_total),
        "advantages": adv_buf.view(batch_total),
        "value_targets": vtarg_buf.view(batch_total),
    }
    graphs = anakin_graphs(state, mb_size)
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
        state = anakin_rollout(env, state, traj)
        mark("rollout")
        with torch.no_grad():
            _, last_value = module(state.obs)
            adv, vtarg = gae_torch(traj["rewards"], traj["values"],
                                   traj["dones"], last_value,
                                   config.gamma, config.lambda_)
            adv_buf.copy_(mesh_util.normalize_global(adv))
            vtarg_buf.copy_(vtarg)
        mark("gae")
        losses, auxes = run_ppo_sgd(
            params, update_fn, loss_fn,
            lambda idx: {k: v[idx] for k, v in flat.items()},
            batch_total, mb_size, num_mb, config.num_sgd_iter,
            lambda n: torch.randperm(n, generator=state.generator,
                                     device=device), graphs)
        mark("sgd")
        return state, sgd_metrics(state, losses, auxes)

    train_step.graphs = graphs
    return state, train_step, batch_total


class PPO(Algorithm):
    """Feedforward, recurrent (``use_lstm``) or attention-memory
    (``use_attention``) PPO."""

    _default_config_cls = PPOConfig

    def _setup_anakin(self):
        c = self.config
        if c.use_lstm and c.use_attention:
            raise ValueError("use_lstm and use_attention are exclusive")
        if c.use_lstm:
            from ray_tpu_torch.rllib.algorithms.ppo_rnn import \
                make_anakin_ppo_rnn as build
        elif c.use_attention:
            from ray_tpu_torch.rllib.algorithms.ppo_attn import \
                make_anakin_ppo_attn as build
        else:
            build = make_anakin_ppo
        self._anakin_state, self._train_step, self._steps_per_iter = build(
            c, self.device)
        self.module = self._anakin_state.module

    def _make_eval_rollout(self, env):
        """The memory policies thread their carry or window through the
        greedy rollout."""
        c = self.config
        if c.use_lstm:
            from ray_tpu_torch.rllib.algorithms.ppo_rnn import \
                make_rnn_eval_rollout

            return make_rnn_eval_rollout(env, self.module,
                                         c.lstm_cell_size)
        if c.use_attention:
            from ray_tpu_torch.rllib.algorithms.ppo_attn import \
                make_attn_eval_rollout

            return make_attn_eval_rollout(env, self.module,
                                          c.attention_window)
        return super()._make_eval_rollout(env)

    # ---- actor mode ----
    def _setup_actor_mode(self):
        c = self.config
        if c.use_lstm or c.use_attention:
            # Silently training a memoryless MLP on a memory task is the
            # worst failure mode — refuse loudly instead.
            raise NotImplementedError(
                "use_lstm/use_attention policies run in anakin mode only; "
                "the actor-path sampling stack is feedforward")
        self._setup_learner_and_workers(functools.partial(
            ppo_loss, clip_param=c.clip_param,
            vf_clip_param=c.vf_clip_param, vf_loss_coeff=c.vf_loss_coeff,
            entropy_coeff=c.entropy_coeff))
        self._shuffle_rng = np.random.default_rng(c.seed)
        self._stream = None
        if c.sample_streaming:
            self._start_stream("gae")
        else:
            self.workers.sync_weights(self.learner.get_weights())

    def _run_ppo_epochs(self, train_batch) -> Dict[str, Any]:
        """The shared SGD half of both actor paths: advantage
        normalization + shuffled minibatch epochs on the learner; one
        device read for the last minibatch's metrics."""
        from ray_tpu_torch.rllib.core.learner import metrics_to_host

        adv = train_batch["advantages"]
        train_batch["advantages"] = (adv - adv.mean()) / (adv.std() + 1e-8)
        metrics: Dict[str, Any] = {}
        for _ in range(self.config.num_sgd_iter):
            shuffled = train_batch.shuffle(
                int(self._shuffle_rng.integers(2 ** 31)))
            for mb in shuffled.minibatches(
                    min(self.config.sgd_minibatch_size, len(shuffled))):
                metrics = self.learner.update(mb)
        return metrics_to_host(metrics)

    def _training_step_actor(self) -> Dict[str, Any]:
        from ray_tpu_torch.exceptions import RayTpuError
        from ray_tpu_torch.rllib.policy.sample_batch import SampleBatch

        mark = self.on_phase or (lambda name: None)
        mark("start")
        if self._stream is None:
            # Lockstep path (sample_streaming=False): barrier sample ->
            # train -> blocking weight sync.
            batches, ep_returns = self.workers.sample_sync()
            train_batch = SampleBatch.concat_samples(batches)
            mark("sample")
            metrics = self._run_ppo_epochs(train_batch)
            mark("sgd")
            self.workers.sync_weights(self.learner.get_weights())
            mark("publish")
        else:
            # Streaming path: consume one fragment per worker slot as
            # they land — while the SGD epochs below run, every worker
            # still holds queued fragment work, and the new weights
            # broadcast asynchronously.
            target = max(1, self.config.num_rollout_workers)
            batches, ep_returns = [], []
            for _ in range(target):
                frag = self._stream.next_fragment(timeout=120.0)
                if frag is None:
                    break
                batches.append(frag.batch)
                ep_returns.extend(frag.episode_returns)
            if not batches:
                raise RayTpuError(
                    "rollout stream produced no fragments within timeout")
            # Reuse last iteration's concat buffer (the learner consumed
            # it during the previous SGD epochs).
            train_batch = SampleBatch.concat_samples_into(
                batches, getattr(self, "_train_buf", None))
            self._train_buf = train_batch
            mark("sample")
            metrics = self._run_ppo_epochs(train_batch)
            mark("sgd")
            self._stream.publish_weights(self.learner.get_weights())
            mark("publish")
            metrics.update(self._stream_metrics())
        metrics["episode_reward_mean"] = self._episode_reward_mean(
            ep_returns)
        metrics["num_env_steps_sampled_this_iter"] = len(train_batch)
        return metrics
