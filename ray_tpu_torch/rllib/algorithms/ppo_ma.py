"""Multi-agent PPO with parameter sharing, Anakin-style (counterpart of
``ray_tpu/rllib/algorithms/ppo_ma.py``; reference: RLlib's multi-agent
training with a shared policy — policy_mapping_fn returning one policy
id for every agent, rllib/algorithms/algorithm_config.py multi_agent()).

The agent axis is folded into the batch: the rollout steps G games of M
agents on the device, the shared policy evaluates all G*M agent
observations in one forward, GAE runs per agent stream with the game's
done broadcast to each of its M streams, and PPO's clipped-surrogate
minibatch SGD (``ppo.run_ppo_sgd`` over ``ppo.ppo_loss``) consumes the
flattened ``[T*G*M]`` batch.  As Anakin PPO (``ppo.py``), the port runs
the rollout eagerly and, on CUDA, replays each minibatch update from a
CUDA graph.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Tuple

import torch

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.ppo import (
    AnakinState,
    anakin_graphs,
    init_anakin,
    ppo_loss,
    run_ppo_sgd,
    sgd_metrics,
)
from ray_tpu_torch.rllib.core.rl_module import RLModuleSpec
from ray_tpu_torch.rllib.env.multi_agent import ma_vector_step, make_ma_env
from ray_tpu_torch.rllib.env.torch_envs import count_episodes
from ray_tpu_torch.rllib.evaluation.postprocessing import gae_torch
from ray_tpu_torch.rllib.utils import mesh as mesh_util

Metrics = Dict[str, torch.Tensor]


class MAPPOConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(algo_class=MAPPO)
        self.num_envs = 32  # games


@torch.no_grad()
def ma_rollout(env, state: AnakinState, traj: Dict[str, torch.Tensor]
               ) -> AnakinState:
    """``len(traj["actions"])`` steps of the shared policy in the games:
    each step's flattened ``[G*M]`` obs, actions, log-probabilities,
    values and per-agent rewards, and each game's done repeated for its
    M agents, written into ``traj``; an episode's return is its team
    reward summed over the agents."""
    module, gen = state.module, state.generator
    env_states, obs, ep_ret = state.env_states, state.obs, state.ep_return
    dsum, dcnt = state.done_return_sum, state.done_count
    G, M = obs.shape[0], obs.shape[1]
    for t in range(traj["actions"].shape[0]):
        flat_obs = obs.reshape(G * M, -1)
        action, logp, value = module.forward_exploration(flat_obs, gen)
        env_states, next_obs, rewards, done, _ = ma_vector_step(
            env, env_states, action.view(G, M), gen)
        ep_ret, dsum, dcnt = count_episodes(ep_ret, dsum, dcnt,
                                            rewards.sum(-1), done)
        # game done -> every agent stream
        for key, x in (("obs", flat_obs), ("actions", action),
                       ("action_logp", logp), ("values", value),
                       ("rewards", rewards.reshape(G * M)),
                       ("dones", done.repeat_interleave(M))):
            traj[key][t] = x
        obs = next_obs
    return AnakinState(module, state.optimizer, env_states, obs, gen,
                       ep_ret, dsum, dcnt)


@torch.no_grad()
def folded_batch(module, traj: Dict[str, torch.Tensor], last_obs, gamma: float,
                 lambda_: float) -> Dict[str, torch.Tensor]:
    """The ``[T * G * M]`` training batch of a ``[T, G * M]`` trajectory:
    GAE per agent stream (bootstrapped from the value of ``last_obs``
    ``[G, M, d]``), the advantages normalised over the whole batch."""
    T, flat_n = traj["actions"].shape
    _, last_value = module(last_obs.reshape(flat_n, -1))
    adv, vtarg = gae_torch(traj["rewards"], traj["values"], traj["dones"],
                           last_value, gamma, lambda_)
    adv = mesh_util.normalize_global(adv)
    n = T * flat_n
    return {"obs": traj["obs"].reshape(n, -1),
            "actions": traj["actions"].reshape(n),
            "action_logp": traj["action_logp"].reshape(n),
            "advantages": adv.reshape(n),
            "value_targets": vtarg.reshape(n)}


def make_anakin_mappo(config: MAPPOConfig, device):
    """Builds the initial state (the shared module from ``config.seed``
    through a CPU generator; the games reset from a generator on
    ``device``) and the train step.  Returns ``(state, step(state,
    on_phase=None) -> (state, metrics), env steps an iteration)``: T * G
    env steps — the agent axis does not inflate the count.  ``on_phase``
    gets "start", "rollout", "gae" and "sgd", as PPO's."""
    env = make_ma_env(config.env) if isinstance(config.env, str) \
        else config.env
    G, M, T = config.num_envs, env.num_agents, config.unroll_length
    spec = RLModuleSpec(obs_dim=env.obs_dim, num_actions=env.num_actions,
                        hiddens=tuple(config.hiddens))
    state, update_fn = init_anakin(
        config, device, env, spec.build(torch.Generator().manual_seed(
            config.seed)), config.grad_clip)
    module = state.module
    params = list(module.parameters())
    flat_n = G * M
    batch_total = T * flat_n
    mb_size = min(config.sgd_minibatch_size, batch_total)
    num_mb = batch_total // mb_size
    traj = {
        "obs": torch.empty((T, flat_n, env.obs_dim), device=device),
        "actions": torch.empty((T, flat_n), dtype=torch.int64,
                               device=device),
        "action_logp": torch.empty((T, flat_n), device=device),
        "values": torch.empty((T, flat_n), device=device),
        "rewards": torch.empty((T, flat_n), device=device),
        "dones": torch.empty((T, flat_n), dtype=torch.bool, device=device),
    }
    # The folded batch in static buffers (``MinibatchGraphs``).
    flat = {"obs": torch.empty((batch_total, env.obs_dim), device=device),
            "actions": torch.empty(batch_total, dtype=torch.int64,
                                   device=device),
            **{k: torch.empty(batch_total, device=device)
               for k in ("action_logp", "advantages", "value_targets")}}
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
        state = ma_rollout(env, state, traj)
        mark("rollout")
        with torch.no_grad():
            for k, v in folded_batch(module, traj, state.obs, config.gamma,
                                     config.lambda_).items():
                flat[k].copy_(v)
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
    return state, train_step, T * G


class MAPPO(Algorithm):
    _default_config_cls = MAPPOConfig
    _data_mesh_capable = False

    def _setup_anakin(self):
        self._anakin_state, self._train_step, self._steps_per_iter = \
            make_anakin_mappo(self.config, self.device)
        self.module = self._anakin_state.module

    def _setup_actor_mode(self):
        raise NotImplementedError(
            "MAPPO ships anakin-mode (shared policy); independent-policy "
            "multi-agent training uses MultiAgentBatch on the actor stack")

    def evaluate(self, num_steps: int = 1000) -> Dict[str, float]:
        raise NotImplementedError(
            "MAPPO has no generic evaluator (the single-agent greedy "
            "rollout does not step a multi-agent env)")
