"""Recurrent (LSTM) PPO in Anakin mode (counterpart of
``ray_tpu/rllib/algorithms/ppo_rnn.py``; reference: the ``use_lstm`` /
``lstm_cell_size`` model path with PPO's sequence handling).

The rollout carries each env's LSTM state on the device and zeroes it at
episode boundaries; training replays the same recurrence from the
unroll's first carry, so the hidden states are exact, with no padding and
no sequence lengths: every sequence is ``T`` long.  Minibatches cut
across the env axis, so sequences stay whole.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from ray_tpu_torch.models.flax_layers import dense, lecun_normal_
from ray_tpu_torch.models.mlp import MLP
from ray_tpu_torch.models.nature_cnn import MinAtarCNN, NatureCNN
from ray_tpu_torch.rllib.algorithms.algorithm import make_env
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.bc import greedy_eval_rollout
from ray_tpu_torch.rllib.algorithms.ppo import (
    AnakinState,
    init_anakin,
    ppo_surrogate,
    anakin_graphs,
    run_ppo_sgd,
    sgd_metrics,
    trajectory_buffers,
)
from ray_tpu_torch.rllib.core.rl_module import (
    logp_and_entropy,
    sample_categorical,
)
from ray_tpu_torch.rllib.env.torch_envs import (
    count_episodes,
    vector_step,
)
from ray_tpu_torch.rllib.evaluation.postprocessing import gae_torch
from ray_tpu_torch.rllib.utils import mesh as mesh_util

# ((c, h) of the policy trunk, (c, h) of the value trunk), each [N, size]:
# flax's carry order, (c, h), not torch's (h, c).
Carry = Tuple[Tuple[torch.Tensor, torch.Tensor],
              Tuple[torch.Tensor, torch.Tensor]]


def lstm_cell(in_features: int, size: int,
              generator: Optional[torch.Generator] = None) -> nn.LSTMCell:
    """An ``nn.LSTMCell`` initialised as flax's ``OptimizedLSTMCell``: its
    input kernels ``ii if ig io`` (no bias) from ``lecun_normal``, its
    recurrent kernels ``hi hf hg ho`` orthogonal with zero bias, and no +1
    on the forget gate.  torch packs the gates in the same order, i, f,
    g, o; flax's one bias is ``bias_hh``, and ``bias_ih`` stays 0."""
    cell = nn.utils.skip_init(nn.LSTMCell, in_features, size)
    with torch.no_grad():
        for gate in range(4):
            rows = slice(gate * size, (gate + 1) * size)
            lecun_normal_(cell.weight_ih[rows], in_features, generator)
            nn.init.orthogonal_(cell.weight_hh[rows], generator=generator)
        cell.bias_ih.zero_()
        cell.bias_hh.zero_()
    return cell


def trunk_embedding(obs_shape, obs_dim, hiddens, out_dim, generator):
    """The per-trunk embedding of the memory modules: an MLP for flat
    observations, a CNN (``MinAtarCNN`` on boards under 32 px, else the
    Nature CNN) for frames."""
    if obs_shape is None:
        return MLP(obs_dim, hiddens, out_dim, generator=generator)
    small = min(obs_shape[0], obs_shape[1]) < 32
    return (MinAtarCNN(obs_shape, out_dim, generator=generator) if small
            else NatureCNN(obs_shape, out_dim, generator=generator))


class RecurrentActorCritic(nn.Module):
    """Per-trunk embedding -> LSTM -> head, with separate policy and value
    trunks (as the feedforward module keeps them separate).  ``forward``
    is one step; ``sequence`` replays ``T`` steps from a carry, embedding
    all ``T`` inputs in one call and running only the recurrence step by
    step: the same function.  Modules are named as the flax params are
    (``embed_pi`` or ``cnn_pi``, ``lstm_pi``, ...), so converted weights
    load by name."""

    def __init__(self, num_actions: int, obs_dim: Optional[int] = None,
                 hiddens: Sequence[int] = (64,), lstm_size: int = 128,
                 obs_shape: Optional[Tuple[int, ...]] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.lstm_size = lstm_size
        self.embed_name = "embed" if obs_shape is None else "cnn"
        for tag in ("pi", "vf"):
            self.add_module(f"{self.embed_name}_{tag}", trunk_embedding(
                obs_shape, obs_dim, tuple(hiddens), lstm_size, generator))
            self.add_module(f"lstm_{tag}",
                            lstm_cell(lstm_size, lstm_size, generator))
        self.pi = dense(lstm_size, num_actions, generator)
        self.vf = dense(lstm_size, 1, generator)

    def _trunk(self, tag):
        return (getattr(self, f"{self.embed_name}_{tag}"),
                getattr(self, f"lstm_{tag}"))

    def forward(self, carry: Carry, obs: torch.Tensor, reset: torch.Tensor
                ) -> Tuple[Carry, torch.Tensor, torch.Tensor]:
        """One step: zero both carries where ``reset`` ``[N]``, then
        advance.  Returns (carry, logits, value)."""
        mask = (1.0 - reset.to(torch.float32))[:, None]
        out, ys = [], []
        for tag, (c, h) in zip(("pi", "vf"), carry):
            embed, cell = self._trunk(tag)
            h, c = cell(embed(obs), (h * mask, c * mask))
            out.append((c, h))
            ys.append(h)
        return tuple(out), self.pi(ys[0]), self.vf(ys[1])[..., 0]

    def sequence(self, carry0: Carry, obs_t: torch.Tensor,
                 reset_t: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``forward`` over ``T`` steps from ``carry0``: ``obs_t``
        ``[T, n, ...]``, ``reset_t`` ``[T, n]``.  Returns (logits
        ``[T, n, A]``, value ``[T, n]``)."""
        T, n = reset_t.shape
        mask_t = (1.0 - reset_t.to(torch.float32))[..., None]
        frames = obs_t.reshape((T * n,) + tuple(obs_t.shape[2:]))
        hs = []
        for tag, (c, h) in zip(("pi", "vf"), carry0):
            embed, cell = self._trunk(tag)
            x = embed(frames).view(T, n, -1)
            out = []
            for t in range(T):
                h, c = cell(x[t], (h * mask_t[t], c * mask_t[t]))
                out.append(h)
            hs.append(torch.stack(out))
        return self.pi(hs[0]), self.vf(hs[1])[..., 0]


def zero_carry(n: int, lstm_size: int, device=None) -> Carry:
    one = (torch.zeros((n, lstm_size), device=device),
           torch.zeros((n, lstm_size), device=device))
    return (one, tuple(x.clone() for x in one))


def make_rnn_eval_rollout(env, module: RecurrentActorCritic, lstm_size: int,
                          num_eval_envs: int = 16):
    """The greedy rollout of ``bc.make_greedy_eval_rollout`` with the LSTM
    carry threaded through it."""

    def policy(carry, obs, prev_done):
        carry, logits, _ = module(carry, obs, prev_done)
        return carry, logits.argmax(-1)

    return greedy_eval_rollout(
        env, policy, lambda n, device: zero_carry(n, lstm_size, device),
        num_eval_envs)


@dataclasses.dataclass
class RNNAnakinState(AnakinState):
    carry: Carry = None
    prev_done: torch.Tensor = None  # [N]: the reset mask of the NEXT step


def make_anakin_ppo_rnn(config: AlgorithmConfig, device: torch.device):
    """``make_anakin_ppo`` for the LSTM policy: returns ``(state,
    step(state, on_phase=None) -> (state, metrics), env steps an
    iteration)``.  Refuses pixel envs, continuous actions and minibatch
    shapes that would drop whole sequences, as the JAX package's
    ``make_anakin_ppo_rnn`` does."""
    env = make_env(config)
    if getattr(env, "obs_shape", None) is not None:
        raise ValueError(
            "use_lstm supports flat-observation envs only (a CNN+LSTM "
            "trunk is not wired yet); got pixel env "
            f"{config.env!r} with obs_shape={env.obs_shape}")
    if env.num_actions is None:
        raise ValueError(
            "use_lstm supports discrete action spaces only; continuous "
            f"env {config.env!r} belongs to the SAC family")
    N, T = config.num_envs, config.unroll_length
    envs_per_mb = max(1, min(N, config.sgd_minibatch_size // max(T, 1)))
    num_mb = N // envs_per_mb
    if N % envs_per_mb:
        raise ValueError(
            f"num_envs={N} is not divisible by the per-minibatch env count "
            f"{envs_per_mb} (sgd_minibatch_size={config.sgd_minibatch_size}"
            f" / unroll_length={T}): {N - num_mb * envs_per_mb} whole env "
            "sequences would be silently dropped from every SGD epoch — "
            "pick num_envs divisible by envs-per-minibatch")
    size = config.lstm_cell_size
    module = RecurrentActorCritic(
        env.num_actions, env.obs_dim, tuple(config.hiddens), size,
        generator=torch.Generator().manual_seed(config.seed))
    state, update_fn = init_anakin(
        config, device, env, module, config.grad_clip,
        state_cls=RNNAnakinState, carry=zero_carry(N, size, device),
        prev_done=torch.zeros(N, dtype=torch.bool, device=device))
    module = state.module
    params = list(module.parameters())
    traj = trajectory_buffers(T, state.obs)
    traj["resets"] = torch.empty((T, N), dtype=torch.bool, device=device)
    # What the minibatches read, in static buffers (``MinibatchGraphs``):
    # the carry at the unroll's first step, the advantages, the targets.
    carry0 = zero_carry(N, size, device)
    adv_buf = torch.empty((T, N), device=device)
    vtarg_buf = torch.empty((T, N), device=device)
    graphs = anakin_graphs(state, envs_per_mb)
    surrogate = functools.partial(
        ppo_surrogate, clip_param=config.clip_param,
        vf_clip_param=config.vf_clip_param,
        vf_loss_coeff=config.vf_loss_coeff,
        entropy_coeff=config.entropy_coeff)

    def seq_ppo_loss(mb):
        logits, value = module.sequence(mb["carry0"], mb["obs"],
                                        mb["resets"])
        logp, entropy = logp_and_entropy(logits, mb["actions"])
        return surrogate(logp, value, entropy, mb)

    @torch.no_grad()
    def rollout(state: RNNAnakinState) -> RNNAnakinState:
        gen = state.generator
        env_states, obs, carry = state.env_states, state.obs, state.carry
        prev_done, ep_ret = state.prev_done, state.ep_return
        dsum, dcnt = state.done_return_sum, state.done_count
        for t in range(T):
            carry, logits, value = module(carry, obs, prev_done)
            action, logp = sample_categorical(logits, gen)
            env_states, next_obs, reward, done, _ = vector_step(
                env, env_states, action, gen)
            ep_ret, dsum, dcnt = count_episodes(ep_ret, dsum, dcnt, reward,
                                                done)
            for key, x in (("obs", obs), ("resets", prev_done),
                           ("actions", action), ("action_logp", logp),
                           ("values", value), ("rewards", reward),
                           ("dones", done)):
                traj[key][t] = x
            obs, prev_done = next_obs, done
        return dataclasses.replace(
            state, env_states=env_states, obs=obs, carry=carry,
            prev_done=prev_done, ep_return=ep_ret, done_return_sum=dsum,
            done_count=dcnt)

    def train_step(state: RNNAnakinState,
                   on_phase: Optional[Callable[[str], None]] = None
                   ) -> Tuple[RNNAnakinState, Dict[str, torch.Tensor]]:
        mark = on_phase or (lambda name: None)
        mark("start")
        with torch.no_grad():  # the hidden state at the unroll's first step
            for buf, x in zip((b for sub in carry0 for b in sub),
                              (x for sub in state.carry for x in sub)):
                buf.copy_(x)
        state = rollout(state)
        mark("rollout")
        with torch.no_grad():
            _, _, last_value = module(state.carry, state.obs,
                                      state.prev_done)
            adv, vtarg = gae_torch(traj["rewards"], traj["values"],
                                   traj["dones"], last_value, config.gamma,
                                   config.lambda_)
            adv_buf.copy_(mesh_util.normalize_global(adv))
            vtarg_buf.copy_(vtarg)
        mark("gae")

        def make_mb(env_idx):
            # Minibatches cut across the env axis: whole sequences.
            return {"carry0": tuple(tuple(x[env_idx] for x in sub)
                                    for sub in carry0),
                    "obs": traj["obs"][:, env_idx],
                    "resets": traj["resets"][:, env_idx],
                    "actions": traj["actions"][:, env_idx],
                    "action_logp": traj["action_logp"][:, env_idx],
                    "advantages": adv_buf[:, env_idx],
                    "value_targets": vtarg_buf[:, env_idx]}

        losses, auxes = run_ppo_sgd(
            params, update_fn, seq_ppo_loss, make_mb, N, envs_per_mb,
            num_mb, config.num_sgd_iter,
            lambda n: torch.randperm(n, generator=state.generator,
                                     device=device), graphs)
        mark("sgd")
        return state, sgd_metrics(state, losses, auxes)

    train_step.graphs = graphs
    return state, train_step, N * T
