"""Attention-memory (GTrXL-style) PPO in Anakin mode (counterpart of
``ray_tpu/rllib/algorithms/ppo_attn.py``; reference: the
``use_attention`` model path, Parisotto et al.'s gated transformer-XL).

The policy attends over a sliding window of the last ``K`` observations,
carried on the device through the rollout and cleared at episode
boundaries.  Each step's forward depends only on its own window, so
training is feedforward: minibatches are arbitrary slices of the
``T * N`` windows, as in feedforward PPO.  The blocks are GTrXL's:
pre-LayerNorm attention and MLP, each closed by a GRU-type gate biased
toward the identity.  The attention is small (``K`` = 8 positions) and
runs as plain tensor math.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch.models.flax_layers import dense
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
from ray_tpu_torch.rllib.algorithms.ppo_rnn import trunk_embedding
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

# flax's LayerNorm epsilon (torch's default is 1e-5).
LN_EPS = 1e-6


class GRUGate(nn.Module):
    """GTrXL's GRU-type residual gate: ``x`` the residual stream, ``y`` the
    candidate.  The update gate's bias (2.0) starts the block near the
    identity."""

    def __init__(self, d: int, bias: float = 2.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.bias = bias
        for name in ("wr", "ur", "wz", "uz", "wh", "uh"):
            self.add_module(name, dense(d, d, generator, bias=False))

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        r = torch.sigmoid(self.wr(y) + self.ur(x))
        z = torch.sigmoid(self.wz(y) + self.uz(x) - self.bias)
        h = torch.tanh(self.wh(y) + self.uh(r * x))
        return (1 - z) * x + z * h


class MultiHeadAttention(nn.Module):
    """flax's ``MultiHeadDotProductAttention`` (self-attention, qkv
    features = ``d``): ``query``/``key``/``value`` project to ``heads`` x
    ``d / heads``; the query is scaled by ``1 / sqrt(head_dim)``; masked
    scores take the dtype's most negative value (not -inf, so a row with
    no valid column is uniform, not NaN); ``out`` projects back to ``d``.
    The flax kernels ``[d, heads, head_dim]`` and ``[heads, head_dim, d]``
    are these Linears' weights, flattened and transposed."""

    def __init__(self, d: int, heads: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.heads = heads
        for name in ("query", "key", "value", "out"):
            self.add_module(name, dense(d, d, generator))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """x ``[B, K, d]``, mask ``[B, 1, K, K]`` bool (True: attend)."""
        b, k, d = x.shape
        hd = d // self.heads

        def split(y):
            return y.view(b, k, self.heads, hd)

        q = split(self.query(x)) / math.sqrt(hd)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, split(self.key(x)))
        scores = scores.masked_fill(~mask, torch.finfo(scores.dtype).min)
        weights = torch.softmax(scores, -1)
        out = torch.einsum("bhqk,bkhd->bqhd", weights, split(self.value(x)))
        return self.out(out.reshape(b, k, d))


class GTrXLBlock(nn.Module):
    def __init__(self, d: int, heads: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.LayerNorm_0 = nn.LayerNorm(d, eps=LN_EPS)
        self.mha = MultiHeadAttention(d, heads, generator)
        self.gate_attn = GRUGate(d, generator=generator)
        self.LayerNorm_1 = nn.LayerNorm(d, eps=LN_EPS)
        self.mlp_in = dense(d, 4 * d, generator)
        self.mlp_out = dense(4 * d, d, generator)
        self.gate_mlp = GRUGate(d, generator=generator)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = self.gate_attn(x, self.mha(self.LayerNorm_0(x), mask))
        # flax's nn.gelu is the tanh approximation.
        h = self.mlp_out(F.gelu(self.mlp_in(self.LayerNorm_1(x)),
                                approximate="tanh"))
        return self.gate_mlp(x, h)


class AttentionActorCritic(nn.Module):
    """A window of ``K`` observations -> separate policy and value GTrXL
    trunks -> heads.  Flat observations are embedded by a Dense
    (``embed_pi``), frames by the CNN trunk (``cnn_pi``) slot by slot;
    learned positions (``pos_pi``, ``normal(0.02)``) are added before the
    blocks (``block_pi_0``, ...).  Names follow the flax params."""

    def __init__(self, num_actions: int, window: int,
                 obs_dim: Optional[int] = None, d_model: int = 64,
                 heads: int = 4, layers: int = 1,
                 obs_shape: Optional[Tuple[int, ...]] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.window, self.d_model, self.layers = window, d_model, layers
        self.obs_shape = obs_shape
        self.embed_name = "embed" if obs_shape is None else "cnn"
        for tag in ("pi", "vf"):
            embed = (dense(obs_dim, d_model, generator) if obs_shape is None
                     else trunk_embedding(obs_shape, None, (), d_model,
                                          generator))
            self.add_module(f"{self.embed_name}_{tag}", embed)
            pos = torch.empty(window, d_model)
            nn.init.normal_(pos, 0.0, 0.02, generator=generator)
            self.register_parameter(f"pos_{tag}", nn.Parameter(pos))
            for i in range(layers):
                self.add_module(f"block_{tag}_{i}",
                                GTrXLBlock(d_model, heads, generator))
        self.pi = dense(d_model, num_actions, generator)
        self.vf = dense(d_model, 1, generator)

    def forward(self, obs_win: torch.Tensor, valid: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """obs_win ``[B, K, obs_dim]`` or ``[B, K, H, W, C]``; valid
        ``[B, K]`` bool (False: an empty slot before the episode's start).
        Returns (logits ``[B, A]``, value ``[B]``)."""
        b, k = valid.shape
        causal = torch.ones((k, k), dtype=torch.bool,
                            device=valid.device).tril()
        # A row attends to valid columns at or before it; slot K-1, the
        # current observation, is always valid.
        mask = causal[None, None] & valid[:, None, None, :]
        outs = []
        for tag in ("pi", "vf"):
            embed = getattr(self, f"{self.embed_name}_{tag}")
            if self.obs_shape is None:
                x = embed(obs_win.to(torch.float32))
            else:
                x = embed(obs_win.reshape((b * k,) + tuple(self.obs_shape))
                          ).view(b, k, self.d_model)
            x = x + getattr(self, f"pos_{tag}")
            for i in range(self.layers):
                x = getattr(self, f"block_{tag}_{i}")(x, mask)
            outs.append(x[:, -1])
        return self.pi(outs[0]), self.vf(outs[1])[..., 0]


def push(hist: torch.Tensor, valid: torch.Tensor, obs: torch.Tensor,
         prev_done: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Clears the windows of the envs that were just reset, then appends
    the current obs as slot K-1."""
    keep = ~prev_done
    hist = hist * keep.view((-1,) + (1,) * (hist.dim() - 1))
    valid = valid & keep[:, None]
    hist = torch.cat([hist[:, 1:], obs[:, None].to(hist.dtype)], 1)
    valid = torch.cat([valid[:, 1:], torch.ones_like(valid[:, :1])], 1)
    return hist, valid


def _empty_window(n: int, window: int, env, device):
    obs_dims = tuple(getattr(env, "obs_shape", None) or (env.obs_dim,))
    return (torch.zeros((n, window) + obs_dims, device=device),
            torch.zeros((n, window), dtype=torch.bool, device=device))


def make_attn_eval_rollout(env, module: AttentionActorCritic, window: int,
                           num_eval_envs: int = 16):
    """The greedy rollout of ``bc.make_greedy_eval_rollout`` with the
    observation window threaded through it."""

    def policy(win, obs, prev_done):
        win = push(*win, obs, prev_done)
        logits, _ = module(*win)
        return win, logits.argmax(-1)

    return greedy_eval_rollout(
        env, policy,
        lambda n, device: _empty_window(n, window, env, device),
        num_eval_envs)


@dataclasses.dataclass
class AttnAnakinState(AnakinState):
    hist: torch.Tensor = None       # [N, K, ...] window, newest last
    valid: torch.Tensor = None      # [N, K] bool
    prev_done: torch.Tensor = None  # [N]: clear the window before the NEXT step


def make_anakin_ppo_attn(config: AlgorithmConfig, device: torch.device):
    """``make_anakin_ppo`` for the attention policy: returns ``(state,
    step(state, on_phase=None) -> (state, metrics), env steps an
    iteration)``."""
    env = make_env(config)
    if env.num_actions is None:
        raise ValueError(
            "use_attention supports discrete action spaces only; "
            f"continuous env {config.env!r} belongs to the SAC family")
    obs_shape = getattr(env, "obs_shape", None)
    K = config.attention_window
    N, T = config.num_envs, config.unroll_length
    batch_total = N * T
    mb_size = min(config.sgd_minibatch_size, batch_total)
    num_mb = batch_total // mb_size
    module = AttentionActorCritic(
        env.num_actions, K, getattr(env, "obs_dim", None),
        config.attention_dim, config.attention_num_heads,
        config.attention_num_layers,
        tuple(obs_shape) if obs_shape is not None else None,
        generator=torch.Generator().manual_seed(config.seed))
    hist, valid = _empty_window(N, K, env, device)
    state, update_fn = init_anakin(
        config, device, env, module, config.grad_clip,
        state_cls=AttnAnakinState, hist=hist, valid=valid,
        prev_done=torch.zeros(N, dtype=torch.bool, device=device))
    module = state.module
    params = list(module.parameters())
    traj = trajectory_buffers(T, state.obs)
    del traj["obs"]  # the windows hold the observations
    traj["hist"] = torch.empty((T,) + tuple(hist.shape), device=device)
    traj["valid"] = torch.empty((T, N, K), dtype=torch.bool, device=device)
    # The training batch in static buffers (``MinibatchGraphs``).
    adv_buf = torch.empty((T, N), device=device)
    vtarg_buf = torch.empty((T, N), device=device)
    flat = {"hist": traj["hist"].flatten(0, 1),
            "valid": traj["valid"].flatten(0, 1),
            "actions": traj["actions"].view(batch_total),
            "action_logp": traj["action_logp"].view(batch_total),
            "advantages": adv_buf.view(batch_total),
            "value_targets": vtarg_buf.view(batch_total)}
    graphs = anakin_graphs(state, mb_size)
    surrogate = functools.partial(
        ppo_surrogate, clip_param=config.clip_param,
        vf_clip_param=config.vf_clip_param,
        vf_loss_coeff=config.vf_loss_coeff,
        entropy_coeff=config.entropy_coeff)

    def attn_ppo_loss(mb):
        logits, value = module(mb["hist"], mb["valid"])
        logp, entropy = logp_and_entropy(logits, mb["actions"])
        return surrogate(logp, value, entropy, mb)

    @torch.no_grad()
    def rollout(state: AttnAnakinState) -> AttnAnakinState:
        gen = state.generator
        env_states, obs, hist, valid = (state.env_states, state.obs,
                                        state.hist, state.valid)
        prev_done, ep_ret = state.prev_done, state.ep_return
        dsum, dcnt = state.done_return_sum, state.done_count
        for t in range(T):
            hist, valid = push(hist, valid, obs, prev_done)
            logits, value = module(hist, valid)
            action, logp = sample_categorical(logits, gen)
            env_states, obs, reward, prev_done, _ = vector_step(
                env, env_states, action, gen)
            ep_ret, dsum, dcnt = count_episodes(ep_ret, dsum, dcnt, reward,
                                                prev_done)
            for key, x in (("hist", hist), ("valid", valid),
                           ("actions", action), ("action_logp", logp),
                           ("values", value), ("rewards", reward),
                           ("dones", prev_done)):
                traj[key][t] = x
        return dataclasses.replace(
            state, env_states=env_states, obs=obs, hist=hist, valid=valid,
            prev_done=prev_done, ep_return=ep_ret, done_return_sum=dsum,
            done_count=dcnt)

    def train_step(state: AttnAnakinState,
                   on_phase: Optional[Callable[[str], None]] = None
                   ) -> Tuple[AttnAnakinState, Dict[str, torch.Tensor]]:
        mark = on_phase or (lambda name: None)
        mark("start")
        state = rollout(state)
        mark("rollout")
        with torch.no_grad():
            _, last_value = module(*push(state.hist, state.valid, state.obs,
                                         state.prev_done))
            adv, vtarg = gae_torch(traj["rewards"], traj["values"],
                                   traj["dones"], last_value, config.gamma,
                                   config.lambda_)
            adv_buf.copy_(mesh_util.normalize_global(adv))
            vtarg_buf.copy_(vtarg)
        mark("gae")
        losses, auxes = run_ppo_sgd(
            params, update_fn, attn_ppo_loss,
            lambda idx: {k: v[idx] for k, v in flat.items()},
            batch_total, mb_size, num_mb, config.num_sgd_iter,
            lambda n: torch.randperm(n, generator=state.generator,
                                     device=device), graphs)
        mark("sgd")
        return state, sgd_metrics(state, losses, auxes)

    train_step.graphs = graphs
    return state, train_step, batch_total
