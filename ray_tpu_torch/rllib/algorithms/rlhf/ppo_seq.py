"""PPO on sequences: the RLHF learner step (counterpart of
``ray_tpu/rllib/algorithms/rlhf/ppo_seq.py``).

The objective is clipped-surrogate PPO applied to LM token sequences:
each *sampled* token is one action, its behavior logprob came from the
serving engine's decode step, and the reward is terminal per sequence (a
scalar from the reward scorer).  With gamma=1 and a terminal reward the
Monte-Carlo return of every response position is the sequence reward, so

- ``value_targets[t] = R`` on response positions,
- ``advantages[t] = R - V_pre(s_t)`` (the pre-update critic), whitened
  over the masked positions,

both computed once per batch, followed by the shared ``run_ppo_sgd``
permute -> minibatch -> epoch loop with the ``clip_by_global_norm`` +
``adam`` update of ``mesh.build_update_plan``.  The JAX package jits the
whole step into one program; the port runs it eagerly.  Each forward of
``GPT2WithValue`` at a padded length of 1024 or more on the card runs
the flash forward in every layer, and each backward the dq and dkv
kernels.

Minibatch permutations come from a numpy generator seeded with ``seed``,
as actor-mode PPO's do.  More than one device, ``zero_sharding`` and
``quantized_collectives`` raise (ROADMAP Queue 1 item 6, what is left):
the JAX learner shards its one process over local devices, which the
port, one process a rank, does not do inside a learner.
"""
from __future__ import annotations

import types
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.rllib.algorithms.ppo import run_ppo_sgd
from ray_tpu_torch.rllib.utils import mesh as mesh_util


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return (x * mask).sum() / mask.sum().clamp_min(1.0)


def sequence_logprobs(logits: torch.Tensor,
                      tokens: torch.Tensor) -> torch.Tensor:
    """``[B, L-1]`` log-softmax of ``tokens[:, 1:]`` under
    ``logits[:, :-1]``: position t's logit row predicts token t+1."""
    lp = F.log_softmax(logits[:, :-1].float(), dim=-1)
    return _gather_tokens(lp, tokens)


def _gather_tokens(lp: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return lp.gather(-1, tokens[:, 1:, None].long())[..., 0]


def sequence_ppo_loss(model, batch: Dict[str, torch.Tensor], *,
                      clip_param: float, vf_coeff: float,
                      entropy_coeff: float):
    """Clipped-surrogate PPO over one minibatch of sequences.

    ``batch``: tokens [B, L], response_mask [B, L] (1.0 on sampled
    tokens), behavior_logp [B, L], advantages [B, L], value_targets
    [B, L].  Mask/logp/adv/targets are indexed by the position of the
    sampled token; the value prediction for token t is the critic at t-1
    (the state before emitting it).  The log-softmax is taken once and
    serves both the sampled tokens' logprobs and the entropy."""
    logits, values = model(batch["tokens"])
    lp_full = F.log_softmax(logits[:, :-1].float(), dim=-1)
    new_logp = _gather_tokens(lp_full, batch["tokens"])  # [B, L-1]
    mask = batch["response_mask"][:, 1:]
    behavior = batch["behavior_logp"][:, 1:]
    adv = batch["advantages"][:, 1:]
    vt = batch["value_targets"][:, 1:]
    v_pred = values[:, :-1]

    ratio = torch.exp(new_logp - behavior)
    surr = torch.minimum(
        ratio * adv, torch.clamp(ratio, 1 - clip_param, 1 + clip_param) * adv)
    policy_loss = -_masked_mean(surr, mask)
    vf_loss = 0.5 * _masked_mean((v_pred - vt) ** 2, mask)
    ent = _masked_mean(-(torch.exp(lp_full) * lp_full).sum(-1), mask)
    # One-sample KL(behavior || current) estimate: drift telemetry.
    kl = _masked_mean(behavior - new_logp, mask)
    total = policy_loss + vf_coeff * vf_loss - entropy_coeff * ent
    return total, {"policy_loss": policy_loss, "vf_loss": vf_loss,
                   "entropy": ent, "approx_kl": kl}


class SeqPPOLearner:
    """PPO-on-sequences learner for a ``GPT2WithValue`` module, which it
    moves to ``device`` (CUDA unless ``device="cpu"``) and trains in
    place.

    ``update(batch_dict)`` runs advantage estimation plus
    ``num_sgd_iter`` shuffled-minibatch epochs and returns host metrics
    (one device read)."""

    def __init__(self, model: torch.nn.Module, *, batch_size: int,
                 pad_to: int, lr: float = 1e-4, clip_param: float = 0.2,
                 vf_coeff: float = 0.5, entropy_coeff: float = 0.01,
                 grad_clip: Optional[float] = 1.0, num_sgd_iter: int = 2,
                 minibatch_size: Optional[int] = None,
                 num_devices: Optional[int] = None,
                 zero_sharding: str = "off",
                 quantized_collectives: str = "off", seed: int = 0,
                 device=None):
        self.batch_size = int(batch_size)
        self.pad_to = int(pad_to)
        plan = types.SimpleNamespace(
            num_devices=num_devices, zero_sharding=zero_sharding,
            quantized_collectives=quantized_collectives)
        mesh_util.setup_data_mesh(plan, self.batch_size)
        mb = int(minibatch_size or self.batch_size)
        if mb > self.batch_size or self.batch_size % mb:
            raise ValueError(
                f"minibatch_size={mb} must divide batch_size="
                f"{self.batch_size}")
        self._mb = mb
        self._num_mb = self.batch_size // mb
        self._num_sgd_iter = int(num_sgd_iter)
        self.device = resolve_device(device)
        self._model = model.to(self.device)
        self._params = list(self._model.parameters())
        self._update_fn, self._optimizer = mesh_util.build_update_plan(
            plan, lr, grad_clip, self._params)
        self._loss_kw = dict(clip_param=clip_param, vf_coeff=vf_coeff,
                             entropy_coeff=entropy_coeff)
        shuffle = np.random.default_rng(seed)
        self._permute = lambda n: torch.from_numpy(shuffle.permutation(n))

    @property
    def model(self) -> torch.nn.Module:
        return self._model

    def lm_state_dict(self) -> Dict[str, torch.Tensor]:
        """The policy's state dict, exactly what ``LLMEngine.swap_weights``
        installs (the value head never ships to the serving plane)."""
        return self._model.lm.state_dict()

    def _loss(self, mb: Dict[str, torch.Tensor]):
        return sequence_ppo_loss(self._model, mb, **self._loss_kw)

    def sgd_batch(self, batch: Dict[str, np.ndarray]
                  ) -> Dict[str, torch.Tensor]:
        """The batch on the learner's device with the advantages and value
        targets of the current (pre-update) critic: what ``update`` cuts
        its minibatches from."""
        if tuple(batch["tokens"].shape) != (self.batch_size, self.pad_to):
            raise ValueError(
                f"batch shape {tuple(batch['tokens'].shape)} != "
                f"({self.batch_size}, {self.pad_to}): keep rollout batch "
                "shapes constant")
        dev = self.device
        tokens = torch.as_tensor(np.asarray(batch["tokens"]),
                                 dtype=torch.int64).to(dev)
        mask = torch.as_tensor(np.asarray(batch["response_mask"]),
                               dtype=torch.float32).to(dev)
        behavior = torch.as_tensor(np.asarray(batch["behavior_logp"]),
                                   dtype=torch.float32).to(dev)
        rewards = torch.as_tensor(np.asarray(batch["rewards"]),
                                  dtype=torch.float32).to(dev)
        # Advantages from the pre-update critic, once per batch.
        with torch.no_grad():
            _, values0 = self._model(tokens)
        vt = rewards[:, None] * mask
        v_pre = torch.cat([torch.zeros_like(values0[:, :1]),
                           values0[:, :-1]], dim=1)
        adv_raw = (rewards[:, None] - v_pre) * mask
        m = _masked_mean(adv_raw, mask)
        var = _masked_mean((adv_raw - m) ** 2, mask)
        adv = (adv_raw - m) / (torch.sqrt(var) + 1e-8) * mask
        return {"tokens": tokens, "response_mask": mask,
                "behavior_logp": behavior, "advantages": adv,
                "value_targets": vt}

    def update(self, batch: Dict[str, np.ndarray]) -> Dict[str, Any]:
        flat = self.sgd_batch(batch)
        dev = self.device
        losses, auxes = run_ppo_sgd(
            self._params, self._update_fn, self._loss,
            lambda idx: {k: v[idx.to(dev)] for k, v in flat.items()},
            self.batch_size, self._mb, self._num_mb, self._num_sgd_iter,
            self._permute)
        metrics = torch.stack([losses.mean()]
                              + [v.mean() for v in auxes.values()])
        values = metrics.tolist()
        return dict(zip(["total_loss", *auxes], values))
