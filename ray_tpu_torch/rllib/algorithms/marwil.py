"""MARWIL: monotonic advantage re-weighted imitation learning, offline
(counterpart of ``ray_tpu/rllib/algorithms/marwil.py``; reference:
rllib/algorithms/marwil/marwil.py and marwil_torch_policy.py):
exponentially advantage-weighted behavior cloning — policy loss
-E[exp(beta * A / c) * logp], advantages A = R - V(s) against the
module's value head trained jointly, c a running RMS normalizer of A
(``ma_adv_norm``); beta=0 makes the policy loss BC's.

The structure is BC's (``bc.py``): the dataset on the device, the
discounted returns computed once at load (numpy, ``discounted_returns``),
and the minibatch pass replayed from a CUDA graph on the card.  The
normalizer is a 0-d tensor on the device, carried across updates and
iterations in place.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithms.bc import BC, BCConfig


class MARWILConfig(BCConfig):
    def __init__(self):
        super().__init__()
        self.algo_class = MARWIL
        self.beta = 1.0                 # 0 => plain BC
        self.vf_coeff = 1.0
        self.ma_adv_norm_rate = 1e-2
        self.marwil_minibatch_size = 256


def discounted_returns(rewards: np.ndarray, dones: np.ndarray,
                       gamma: float) -> np.ndarray:
    """Per-episode discounted reward-to-go; the final (possibly truncated)
    episode treats end-of-data as terminal (reference:
    postprocessing.compute_advantages with use_gae=False)."""
    out = np.zeros_like(rewards, dtype=np.float32)
    acc = 0.0
    for t in range(len(rewards) - 1, -1, -1):
        if dones[t]:
            acc = 0.0
        acc = rewards[t] + gamma * acc
        out[t] = acc
    return out


def marwil_loss(module, ma_adv_norm: torch.Tensor, batch, *, beta: float,
                vf_coeff: float, rate: float
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total loss, {policy_loss, vf_loss, ma_adv_norm}) of a minibatch;
    ``ma_adv_norm`` is the normalizer before it, the returned one after
    (both without gradient)."""
    logp, value, _ent = module.forward_train(batch["obs"], batch["actions"])
    adv = batch["returns"] - value
    vf_loss = (adv ** 2).mean()
    adv_sg = adv.detach()
    new_norm = ma_adv_norm + rate * ((adv_sg ** 2).mean() - ma_adv_norm)
    if beta != 0.0:
        # exp-weighted imitation, weights normalized by the running RMS of
        # the advantage, the exponent clipped (the JAX package's cap).
        w = torch.exp(torch.clamp(
            beta * adv_sg / torch.sqrt(new_norm.clamp_min(1e-8)),
            -10.0, 10.0))
    else:
        w = torch.ones_like(adv_sg)
    policy_loss = -(w * logp).mean()
    total = policy_loss + vf_coeff * vf_loss
    return total, {"policy_loss": policy_loss, "vf_loss": vf_loss,
                   "ma_adv_norm": new_norm}


class MARWIL(BC):
    _default_config_cls = MARWILConfig
    _minibatch_key = "marwil_minibatch_size"

    def _setup_anakin(self):
        super()._setup_anakin()
        self.ma_adv_norm = torch.ones((), device=self.device)

    def _load(self, data) -> Dict[str, np.ndarray]:
        rewards = np.asarray(data["rewards"], np.float32)
        dones = np.asarray(data.get("dones", np.zeros(len(rewards))),
                           np.float32)
        return {**super()._load(data),
                "returns": discounted_returns(rewards, dones,
                                              self.config.gamma)}

    def loss(self, batch):
        c = self.config
        total, aux = marwil_loss(self.module, self.ma_adv_norm, batch,
                                 beta=c.beta, vf_coeff=c.vf_coeff,
                                 rate=c.ma_adv_norm_rate)
        self.ma_adv_norm.copy_(aux["ma_adv_norm"])
        return total, aux

    def _iteration_metrics(self, means: Dict[str, float]) -> Dict[str, Any]:
        return {"marwil_loss": means["total_loss"],
                "policy_loss": means["policy_loss"],
                "vf_loss": means["vf_loss"],
                "ma_adv_norm": self.ma_adv_norm.item()}
