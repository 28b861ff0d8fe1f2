"""APPO in Anakin mode: IMPALA's step with PPO's clipped surrogate on the
V-trace advantages (counterpart of ``ray_tpu/rllib/algorithms/appo.py``;
reference: rllib/algorithms/appo/appo.py)."""
from __future__ import annotations

import functools
from typing import Callable

import torch

from ray_tpu_torch.rllib.algorithms.impala import (
    IMPALA,
    IMPALAConfig,
    time_major_forward,
    vtrace_targets,
)


class APPOConfig(IMPALAConfig):
    def __init__(self):
        super().__init__()
        self.algo_class = APPO
        self.clip_param = 0.2
        self.lr = 5e-4
        self.num_sgd_iter = 1


def appo_objective(logp, value, entropy, vs, pg_adv, batch, *,
                   vf_loss_coeff, entropy_coeff, clip_param):
    """The importance ratio against the behaviour policy, clipped as PPO
    clips it, times the V-trace advantage; the value error to ``vs``; the
    entropy bonus."""
    ratio = torch.exp(logp - batch["behaviour_logp"])
    policy_loss = -torch.minimum(
        ratio * pg_adv,
        torch.clamp(ratio, 1 - clip_param, 1 + clip_param) * pg_adv).mean()
    vf_loss = 0.5 * ((value - vs) ** 2).mean()
    ent = entropy.mean()
    total = policy_loss + vf_loss_coeff * vf_loss - entropy_coeff * ent
    return total, {"policy_loss": policy_loss, "vf_loss": vf_loss,
                   "entropy": ent}


def appo_loss(module, batch, *, gamma, clip_rho, clip_c, vf_loss_coeff,
              entropy_coeff, clip_param):
    """The JAX ``appo_loss``, on ``impala_loss``'s time-major batch."""
    logp, value, entropy = time_major_forward(module, batch)
    vs, pg_adv = vtrace_targets(logp, value, batch, gamma=gamma,
                                clip_rho=clip_rho, clip_c=clip_c)
    return appo_objective(logp, value, entropy, vs, pg_adv, batch,
                          vf_loss_coeff=vf_loss_coeff,
                          entropy_coeff=entropy_coeff, clip_param=clip_param)


class APPO(IMPALA):
    _default_config_cls = APPOConfig

    def _make_loss(self) -> Callable:
        c = self.config
        return functools.partial(appo_objective,
                                 vf_loss_coeff=c.vf_loss_coeff,
                                 entropy_coeff=c.entropy_coeff,
                                 clip_param=c.clip_param)
