"""RLModule: policy and value heads behind one module (counterpart of
``ray_tpu/rllib/core/rl_module.py``), with ``forward_inference``,
``forward_exploration`` and ``forward_train``.

The module is an ``nn.Module`` that holds its parameters, so the calls
take no ``params`` argument.  Exploration draws from an explicit
``torch.Generator`` on the module's device: the port does not reproduce
``jax.random.categorical``'s bits, only its distribution (Gumbel-max).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from ray_tpu_torch.models.flax_layers import dense
from ray_tpu_torch.models.mlp import MLP
from ray_tpu_torch.models.nature_cnn import MinAtarCNN, NatureCNN


@dataclasses.dataclass(frozen=True)
class RLModuleSpec:
    obs_dim: Optional[int] = None
    obs_shape: Optional[Tuple[int, ...]] = None  # set for pixel obs
    num_actions: int = 2
    hiddens: Tuple[int, ...] = (64, 64)
    conv: bool = False

    def build(self, generator: Optional[torch.Generator] = None
              ) -> "DiscreteActorCritic":
        return DiscreteActorCritic(self, generator)

    def example_obs(self, batch: int = 1) -> torch.Tensor:
        """A zero observation batch of this spec's trunk input (CPU): uint8
        frames for the conv trunk, flat float32 vectors otherwise."""
        if self.conv:
            return torch.zeros((batch,) + tuple(self.obs_shape),
                               dtype=torch.uint8)
        return torch.zeros((batch, self.obs_dim), dtype=torch.float32)

    @classmethod
    def for_env(cls, env, hiddens: Tuple[int, ...]) -> "RLModuleSpec":
        """Envs with an ``obs_shape`` get the CNN trunk, flat envs the
        MLP."""
        obs_shape = getattr(env, "obs_shape", None)
        if obs_shape is not None:
            return cls(obs_shape=tuple(obs_shape),
                       num_actions=env.num_actions, conv=True)
        return cls(obs_dim=env.obs_dim, num_actions=env.num_actions,
                   hiddens=tuple(hiddens))


class DiscreteActorCritic(nn.Module):
    """Categorical policy and value baseline: a shared CNN trunk for pixels
    (``NatureCNN``, or ``MinAtarCNN`` on boards under 32 px), separate MLP
    trunks for vectors.  Initialised as flax initialises, from
    ``generator``."""

    def __init__(self, spec: RLModuleSpec,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.spec = spec
        if spec.conv:
            small = min(spec.obs_shape[0], spec.obs_shape[1]) < 32
            self.trunk = (MinAtarCNN(spec.obs_shape, 128, generator=generator)
                          if small else
                          NatureCNN(spec.obs_shape, 256, generator=generator))
            width = self.trunk.dense_0.out_features
            self.pi = dense(width, spec.num_actions, generator)
            self.vf = dense(width, 1, generator)
        else:
            self.pi_mlp = MLP(spec.obs_dim, spec.hiddens, spec.num_actions,
                              generator=generator)
            self.vf_mlp = MLP(spec.obs_dim, spec.hiddens, 1,
                              generator=generator)

    def forward(self, obs: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.spec.conv:
            trunk = self.trunk(obs)
            return self.pi(trunk), self.vf(trunk)[..., 0]
        return self.pi_mlp(obs), self.vf_mlp(obs)[..., 0]

    # ---- RLModule API ----
    def forward_inference(self, obs: torch.Tensor) -> torch.Tensor:
        logits, _ = self(obs)
        return logits.argmax(-1)

    def forward_exploration(self, obs: torch.Tensor,
                            generator: torch.Generator):
        """(action, its log-probability, value).  The action is a
        Gumbel-max draw, as ``jax.random.categorical`` makes it: -log E
        of E ~ Exp(1) is a standard Gumbel."""
        logits, value = self(obs)
        logp = torch.log_softmax(logits, -1)
        noise = torch.empty_like(logp).exponential_(generator=generator)
        action = (logp - noise.log()).argmax(-1)
        action_logp = logp.gather(-1, action[..., None])[..., 0]
        return action, action_logp, value

    def forward_train(self, obs: torch.Tensor, actions: torch.Tensor):
        """(log-probability of ``actions``, value, entropy)."""
        logits, value = self(obs)
        logp_all = torch.log_softmax(logits, -1)
        action_logp = logp_all.gather(
            -1, actions[..., None].to(torch.int64))[..., 0]
        entropy = -(logp_all.exp() * logp_all).sum(-1)
        return action_logp, value, entropy
