"""Evolution Strategies, OpenAI-ES (counterpart of
``ray_tpu/rllib/algorithms/es.py``; reference: rllib/algorithms/es/es.py
— a head fans noise seeds to CPU workers, each perturbs the policy, runs
an episode and returns a scalar fitness).

As in the JAX package, a generation is one device program: the
population is a leading axis.  The policy's parameters are one flat
vector (``parameters_to_vector`` of the ``MLP``, in torch's parameter
order); the population is ``[P, dim]`` (antithetic pairs ``flat ± sigma
* eps``), and the MLP runs for all P members at once as ``bmm``s over
per-member weight views of it.  The P episodes are one batch of the
env's ``step_core`` with the JAX package's ``alive`` mask (an episode's
reward stops at its first done; what the env does after it is masked),
so no step draws anything.  The update is the antithetic rank-weighted
gradient ``-(w @ eps) / (half * sigma)`` through
``torch.optim.SGD(lr, momentum=0.9, weight_decay=l2_coeff,
dampening=0)``, which is ``optax.chain(add_decayed_weights(l2),
sgd(lr, momentum=0.9))`` step for step.

The noise ``eps`` ``[half, dim]`` and the P initial env states are drawn
from a generator on the device (seeded with ``config.seed``) into static
tensors; the generation itself (P episodes of ``episode_length`` steps,
the ranks, the update) runs eagerly on the CPU and replays one CUDA graph
on the card.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch
from torch.nn.utils import parameters_to_vector, vector_to_parameters

from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.models.mlp import MLP
from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm, make_env
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.utils.cuda_graphs import CapturedCalls


class ESConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(algo_class=ES)
        # Reference knobs (es.py DEFAULT_CONFIG): episodes_per_batch /
        # noise_stdev / stepsize / l2_coeff.
        self.population_size = 256       # antithetic pairs: must be even
        self.noise_stdev = 0.05
        self.lr = 0.02
        self.l2_coeff = 0.005
        self.episode_length = 200


def _centered_ranks(x: torch.Tensor) -> torch.Tensor:
    """Fitness shaping (reference: es_utils compute_centered_ranks).  The
    sorts are stable, as ``jnp.argsort``'s: CartPole's integer fitness
    ties often, and tied members keep their order."""
    ranks = torch.argsort(torch.argsort(x, stable=True),
                          stable=True).to(torch.float32)
    return ranks / (x.shape[0] - 1) - 0.5


class PopulationMLP:
    """An ``MLP``'s forward for a population of flat parameter vectors
    (``[P, dim]``, ``parameters_to_vector``'s order: each layer's
    ``[out, in]`` weight, then its bias): ``(flat, x [P, in]) -> [P,
    out]``, each member's layers as ``bmm``s over views of its row."""

    def __init__(self, module: MLP):
        self.activation = module.activation
        self.layers: List[Tuple[int, int, int]] = []  # (offset, out, in)
        offset = 0
        names = [f"dense_{i}" for i in range(module.num_hidden)] + ["out"]
        for name in names:
            layer = getattr(module, name)
            out_f, in_f = layer.weight.shape
            self.layers.append((offset, out_f, in_f))
            offset += out_f * in_f + out_f
        self.dim = offset

    def __call__(self, flat: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        P = flat.shape[0]
        x = x.to(torch.float32)
        for i, (off, out_f, in_f) in enumerate(self.layers):
            w = flat[:, off:off + out_f * in_f].view(P, out_f, in_f)
            b = flat[:, off + out_f * in_f:off + out_f * in_f + out_f]
            x = torch.baddbmm(b[:, :, None], w, x[:, :, None])[:, :, 0]
            if i < len(self.layers) - 1:
                x = self.activation(x)
        return x


def episode_returns(env, policy: PopulationMLP, pop: torch.Tensor,
                    init_core: torch.Tensor, T: int) -> torch.Tensor:
    """Each member's deterministic-policy return over ``T`` steps from its
    initial state (``init_core`` ``[P, ...]``, the env's ``state["core"]``
    at ``t`` 0): argmax actions, the reward counted while the member's
    episode is alive."""
    P = pop.shape[0]
    state = {"core": init_core,
             "t": torch.zeros(P, dtype=torch.int32, device=pop.device)}
    ret = torch.zeros(P, device=pop.device)
    alive = torch.ones(P, device=pop.device)
    for _ in range(T):
        action = policy(pop, env._obs(state)).argmax(-1)
        state, reward, done = env.step_core(state, action)
        ret = ret + reward * alive
        alive = alive * (1.0 - done.to(torch.float32))
    return ret


def es_update(flat: torch.nn.Parameter, optimizer: torch.optim.Optimizer,
              eps: torch.Tensor, fit: torch.Tensor, sigma: float
              ) -> torch.Tensor:
    """The update from the population's fitness ``fit`` ``[2 * half]``
    (``flat + sigma * eps`` first, then ``flat - sigma * eps``): the
    centered ranks, the antithetic gradient handed to ``optimizer``, which
    steps ``flat`` in place.  Returns the ranks."""
    half = eps.shape[0]
    with torch.no_grad():
        ranks = _centered_ranks(fit)
        # Antithetic estimator: (R+ - R-) weighted noise.
        w = ranks[:half] - ranks[half:]
        flat.grad = -(w @ eps) / (half * sigma)  # ascent via optimizer
    optimizer.step()
    return ranks


def es_generation(env, policy: PopulationMLP, flat: torch.nn.Parameter,
                  optimizer: torch.optim.Optimizer, eps: torch.Tensor,
                  init_core: torch.Tensor, sigma: float, T: int
                  ) -> Dict[str, torch.Tensor]:
    """One generation from the noise ``eps`` ``[half, dim]`` and the
    members' initial states: the population ``[flat + sigma * eps, flat -
    sigma * eps]``, its fitness, then ``es_update``.  Returns the fitness
    metrics and the fitness and ranks themselves."""
    with torch.no_grad():
        pop = torch.cat([flat + sigma * eps, flat - sigma * eps])
        fit = episode_returns(env, policy, pop, init_core, T)
    ranks = es_update(flat, optimizer, eps, fit, sigma)
    return {"episode_reward_mean": fit.mean(), "fitness_max": fit.max(),
            "fitness_std": fit.std(unbiased=False), "fitness": fit,
            "ranks": ranks}


class ES(Algorithm):
    _default_config_cls = ESConfig
    _data_mesh_capable = False

    def _setup_anakin(self):
        config = self.config
        if config.population_size % 2:
            raise ValueError("population_size must be even (antithetic)")
        env = make_env(config)
        self._env = env
        self.module = MLP(env.obs_dim, tuple(config.hiddens),
                          env.num_actions,
                          generator=torch.Generator().manual_seed(
                              config.seed)).to(self.device)
        self._policy = PopulationMLP(self.module)
        self.flat = torch.nn.Parameter(
            parameters_to_vector(self.module.parameters()).detach().clone())
        self.optimizer = torch.optim.SGD(
            [self.flat], lr=config.lr, momentum=0.9,
            weight_decay=config.l2_coeff, dampening=0)
        half = config.population_size // 2
        self._generator = torch.Generator(device=self.device).manual_seed(
            config.seed)
        self._eps = torch.zeros((half, self._policy.dim), device=self.device)
        self._init_core = env.reset_state(
            config.population_size, self._generator, self.device)["core"]
        self._calls = CapturedCalls(self.device)
        self._steps_per_iter = config.population_size * config.episode_length

    def generation(self, eps: torch.Tensor, init_core: torch.Tensor
                   ) -> Dict[str, torch.Tensor]:
        """One generation from the given noise and initial states (the
        train step's draws, or a caller's)."""
        c = self.config
        return es_generation(self._env, self._policy, self.flat,
                             self.optimizer, eps, init_core, c.noise_stdev,
                             c.episode_length)

    def _training_step_anakin(self) -> Dict[str, Any]:
        c = self.config
        torch.randn(self._eps.shape, generator=self._generator,
                    device=self.device, out=self._eps)
        self._init_core.copy_(self._env.reset_state(
            c.population_size, self._generator, self.device)["core"])
        out = self._calls.run(
            lambda: self.generation(self._eps, self._init_core))
        names = ("episode_reward_mean", "fitness_max", "fitness_std")
        values = torch.stack([out[k] for k in names]).tolist()
        metrics = dict(zip(names, values))
        metrics["num_env_steps_sampled_this_iter"] = self._steps_per_iter
        return metrics

    def sync_module(self) -> None:
        """The flat vector into ``module``'s parameters."""
        with torch.no_grad():
            vector_to_parameters(self.flat.detach(), self.module.parameters())

    def evaluate(self, num_steps: int = 1000) -> Dict[str, float]:
        raise NotImplementedError(
            "ES has no generic evaluator (the JAX package's needs an "
            "RLModule with forward_inference)")

    # Checkpointing: the flat vector is the whole policy.
    def save_checkpoint(self) -> Checkpoint:
        self.sync_module()
        return Checkpoint.from_state_dict(
            self.module.state_dict(), extra={"iteration": self.iteration})

    def load_checkpoint(self, checkpoint: Checkpoint):
        self.module.load_state_dict(checkpoint.to_state_dict())
        with torch.no_grad():
            self.flat.copy_(parameters_to_vector(self.module.parameters()))
        self.iteration = checkpoint.extra().get("iteration", 0)

