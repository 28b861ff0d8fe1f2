"""BC (behavior cloning): supervised policy learning from offline data
(counterpart of ``ray_tpu/rllib/algorithms/bc.py``; reference:
rllib/algorithms/bc/bc.py, BC = MARWIL with beta=0 — maximize the policy
log-likelihood of dataset actions; no env interaction during training),
and the greedy in-env evaluator every Anakin algorithm shares.

The dataset loads once onto the device.  Each ``train()`` runs
``num_sgd_per_iter`` minibatch updates, each on uniform random indices
drawn from a generator on the device (seeded with ``config.seed``), with
``clip_by_global_norm(grad_clip)`` then ``adam(lr)``.  The JAX package
jits the pass into one program; the port runs it eagerly on the CPU and,
on CUDA, replays it from one CUDA graph (``CapturedCalls``): the indices
are drawn into a static ``[num_sgd_per_iter, minibatch]`` tensor first.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm, make_env
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.core.rl_module import RLModuleSpec
from ray_tpu_torch.rllib.utils import mesh as mesh_util
from ray_tpu_torch.rllib.utils.cuda_graphs import (
    CapturedCalls,
    capturable_adam,
)

from ray_tpu_torch.rllib.env.torch_envs import (
    count_episodes,
    vector_reset,
    vector_step,
)


Policy = Callable[[Any, torch.Tensor, torch.Tensor],
                  Tuple[Any, torch.Tensor]]


def greedy_eval_rollout(env, policy: Policy,
                        init_memory: Callable[[int, torch.device], Any],
                        num_eval_envs: int = 16
                        ) -> Callable[[torch.Generator, int], torch.Tensor]:
    """``eval_rollout(generator, num_steps)``: ``num_eval_envs`` envs reset
    and stepped from ``generator`` (on the policy's device) for
    ``num_steps`` steps, each action from ``policy(memory, obs,
    prev_done) -> (memory, action)``, the memory starting as
    ``init_memory(num_eval_envs, device)``.  Returns the mean return of
    the episodes that ended (0 if none did), a 0-d tensor on the
    device."""

    @torch.no_grad()
    def eval_rollout(generator: torch.Generator, num_steps: int):
        device = generator.device
        env_states, obs = vector_reset(env, generator, num_eval_envs, device)
        memory = init_memory(num_eval_envs, device)
        done = torch.zeros(num_eval_envs, dtype=torch.bool, device=device)
        ep_ret = torch.zeros(num_eval_envs, device=device)
        dsum = torch.zeros((), device=device)
        dcnt = torch.zeros((), device=device)
        for _ in range(num_steps):
            memory, action = policy(memory, obs, done)
            env_states, obs, reward, done, _ = vector_step(
                env, env_states, action, generator)
            ep_ret, dsum, dcnt = count_episodes(ep_ret, dsum, dcnt, reward,
                                                done)
        return dsum / dcnt.clamp_min(1.0)

    return eval_rollout


def make_greedy_eval_rollout(env, module, num_eval_envs: int = 16):
    """The greedy rollout of a memoryless module
    (``module.forward_inference``)."""
    return greedy_eval_rollout(
        env, lambda memory, obs, done: (None, module.forward_inference(obs)),
        lambda n, device: None, num_eval_envs)


class BCConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(algo_class=BC)
        self.lr = 1e-3
        self.offline_input = None     # path readable by JsonReader
        self.bc_minibatch_size = 256
        self.num_sgd_per_iter = 32

    def offline_data(self, input_=None):
        if input_ is not None:
            self.offline_input = input_
        return self


class BC(Algorithm):
    """Anakin mode only, as in the JAX package.  ``sgd_update(idx)`` is
    one minibatch update on the rows ``idx``; ``train()`` runs
    ``num_sgd_per_iter`` of them on fresh uniform draws."""

    _default_config_cls = BCConfig
    _data_mesh_capable = False
    _minibatch_key = "bc_minibatch_size"
    _columns = ("obs", "actions")

    def _setup_anakin(self):
        from ray_tpu_torch.rllib.offline import JsonReader

        config = self.config
        env = make_env(config)
        self._env = env
        self.module = RLModuleSpec(
            obs_dim=env.obs_dim, num_actions=env.num_actions,
            hiddens=tuple(config.hiddens)).build(
                torch.Generator().manual_seed(config.seed)).to(self.device)
        if config.offline_input is None:
            raise ValueError(f"{type(self).__name__} requires "
                             "config.offline_data(input_=path)")
        self._data = {k: torch.from_numpy(v).to(self.device)
                      for k, v in self._load(
                          JsonReader(config.offline_input).read_all()).items()}
        n = self._data["obs"].shape[0]
        mb = min(getattr(config, self._minibatch_key), n)
        self._params = list(self.module.parameters())
        self._update_fn, self.optimizer = mesh_util.build_update_plan(
            config, config.lr, config.grad_clip, self._params)
        capturable_adam(self.optimizer, self.device)
        self._generator = torch.Generator(device=self.device).manual_seed(
            config.seed)
        self._n = n
        self._idx = torch.zeros((config.num_sgd_per_iter, mb),
                                dtype=torch.int64, device=self.device)
        self._calls = CapturedCalls(self.device)
        self._steps_per_iter = 0

    def _load(self, data) -> Dict[str, np.ndarray]:
        """The dataset's columns the loss reads, as numpy."""
        return {"obs": np.asarray(data["obs"], np.float32),
                "actions": np.asarray(data["actions"], np.int64)}

    def loss(self, batch: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(loss, metrics) of a minibatch: -mean log-likelihood of its
        actions."""
        logp, _value, _ent = self.module.forward_train(batch["obs"],
                                                       batch["actions"])
        return -logp.mean(), {}

    def sgd_update(self, idx: torch.Tensor) -> Dict[str, torch.Tensor]:
        """One minibatch update on the rows ``idx``; returns its loss (as
        ``total_loss``) and metrics, detached."""
        loss, aux = self.loss({k: v[idx] for k, v in self._data.items()})
        # BC's loss leaves the value head unused: its gradient is zeros,
        # as jax.grad gives it (Adam then leaves it where it is).
        grads = torch.autograd.grad(loss, self._params, allow_unused=True)
        self._update_fn([torch.zeros_like(p) if g is None else g
                         for p, g in zip(self._params, grads)])
        return {"total_loss": loss.detach(),
                **{k: v.detach() for k, v in aux.items()}}

    def _sgd_pass(self) -> Dict[str, torch.Tensor]:
        outs = [self.sgd_update(idx) for idx in self._idx]
        return {k: torch.stack([o[k] for o in outs]).mean() for k in outs[0]}

    def _training_step_anakin(self) -> Dict[str, Any]:
        torch.randint(0, self._n, self._idx.shape, generator=self._generator,
                      device=self.device, out=self._idx)
        out = self._calls.run(self._sgd_pass)
        names = list(out)
        values = torch.stack([out[k] for k in names]).tolist()
        return self._iteration_metrics(dict(zip(names, values)))

    def _iteration_metrics(self, means: Dict[str, float]) -> Dict[str, Any]:
        return {"bc_loss": means["total_loss"]}
