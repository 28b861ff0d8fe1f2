"""Algorithm base: the Trainable-like training loop (counterpart of
``ray_tpu/rllib/algorithms/algorithm.py``; reference:
rllib/algorithms/algorithm.py:150 — setup :482, step :744).

The port runs Anakin mode only, on the device ``config.device`` names
(CUDA when it names none).  Actor mode (ROADMAP, Queue 1 item 5) and
checkpoints (item 1b, with ``air/checkpoint.py``) are not ported yet.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.rllib.env.torch_envs import make_torch_env


def make_env(config):
    """The env ``config.env`` names (or the env object it holds)."""
    return make_torch_env(config.env) if isinstance(config.env, str) \
        else config.env


class Algorithm:
    _default_config_cls = None

    # Called by each train step with the names of its phases as it
    # enqueues them (PPO, all three policies: "start", "rollout", "gae",
    # "sgd"; IMPALA/APPO: "start", "rollout", "forward", "vtrace",
    # "update"), so that a caller can record a CUDA event at each; None
    # outside measurements.
    on_phase: Optional[Callable[[str], None]] = None

    def __init__(self, config=None):
        if config is None:
            config = self._default_config_cls()
        self.config = config
        self.iteration = 0
        self._num_env_steps_sampled = 0
        self.setup()

    # ---- lifecycle ----
    def setup(self):
        if self.config.mode != "anakin":
            raise NotImplementedError(
                f"{type(self).__name__} in {self.config.mode!r} mode is not "
                "ported yet: the port runs Anakin mode only (ROADMAP, Queue "
                "1 item 5, actor-mode RL)")
        self.device = resolve_device(getattr(self.config, "device", None))
        self._setup_anakin()

    def train(self) -> Dict[str, Any]:
        t0 = time.perf_counter()
        metrics = self._training_step_anakin()
        self.iteration += 1
        self._num_env_steps_sampled += metrics.get(
            "num_env_steps_sampled_this_iter", 0)
        metrics.update({
            "training_iteration": self.iteration,
            "num_env_steps_sampled": self._num_env_steps_sampled,
            "time_this_iter_s": time.perf_counter() - t0,
        })
        return metrics

    def stop(self):
        """Anakin mode holds no workers or streams: nothing to release
        beyond what Python frees."""

    def evaluate(self, num_steps: int = 1000) -> Dict[str, float]:
        """Greedy in-env evaluation: ``num_steps`` steps of 16 envs, the
        mean return of the episodes that ended (reference:
        Algorithm.evaluate).  The envs and the steps draw from a generator
        on the device seeded with ``seed + 1``, kept across calls."""
        if getattr(self, "_eval_rollout", None) is None:
            self._eval_rollout = self._make_eval_rollout(
                make_env(self.config))
            self._eval_generator = torch.Generator(
                device=self.device).manual_seed(self.config.seed + 1)
        mean = self._eval_rollout(self._eval_generator, num_steps)
        return {"episode_reward_mean": mean.item()}

    def _make_eval_rollout(self, env):
        from ray_tpu_torch.rllib.algorithms.bc import \
            make_greedy_eval_rollout

        return make_greedy_eval_rollout(env, self.module)

    _NO_CHECKPOINTS = ("checkpoints are not ported yet: they wait for "
                       "air/checkpoint.py (ROADMAP, Queue 1 item 1b)")

    def save_checkpoint(self):
        raise NotImplementedError(self._NO_CHECKPOINTS)

    def load_checkpoint(self, checkpoint):
        raise NotImplementedError(self._NO_CHECKPOINTS)

    # ---- shared helpers ----
    def _episode_counter_metrics(self, metrics: Dict[str, Any]
                                 ) -> Dict[str, Any]:
        """Convert the cumulative on-device episode counters
        (episode_return_sum/episode_count, already on the host) into a
        per-iteration episode_reward_mean: the mean return of the episodes
        that ended this iteration, or the last such mean when none did."""
        prev_sum, prev_cnt = getattr(self, "_prev_counters", (0.0, 0.0))
        cum_sum = metrics.pop("episode_return_sum")
        cum_cnt = metrics.pop("episode_count")
        self._prev_counters = (cum_sum, cum_cnt)
        dsum, dcnt = cum_sum - prev_sum, cum_cnt - prev_cnt
        if dcnt > 0:
            self._ep_reward_ema = dsum / dcnt
        metrics["episode_reward_mean"] = getattr(self, "_ep_reward_ema",
                                                 float("nan"))
        return metrics

    def _training_step_anakin(self) -> Dict[str, Any]:
        self._anakin_state, metrics = self._train_step(self._anakin_state,
                                                       self.on_phase)
        # ONE device-to-host read for every metric: the iteration's only
        # sync with the device.
        names = list(metrics)
        values = torch.stack([metrics[k].float() for k in names]).tolist()
        metrics = self._episode_counter_metrics(dict(zip(names, values)))
        metrics["num_env_steps_sampled_this_iter"] = self._steps_per_iter
        return metrics

    # hook provided by concrete algorithms: sets ``_anakin_state``,
    # ``_train_step``, ``_steps_per_iter`` and ``module``
    def _setup_anakin(self):
        raise NotImplementedError(f"{type(self).__name__} has no anakin mode")
