"""Algorithm base: the Trainable-like training loop (counterpart of
``ray_tpu/rllib/algorithms/algorithm.py``; reference:
rllib/algorithms/algorithm.py:150 — setup :482, step :744).

The port runs Anakin mode only, on the device ``config.device`` names
(CUDA when it names none).  Actor mode, ``evaluate`` and checkpoints are
not ported yet (ROADMAP, Queue 1 item 4).
"""
from __future__ import annotations

import time
from typing import Any, Dict

from ray_tpu_torch._device import resolve_device


class Algorithm:
    _default_config_cls = None

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
                "1 item 4)")
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

    # hooks provided by concrete algorithms
    def _setup_anakin(self):
        raise NotImplementedError(f"{type(self).__name__} has no anakin mode")

    def _training_step_anakin(self) -> Dict[str, Any]:
        raise NotImplementedError
