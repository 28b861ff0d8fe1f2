"""Algorithm base: the Trainable-like training loop (counterpart of
``ray_tpu/rllib/algorithms/algorithm.py``; reference:
rllib/algorithms/algorithm.py:150 — setup :482, step :744,
save/load_checkpoint :2018,2081).

Two modes, as in the JAX package: Anakin (envs and learner on the device
``config.device`` names, CUDA when it names none) and actor (CPU rollout
actors, ``evaluation/worker_set.py``, feeding a ``TorchLearner`` on that
device, in lockstep or through a ``SampleStream``).
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.rllib.env.torch_envs import make_torch_env


def make_env(config):
    """The env ``config.env`` names (or the env object it holds)."""
    return make_torch_env(config.env) if isinstance(config.env, str) \
        else config.env


class Algorithm:
    _default_config_cls = None

    # Called by each train step with the names of its phases as it
    # enqueues them (Anakin PPO, all three policies: "start", "rollout",
    # "gae", "sgd"; Anakin IMPALA/APPO: "start", "rollout", "forward",
    # "vtrace", "update"; actor PPO: "start", "sample", "sgd" (after its
    # metrics' device read), "publish"; actor IMPALA/APPO: "start",
    # "update" (after the last update's metrics' read)), so that a caller
    # can record a CUDA event at each; None outside measurements.
    on_phase: Optional[Callable[[str], None]] = None

    # Whether the Anakin step takes ``num_devices`` (PPO, IMPALA and APPO:
    # ``mesh.setup_data_mesh``).  Any other path refuses it, as in the JAX
    # package, rather than run on one device while the user believes in N.
    _data_mesh_capable = True

    def __init__(self, config=None):
        if config is None:
            config = self._default_config_cls()
        self.config = config
        self.iteration = 0
        self._num_env_steps_sampled = 0
        self.setup()

    # ---- lifecycle ----
    def setup(self):
        if self.config.mode != "anakin" or not self._data_mesh_capable:
            from ray_tpu_torch.rllib.utils.mesh import reject_data_mesh

            reject_data_mesh(
                self.config,
                f"{type(self).__name__} in {self.config.mode} mode")
        self.device = resolve_device(getattr(self.config, "device", None))
        if self.config.mode == "anakin":
            self._setup_anakin()
        else:
            self._setup_actor_mode()

    def train(self) -> Dict[str, Any]:
        t0 = time.perf_counter()
        if self.config.mode == "anakin":
            metrics = self._training_step_anakin()
        else:
            metrics = self._training_step_actor()
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
        """Close the sample stream or the replay plane and kill the
        rollout workers (actor mode; Anakin mode holds none of them)."""
        stream = getattr(self, "_stream", None)
        if stream is not None:
            stream.close()
        rb = getattr(self, "_rb", None)
        if rb is not None:
            rb.close()
        workers = getattr(self, "workers", None)
        if workers is not None:
            workers.stop()

    def evaluate(self, num_steps: int = 1000) -> Dict[str, float]:
        """Greedy in-env evaluation: ``num_steps`` steps of 16 envs, the
        mean return of the episodes that ended (reference:
        Algorithm.evaluate).  The envs and the steps draw from a generator
        on the device seeded with ``seed + 1``, kept across calls.  Anakin
        mode only, as in the JAX package."""
        if self.config.mode != "anakin":
            raise NotImplementedError(
                f"{type(self).__name__} has no generic evaluator in "
                f"{self.config.mode} mode (needs anakin mode)")
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

    # ---- checkpointing (Trainable protocol) ----
    def save_checkpoint(self) -> Checkpoint:
        """The module's parameters and the iteration, as the reference's
        checkpoint holds them (its params and ``iteration``; the optimizer
        state is not saved).  In actor mode the learner's module."""
        return Checkpoint.from_state_dict(
            self.module.state_dict(), extra={"iteration": self.iteration})

    def load_checkpoint(self, checkpoint: Checkpoint):
        """Load the parameters; in actor mode also send them to the
        rollout workers as a new weights version."""
        self.module.load_state_dict(checkpoint.to_state_dict())
        self.iteration = checkpoint.extra().get("iteration", 0)
        if self.config.mode != "anakin":
            self.workers.sync_weights(self.learner.get_weights())

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
        # ONE device-to-host read for every metric on the device: the
        # iteration's only sync with it (host numbers pass as they are).
        names = [k for k, v in metrics.items() if torch.is_tensor(v)]
        values = torch.stack([metrics[k].float() for k in names]).tolist()
        metrics = self._episode_counter_metrics(
            {**metrics, **dict(zip(names, values))})
        metrics["num_env_steps_sampled_this_iter"] = self._steps_per_iter
        return metrics

    # hooks provided by concrete algorithms.  Anakin: sets
    # ``_anakin_state``, ``_train_step``, ``_steps_per_iter`` and
    # ``module``.  Actor: sets ``learner``, ``module`` (the learner's),
    # ``workers`` and ``_stream`` (None in lockstep).
    def _setup_anakin(self):
        raise NotImplementedError(f"{type(self).__name__} has no anakin mode")

    def _setup_actor_mode(self):
        raise NotImplementedError(f"{type(self).__name__} has no actor mode")

    def _training_step_actor(self) -> Dict[str, Any]:
        raise NotImplementedError

    def _setup_learner_and_workers(self, loss_fn) -> None:
        """Actor mode's common half: the module's spec from a probe of
        ``config.env``, a ``TorchLearner`` of ``loss_fn`` on
        ``self.device`` (the module drawn from ``config.seed``) and the
        rollout workers."""
        from ray_tpu_torch.rllib.core.learner import TorchLearner
        from ray_tpu_torch.rllib.core.rl_module import RLModuleSpec
        from ray_tpu_torch.rllib.env.py_envs import make_py_env
        from ray_tpu_torch.rllib.evaluation.worker_set import WorkerSet

        c = self.config
        probe = make_py_env(c.env)
        # for_env picks the trunk: pixel envs get the CNN fed raw uint8
        # frames (the rollout workers keep the dtype).
        spec = RLModuleSpec.for_env(probe, tuple(c.hiddens))
        if hasattr(probe, "close"):  # dimension probe only — release now
            probe.close()
        self.learner = TorchLearner(
            spec.build(torch.Generator().manual_seed(c.seed)), loss_fn,
            lr=c.lr, grad_clip=c.grad_clip, device=self.device)
        self.module = self.learner.module
        self.workers = WorkerSet(c, spec)

    def _start_stream(self, kind: str) -> None:
        """The streaming sample plane over the workers, and weights
        version 1: it lands before the first fragment dispatch (FIFO
        mailboxes), so no worker ever samples without weights."""
        from ray_tpu_torch.rllib.evaluation.sample_stream import SampleStream

        c = self.config
        self._stream = SampleStream(
            self.workers, kind=kind,
            max_in_flight_per_worker=c.max_in_flight_per_worker,
            max_weight_staleness=c.max_weight_staleness)
        self._stream.publish_weights(self.learner.get_weights())

    def _episode_reward_mean(self, ep_returns) -> float:
        """Actor mode: the mean return of the episodes that ended this
        iteration, or the last such mean when none did."""
        if ep_returns:
            self._ep_reward_ema = float(np.mean(ep_returns))
        return getattr(self, "_ep_reward_ema", float("nan"))

    def _stream_metrics(self) -> Dict[str, Any]:
        """The sample stream's readings, under the names the iteration's
        metrics carry them."""
        st = self._stream.stats()
        return {
            "rollout_fragments_per_s": st["fragments_per_s"],
            "rollout_weight_lag_mean": st["weight_lag_mean"],
            "rollout_weight_lag_max": st["weight_lag_max"],
            "rollout_worker_idle_frac": st["worker_idle_frac"],
            "rollout_queue_depth": st["inflight"],
            "rollout_stale_dropped": st["stale_dropped"],
        }
