"""RolloutWorker actors + WorkerSet (counterpart of
``ray_tpu/rllib/evaluation/worker_set.py``; reference:
rllib/evaluation/rollout_worker.py sample :878, worker_set.py:78 with
fault-tolerant sync_weights/sample).

The rollout workers are CPU actors: each steps a ``VectorEnv`` of numpy
envs and runs the policy with torch on the CPU, on one intra-op thread,
under ``torch.inference_mode()``.  They never touch the card: their
module is built on the device ``"cpu"``, and a worker's
``CUDA_VISIBLE_DEVICES`` is empty besides.  The rollout hot loop writes
into preallocated time-major ``[T, N, ...]`` arrays
(:class:`FragmentBuffers`).  Weights are versioned: each
``set_weights(state_dict, version)`` loads the CPU module once and stamps
every later fragment with the version it acted under; the streaming
sampler (``sample_stream.py``) uses the stamp to bound staleness.

What differs from the JAX package: the worker's ``rng`` (a PRNG key, one
split per fragment) is a CPU ``torch.Generator`` seeded
``seed + worker_index`` that every action draw of the worker advances, and
the GAE columns come from ``gae_torch`` on CPU tensors where the JAX
worker runs ``gae_jax``.  The off-policy worker (DQN/SAC/TD3, whose
``sample_publish`` feeds the replay plane) takes its draws the same way,
from a CPU generator seeded ``seed + worker_index``, and its policy is a
``(module, act)`` pair from a cloudpickled factory where the JAX worker
jits an ``act(params, obs, key, explore_arg)``.
"""
from __future__ import annotations

import os
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.rllib.env.py_envs import VectorEnv, make_py_env
from ray_tpu_torch.rllib.evaluation.postprocessing import gae_torch
from ray_tpu_torch.rllib.policy.sample_batch import SampleBatch

_CLOSE_S = 10.0  # seconds stop() waits for the workers to close envs
# Seconds a round of worker calls may take before its gets give up: a
# worker that hangs (not one that dies) must fail the round, not stall
# the driver forever.  A fragment takes seconds at the largest sizes.
_ROUND_S = 600.0


class FragmentBuffers:
    """Preallocated time-major fragment storage, reused across fragments.

    Column arrays are allocated lazily from the first row's shape/dtype as
    ``[T, N, ...]`` and overwritten in place each fragment — the actor
    serializes its reply before the next sample call runs, so reuse never
    races the wire copy.  Halves the hot-loop copies vs append+stack (one
    write per row instead of append now + stack later)."""

    def __init__(self, T: int):
        self.T = T
        self._arrs: Dict[str, np.ndarray] = {}

    def store(self, name: str, t: int, value) -> None:
        arr = self._arrs.get(name)
        if arr is None:
            row = np.asarray(value)
            arr = np.zeros((self.T,) + row.shape, row.dtype)
            self._arrs[name] = arr
        arr[t] = value

    def arrays(self) -> Dict[str, np.ndarray]:
        return dict(self._arrs)


_FRAGMENT_COLS = ("obs", "actions", "action_logp", "vf_preds", "rewards",
                  "dones")


def collect_fragment(env, act_fn, obs, steps: int, gen, ep_returns,
                     completed, bufs: Optional[FragmentBuffers] = None,
                     cast=lambda o: o):
    """Roll ``steps`` steps of ``env`` under ``act_fn(obs, gen) ->
    (action, logp, value)`` (numpy outputs; ``gen`` is the worker's
    ``torch.Generator``, drawn from at every step).

    With ``bufs`` rows land in preallocated ``[T, N, ...]`` arrays; with
    ``bufs=None`` the append+``np.stack`` path runs — kept so the
    byte-identity of the two paths stays testable.  Episode accounting
    (``ep_returns`` mutated in place, finished returns appended to
    ``completed``) is shared.  Returns ``(next_obs, cols)`` with cols
    time-major."""
    if bufs is None:
        lists: Dict[str, list] = {k: [] for k in _FRAGMENT_COLS}
        for t in range(steps):
            action, logp, value = act_fn(obs, gen)
            next_obs, reward, done, _ = env.step(action)
            lists["obs"].append(obs)
            lists["actions"].append(action)
            lists["action_logp"].append(logp)
            lists["vf_preds"].append(value)
            lists["rewards"].append(reward)
            lists["dones"].append(done)
            ep_returns += reward
            for i, d in enumerate(done):
                if d:
                    completed.append(float(ep_returns[i]))
                    ep_returns[i] = 0.0
            obs = cast(next_obs)
        return obs, {k: np.stack(v) for k, v in lists.items()}
    for t in range(steps):
        action, logp, value = act_fn(obs, gen)
        next_obs, reward, done, _ = env.step(action)
        bufs.store("obs", t, obs)
        bufs.store("actions", t, action)
        bufs.store("action_logp", t, logp)
        bufs.store("vf_preds", t, value)
        bufs.store("rewards", t, reward)
        bufs.store("dones", t, done)
        ep_returns += reward
        for i, d in enumerate(done):
            if d:
                completed.append(float(ep_returns[i]))
                ep_returns[i] = 0.0
        obs = cast(next_obs)
    return obs, bufs.arrays()


def fragment_batch(kind: str, cols: Dict[str, np.ndarray],
                   last_value: np.ndarray, gamma: float, lambda_: float):
    """A fragment's columns as the learner takes them: ``"timemajor"``,
    the ``[T, N]`` tensors V-trace consumes (behaviour logp, float
    rewards and dones, the bootstrap value); ``"gae"``, a flat
    ``SampleBatch`` with GAE's advantages and value targets."""
    if kind == "timemajor":
        return {
            "obs": cols["obs"],                       # [T, N, obs]
            "actions": cols["actions"],               # [T, N]
            "behaviour_logp": cols["action_logp"],
            "rewards": cols["rewards"].astype(np.float32),
            "dones": cols["dones"].astype(np.float32),
            "last_value": last_value,
        }
    if kind != "gae":
        raise ValueError(f"unknown fragment kind {kind!r}")
    rewards, values, dones = cols["rewards"], cols["vf_preds"], cols["dones"]
    adv, vtarg = gae_torch(torch.from_numpy(rewards),
                           torch.from_numpy(values),
                           torch.from_numpy(dones.astype(np.float32)),
                           torch.from_numpy(last_value), gamma, lambda_)
    n = rewards.size
    obs_arr = cols["obs"]  # [T, N, ...] — pixel shapes preserved
    return SampleBatch({
        "obs": obs_arr.reshape((n,) + obs_arr.shape[2:]),
        "actions": cols["actions"].reshape(n),
        "action_logp": cols["action_logp"].reshape(n),
        "vf_preds": values.reshape(n),
        "rewards": rewards.reshape(n),
        "dones": dones.reshape(n),
        "advantages": adv.numpy().reshape(n),
        "value_targets": vtarg.numpy().reshape(n),
    })


@ray_tpu_torch.remote
class RolloutWorker:
    """CPU actor stepping python envs with torch-on-CPU policy inference.

    Weights arrive via the object store (reference: sync_weights broadcast,
    worker_set.py) — one put per weights VERSION, workers apply it between
    fragments (the actor mailbox is FIFO, so a set_weights queued behind K
    in-flight sample calls lands exactly at the next fragment boundary)."""

    def __init__(self, env_name, module_spec, worker_index: int,
                 num_envs: int, fragment_length: int, gamma: float,
                 lambda_: float, seed: int, env_parallelism: str = "serial",
                 env_workers: Optional[int] = None):
        # One intra-op thread: several workers (and their env children)
        # share the host's cores, and a torch pool in each slows every one.
        torch.set_num_threads(1)
        self.env = VectorEnv(lambda: make_py_env(env_name),
                             num_envs, seed + worker_index * 1000,
                             mode=env_parallelism, num_workers=env_workers)
        self.device = resolve_device("cpu")
        self.module = module_spec.build().to(self.device).eval()
        # Pixel (conv) specs keep raw uint8 frames end-to-end — the CNN
        # trunk does the /255; casting to float32 here would both break
        # that normalization and 4x the sample payload.
        self._conv = bool(getattr(module_spec, "conv", False))
        self._has_weights = False
        self.fragment_length = fragment_length
        self.gamma = gamma
        self.lambda_ = lambda_
        self.rng = torch.Generator(device=self.device).manual_seed(
            seed + worker_index)
        self.obs = self._cast(self.env.reset_all())
        self.ep_returns = np.zeros(num_envs)
        self.completed: List[float] = []
        self._bufs = FragmentBuffers(fragment_length)
        self._weights_version = 0
        self._last_sample_end = 0.0

    def _cast(self, obs: np.ndarray) -> np.ndarray:
        return obs if self._conv else obs.astype(np.float32)

    def set_weights(self, state_dict, version: int = 0):
        # Load once per version: the store's zero-copy views are copied
        # into the module here and released with the message.
        self.module.load_state_dict(state_dict)
        self._has_weights = True
        self._weights_version = int(version)
        return version

    def ping(self):
        return "ok"

    def pid(self):
        return os.getpid()

    def close(self):
        """Close the envs: join their subprocesses and unlink the
        observation segment, which a kill would leave to the resource
        tracker."""
        self.env.close()
        return True

    def sample(self):
        """Returns (SampleBatch with GAE columns, completed episode
        returns) — the lockstep sample_sync shape."""
        batch, completed, _ = self.sample_fragment("gae")
        return batch, completed

    def sample_fragment(self, kind: str = "gae"):
        """One fragment + production info for the streaming sampler:
        ``(batch, completed_episode_returns, info)`` where info carries
        the weights version the fragment was produced under, wall-clock
        production interval, and the worker's idle gap since its previous
        fragment (the rollout_worker_idle_frac input)."""
        if not self._has_weights:
            raise RuntimeError("RolloutWorker.sample_fragment before any "
                               "set_weights")
        t0 = time.time()
        idle = t0 - self._last_sample_end if self._last_sample_end else 0.0
        T = self.fragment_length
        module = self.module

        def act(obs, gen):
            a, logp, v = module.forward_exploration(torch.from_numpy(obs),
                                                    gen)
            return a.numpy(), logp.numpy(), v.numpy()

        with torch.inference_mode():
            self.obs, cols = collect_fragment(
                self.env, act, self.obs, T, self.rng, self.ep_returns,
                self.completed, bufs=self._bufs, cast=self._cast)
            last_value = module(torch.from_numpy(self.obs))[1].numpy()
            batch = fragment_batch(kind, cols, last_value, self.gamma,
                                   self.lambda_)
        completed, self.completed = self.completed, []
        t1 = time.time()
        self._last_sample_end = t1
        info = {
            "weights_version": self._weights_version,
            "produce_start": t0,
            "produce_end": t1,
            "idle_s": idle,
            "busy_s": t1 - t0,
            "env_steps": T * self.env.num_envs,
        }
        return batch, completed, info


@ray_tpu_torch.remote
class OffPolicyRolloutWorker:
    """CPU actor collecting RAW TRANSITIONS for the replay-family
    algorithms (DQN/SAC/TD3) — the Ape-X shape: rollout actors feed a
    learner-owned replay buffer (reference: ApexDQN's distributed replay
    actors + the learner-thread consumer,
    rllib/execution/multi_gpu_learner_thread.py:20).

    The per-algorithm piece is an ``act_factory`` (cloudpickled closure)
    returning ``(module, act)``: ``module`` takes the learner's state
    dicts, and ``act(obs, generator, explore_arg) -> action`` (CPU
    tensors) is the policy — epsilon for DQN, noise scale for TD3, unused
    for SAC's stochastic policy.  Torch runs on one intra-op thread."""

    def __init__(self, env_name, act_factory_blob, worker_index: int,
                 num_envs: int, fragment_length: int, seed: int,
                 env_parallelism: str = "serial",
                 env_workers: Optional[int] = None):
        import cloudpickle

        torch.set_num_threads(1)
        self.env = VectorEnv(lambda: make_py_env(env_name),
                             num_envs, seed + worker_index * 1000,
                             mode=env_parallelism, num_workers=env_workers)
        self.device = resolve_device("cpu")
        module, self._act = cloudpickle.loads(act_factory_blob)()
        self.module = module.to(self.device).eval()
        self._has_weights = False
        self.fragment_length = fragment_length
        self.rng = torch.Generator(device=self.device).manual_seed(
            seed + worker_index)
        # The replay-family networks are flat MLPs: pixel obs flatten to
        # float32 vectors (a conv replay stack would need obs-shaped
        # buffers end to end).
        self.obs = self._flat(self.env.reset_all())
        self.ep_returns = np.zeros(num_envs)
        self.completed: List[float] = []
        self._bufs = FragmentBuffers(fragment_length)
        self._weights_version = 0

    def _flat(self, obs: np.ndarray) -> np.ndarray:
        return obs.astype(np.float32).reshape(obs.shape[0], -1)

    def set_weights(self, state_dict, version: int = 0):
        self.module.load_state_dict(state_dict)
        self._has_weights = True
        self._weights_version = int(version)
        return version

    def ping(self):
        return "ok"

    def pid(self):
        return os.getpid()

    def close(self):
        """Close the envs (see ``RolloutWorker.close``)."""
        self.env.close()
        return True

    def sample(self, explore_arg: float = 0.0):
        """T steps of raw transitions: column dict + completed returns."""
        if not self._has_weights:
            raise RuntimeError("OffPolicyRolloutWorker.sample before any "
                               "set_weights")
        T = self.fragment_length
        bufs = self._bufs
        obs = self.obs
        with torch.inference_mode():
            for t in range(T):
                action = self._act(torch.from_numpy(obs), self.rng,
                                   explore_arg).numpy()
                next_obs, reward, done, _ = self.env.step(action)
                next_flat = self._flat(next_obs)
                bufs.store("obs", t, obs)
                bufs.store("actions", t, action)
                bufs.store("rewards", t, reward)
                bufs.store("next_obs", t, next_flat)
                bufs.store("dones", t, done)
                self.ep_returns += reward
                for i, d in enumerate(done):
                    if d:
                        self.completed.append(float(self.ep_returns[i]))
                        self.ep_returns[i] = 0.0
                obs = next_flat
        self.obs = obs
        cols = bufs.arrays()
        n = cols["rewards"].size
        act_arr = cols["actions"]
        batch = {
            "obs": cols["obs"].reshape(n, -1),
            "actions": act_arr.reshape(n, -1)
            if act_arr.ndim > 2 else act_arr.reshape(n),
            "rewards": cols["rewards"].reshape(n).astype(np.float32),
            "next_obs": cols["next_obs"].reshape(n, -1),
            "dones": cols["dones"].reshape(n).astype(np.float32),
        }
        completed, self.completed = self.completed, []
        return batch, completed

    def sample_publish(self, explore_arg: float = 0.0, gamma: float = 0.99,
                       n_step: int = 1):
        """The replay-plane publish path: collect one fragment, fold
        n-step returns HERE (the worker owns the contiguity), publish the
        columns to the object plane with one put_many burst, and return
        only the refs + metadata — transition bytes never ride the RPC
        reply, so the learner's insert path is pure ref bookkeeping."""
        batch, completed = self.sample(explore_arg)
        if n_step > 1:
            from ray_tpu_torch.rllib.execution.replay_plane import \
                compute_nstep

            batch = compute_nstep(batch, len(self.ep_returns), gamma,
                                  n_step)
        cols = sorted(batch)
        refs = ray_tpu_torch.put_many([np.ascontiguousarray(batch[c])
                                       for c in cols])
        meta = {"n": len(batch["rewards"]),
                "version": self._weights_version}
        return dict(zip(cols, refs)), meta, completed


class WorkerSet:
    """Rollout workers behind a fault-tolerant actor manager (reference:
    FaultTolerantActorManager, rllib/utils/actor_manager.py:157 — health
    tracking, probing, and replacement of workers whose restart budget is
    exhausted; num_healthy_workers surfaces in training metrics)."""

    MAX_FAILURES_BEFORE_RECREATE = 2

    def __init__(self, config, module_spec, worker_factory=None):
        self._config = config
        self._module_spec = module_spec
        self._worker_factory = worker_factory
        n = max(1, config.num_rollout_workers)
        self.workers = [self._make_worker(i) for i in range(n)]
        self._failures = [0] * n
        self._weights_ref = None
        self._weights_version = 0
        self.num_replaced = 0

    def _make_worker(self, i: int):
        if self._worker_factory is not None:
            return self._worker_factory(i)
        c = self._config
        return RolloutWorker.options(max_restarts=1).remote(
            c.env, self._module_spec, i, c.num_envs_per_worker,
            c.rollout_fragment_length, c.gamma, c.lambda_, c.seed,
            env_parallelism=getattr(c, "env_parallelism", "serial"),
            env_workers=getattr(c, "num_env_workers", None))

    def _foreach(self, make_future) -> List[Tuple[int, Any]]:
        """The ONE fault-handling loop: run `make_future(worker)` on every
        worker, harvest results, reset the failure counter on success,
        count failures (replacing exhausted workers), and restore weights
        on replacements AFTER the harvest so one cold-starting actor never
        stalls the others' results.  Returns (index, result) pairs for the
        successes."""
        futures = [(i, make_future(w)) for i, w in enumerate(self.workers)]
        out: List[Tuple[int, Any]] = []
        replaced: List[int] = []
        # Fast path: one batched gather (a single resolve round trip for
        # every store-resident result) — the per-future harvest below only
        # runs when a worker actually failed, to attribute the failure.
        if len(futures) > 1:
            try:
                values = ray_tpu_torch.get_many([f for _, f in futures],
                                                timeout=_ROUND_S)
                for (i, _f), v in zip(futures, values):
                    out.append((i, v))
                    self._failures[i] = 0
                return out
            except ray_tpu_torch.exceptions.RayTpuError:
                out = []
        for i, f in futures:
            try:
                out.append((i, ray_tpu_torch.get(f, timeout=_ROUND_S)))
                self._failures[i] = 0
            except ray_tpu_torch.exceptions.RayTpuError:
                if self._count_failure(i):
                    replaced.append(i)
        self._restore_weights(replaced)
        return out

    def _count_failure(self, i: int) -> bool:
        """Count a strike; past the budget, replace the actor entirely
        (the reference recreates workers the restart policy gave up on).
        Returns True when the worker was replaced."""
        self._failures[i] += 1
        if self._failures[i] < self.MAX_FAILURES_BEFORE_RECREATE:
            return False  # the actor restart policy gets another chance
        try:
            ray_tpu_torch.kill(self.workers[i])
        except Exception:
            pass
        self.workers[i] = self._make_worker(i)
        self.num_replaced += 1
        # One strike from another replacement until a success resets it —
        # a worker that can't restore its weights must not look healthy.
        self._failures[i] = self.MAX_FAILURES_BEFORE_RECREATE - 1
        return True

    def _restore_weights(self, indices: List[int]):
        if not indices or self._weights_ref is None:
            return
        futures = [(i, self.workers[i].set_weights.remote(
            self._weights_ref, self._weights_version)) for i in indices]
        for i, f in futures:
            try:
                # Bounded: a replacement stuck starting (e.g. rescheduled
                # off a dead node) must strike out, not hang the sampler
                # forever (GetTimeoutError is a RayTpuError).
                ray_tpu_torch.get(f, timeout=60.0)
                self._failures[i] = 0
            except ray_tpu_torch.exceptions.RayTpuError:
                self._count_failure(i)

    def report_failure_index(self, i: int) -> bool:
        """Index-addressed failure report (the streaming sampler's path —
        robust to the handle at slot i having been replaced already).
        Returns True when the report replaced the worker."""
        if self._count_failure(i):
            self._restore_weights([i])
            return True
        return False

    def sync_weights(self, state_dict):
        # One put, N borrowers — the object-store broadcast pattern the
        # reference uses for sync_weights.  Blocking form (lockstep
        # callers); the streaming plane uses broadcast_weights_async.
        self._weights_version += 1
        self._weights_ref = ray_tpu_torch.put(state_dict)
        v = self._weights_version
        self._foreach(lambda w: w.set_weights.remote(self._weights_ref, v))
        return v

    def broadcast_weights_async(self, state_dict) -> int:
        """Versioned non-blocking broadcast: ONE object-store put for the
        version, then a fire-and-forget ``set_weights`` per worker.  The
        actor mailbox is FIFO, so each worker applies the new version at
        its next fragment boundary ("pull between fragments") — the
        driver never waits.  Failures surface through the sample path
        (and replacements are re-seeded from ``_weights_ref``)."""
        self._weights_version += 1
        self._weights_ref = ray_tpu_torch.put(state_dict)
        for w in self.workers:
            w.set_weights.remote(self._weights_ref, self._weights_version)
        return self._weights_version

    @property
    def weights_version(self) -> int:
        return self._weights_version

    def probe_health(self) -> int:
        """Ping every worker; failures feed the replacement policy.
        Returns the number of currently-healthy workers."""
        return len(self._foreach(lambda w: w.ping.remote()))

    @property
    def num_healthy_workers(self) -> int:
        return sum(1 for n in self._failures if n == 0)

    def publish_sync(self, *args) -> List[Tuple[Any, Dict[str, Any], list]]:
        """sample_sync's replay-plane sibling: every worker publishes its
        fragment to the object plane and replies (refs, meta, completed)
        — same dead-worker tolerance, no payload bytes in the replies."""
        return [r for _i, r in self._foreach(
            lambda w: w.sample_publish.remote(*args))]

    def sample_sync(self, *args) -> Tuple[List[Any], List[float]]:
        """synchronous_parallel_sample (reference:
        rllib/execution/rollout_ops.py:21) with dead-worker tolerance.
        Extra args forward to the workers' sample() (the off-policy
        workers take the exploration argument per call)."""
        batches, returns = [], []
        for _i, (b, eps) in self._foreach(
                lambda w: w.sample.remote(*args)):
            batches.append(b)
            returns.extend(eps)
        return batches, returns

    def stop(self):
        """Close every worker's envs (for at most ``_CLOSE_S``: a dead or
        stuck worker is killed all the same), then kill the workers."""
        try:
            ray_tpu_torch.get_many([w.close.remote() for w in self.workers],
                                   timeout=_CLOSE_S)
        except ray_tpu_torch.exceptions.RayTpuError:
            pass
        for w in self.workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:
                pass
