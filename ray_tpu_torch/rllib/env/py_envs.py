"""Python-API envs for CPU actor rollouts (gym-style contract, since gym is
not a dependency).  Mirrors the reference's env layer (rllib/env/*.py) in
miniature: single env + VectorEnv.  NumPy mirrors of the on-device
dynamics, so that actor-path and Anakin-path PPO train on identical MDPs.

A copy of ``ray_tpu/rllib/env/py_envs.py`` (numpy only), which the port may
not import.  What differs: the subprocess mode's observation buffer comes
from the port's object-store ``SegmentPool`` (fallback segments are named
``rttp_venv_...``), its env threads are ``rttp-env-<i>``, and each env
subprocess hides the card and runs torch on one intra-op thread before it
unpickles the env factory (which may import the port, and with it
torch)."""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np


class PyCartPole:
    """CartPole-v1 (numpy). API: reset(seed) -> obs; step(a) -> (obs, r,
    terminated, truncated, info)."""

    num_actions = 2
    obs_dim = 4

    def __init__(self, seed: Optional[int] = None):
        self.rng = np.random.default_rng(seed)
        self.state = None
        self.t = 0

    def reset(self, seed: Optional[int] = None):
        if seed is not None:
            self.rng = np.random.default_rng(seed)
        self.state = self.rng.uniform(-0.05, 0.05, 4)
        self.t = 0
        return self.state.copy()

    def step(self, action: int):
        x, x_dot, theta, theta_dot = self.state
        force = 10.0 if action == 1 else -10.0
        costheta, sintheta = np.cos(theta), np.sin(theta)
        temp = (force + 0.05 * theta_dot ** 2 * sintheta) / 1.1
        thetaacc = (9.8 * sintheta - costheta * temp) / (
            0.5 * (4.0 / 3.0 - 0.1 * costheta ** 2 / 1.1))
        xacc = temp - 0.05 * thetaacc * costheta / 1.1
        x += 0.02 * x_dot
        x_dot += 0.02 * xacc
        theta += 0.02 * theta_dot
        theta_dot += 0.02 * thetaacc
        self.state = np.array([x, x_dot, theta, theta_dot])
        self.t += 1
        terminated = bool(abs(x) > 2.4 or abs(theta) > 0.2095)
        truncated = self.t >= 500
        return self.state.copy(), 1.0, terminated, truncated, {}


PY_REGISTRY = {"CartPole-v1": PyCartPole}


class GymEnvAdapter:
    """Bridge to gymnasium (reference: rllib's gym env integration,
    rllib/env/wrappers/ + algorithm_config.environment(str)): wraps any
    gymnasium env with a Discrete action space and flattenable Box
    observations into the py-env contract the actor-path rollout stack
    speaks (reset(seed)->obs, step(a)->(obs, r, terminated, truncated,
    info))."""

    def __init__(self, name: str, seed: Optional[int] = None, **make_kwargs):
        import gymnasium

        self.env = gymnasium.make(name, **make_kwargs)
        self._check_spaces(name, self.env)
        self._next_seed = seed

    def _check_spaces(self, name: str, env) -> None:
        """Validate + record the env's spaces (split out so wrappers and
        tests can run the contract check on an arbitrary env object)."""
        from gymnasium import spaces

        space = env.observation_space
        if not isinstance(space, spaces.Box):
            # Discrete/MultiDiscrete obs have a shape too, but flattening
            # a state INDEX to one float is a near-meaningless encoding —
            # reject instead of silently training on it.
            raise ValueError(
                f"gym env {name!r}: only Box observation spaces are "
                f"bridgeable (one-hot/embed discrete states in a wrapper "
                f"first), got {space}")
        self.obs_dim = int(np.prod(space.shape))
        # Pixel envs keep their [H, W, C] shape (and uint8 dtype) so the
        # CNN trunk + PixelPreprocess stack see raw frames; flat envs
        # flatten to float32 as before.
        self.obs_shape = (tuple(space.shape) if len(space.shape) == 3
                          else None)
        act = env.action_space
        if isinstance(act, spaces.Discrete):
            self.num_actions = int(act.n)
            self.action_dim = None
        elif isinstance(act, spaces.Box):
            # Continuous control: the SAC/TD3-family actor path drives
            # gym Box actions (reference: the torch algos on MuJoCo/
            # classic-control continuous envs).
            self.num_actions = None
            self.action_dim = int(np.prod(act.shape))
            self.action_low = np.asarray(act.low, np.float32).reshape(-1)
            self.action_high = np.asarray(act.high, np.float32).reshape(-1)
        else:
            raise ValueError(
                f"gym env {name!r}: only Discrete or Box action spaces "
                f"are bridgeable, got {act}")

    def _flat(self, obs) -> np.ndarray:
        if self.obs_shape is not None:
            return np.asarray(obs)  # raw frame, dtype preserved
        return np.asarray(obs, np.float32).reshape(-1)

    def reset(self, seed: Optional[int] = None):
        if seed is None:
            seed = self._next_seed
        self._next_seed = None  # gymnasium reseeds only when asked
        obs, _info = self.env.reset(seed=seed)
        return self._flat(obs)

    def step(self, action):
        if self.num_actions is not None:
            action = int(action)
        else:
            action = np.asarray(action, np.float32).reshape(
                self.env.action_space.shape)
        obs, reward, terminated, truncated, info = self.env.step(action)
        return (self._flat(obs), float(reward), bool(terminated),
                bool(truncated), info)

    def close(self):
        self.env.close()


class PixelPreprocess:
    """The DeepMind Atari preprocessing stack over any pixel py-env
    (reference: rllib/env/wrappers/atari_wrappers.py — MaxAndSkipEnv,
    WarpFrame 84x84 grayscale, FrameStack 4; fire-reset is ALE-specific
    and applied only when the inner env exposes a FIRE action meaning).

    Wraps a py-env-contract object whose observations are raw [H, W, C]
    frames; emits uint8 [size, size, stack] observations — the exact
    input tensor the NatureCNN trunk (and the reference's atari-ppo
    config) consumes."""

    def __init__(self, env, size: int = 84, stack: int = 4, skip: int = 4,
                 grayscale: bool = True):
        if getattr(env, "obs_shape", None) is None:
            raise ValueError("PixelPreprocess needs a pixel env exposing "
                             "obs_shape=[H, W, C]")
        if not grayscale and env.obs_shape[-1] != 1:
            # Silently dropping color channels is worse than refusing:
            # the output shape would look valid while the agent trains on
            # the red channel only.
            raise ValueError("grayscale=False requires single-channel "
                             f"frames, got C={env.obs_shape[-1]}")
        self.env = env
        self.size, self.stack, self.skip = size, stack, skip
        self.grayscale = grayscale
        self.num_actions = env.num_actions
        self.action_dim = getattr(env, "action_dim", None)
        self.obs_shape = (size, size, stack)
        self.obs_dim = size * size * stack
        h, w = env.obs_shape[0], env.obs_shape[1]
        # Area-style nearest resize indices (no cv2 in this image).
        self._rows = (np.arange(size) * h // size).astype(np.int64)
        self._cols = (np.arange(size) * w // size).astype(np.int64)
        self._frames = None

    def _warp(self, frame: np.ndarray) -> np.ndarray:
        if self.grayscale and frame.ndim == 3 and frame.shape[-1] == 3:
            frame = (frame[..., 0] * 0.299 + frame[..., 1] * 0.587
                     + frame[..., 2] * 0.114)
        elif frame.ndim == 3:
            frame = frame[..., 0]
        return frame[self._rows[:, None], self._cols].astype(np.uint8)

    def _emit(self) -> np.ndarray:
        return np.stack(self._frames, axis=-1)

    def reset(self, seed: Optional[int] = None) -> np.ndarray:
        obs = self.env.reset(seed)
        f = self._warp(np.asarray(obs))
        self._frames = [f] * self.stack
        return self._emit()

    def step(self, action):
        total, terminated, truncated, info = 0.0, False, False, {}
        prev_raw, raw = None, None
        for _ in range(self.skip):
            prev_raw = raw  # frame from the PREVIOUS inner step
            raw, r, terminated, truncated, info = self.env.step(action)
            total += r
            if terminated or truncated:
                break
        raw = np.asarray(raw)
        if prev_raw is not None:
            # Max-pool the last two raw frames (ALE flicker removal:
            # sprites drawn on alternate frames survive the skip).
            raw = np.maximum(raw, np.asarray(prev_raw))
        self._frames = self._frames[1:] + [self._warp(raw)]
        return self._emit(), float(total), terminated, truncated, info

    def close(self):
        if hasattr(self.env, "close"):
            self.env.close()


def wrap_pixel(name: str, size: int = 84, stack: int = 4, skip: int = 4,
               seed: Optional[int] = None, **make_kwargs):
    """Gym pixel env → DeepMind-preprocessed py env (the actor-path
    analogue of the on-device Atari84 envs)."""
    return PixelPreprocess(GymEnvAdapter(name, seed, **make_kwargs),
                           size=size, stack=stack, skip=skip)


def make_py_env(name: str, seed: Optional[int] = None):
    """Native registry first; anything else is resolved through the
    gymnasium bridge (so `.environment("Acrobot-v1")` in actor mode just
    works when gymnasium is installed)."""
    if callable(name):
        return name()
    if name in PY_REGISTRY:
        return PY_REGISTRY[name](seed)
    try:
        import gymnasium  # noqa: F401
    except ImportError:
        raise ValueError(
            f"unknown env {name!r} (native registry: {list(PY_REGISTRY)}; "
            f"install gymnasium for the gym bridge)") from None
    return GymEnvAdapter(name, seed)


def _step_one(env, action):
    """One env step with the vector contract: scalar actions cast to int,
    auto-reset on termination.  The ONE copy of the per-env semantics, so
    serial/thread/subprocess modes are step-equivalent by construction."""
    o, r, term, trunc, info = env.step(
        int(action) if np.ndim(action) == 0 else action)
    done = term or trunc
    if done:
        o = env.reset()
    return o, r, done, info


def _resolve_mode(mode: str, num_envs: int) -> str:
    if mode != "auto":
        return mode
    import os

    # Parallel stepping only pays when there are cores to step on and
    # enough envs to amortize the per-step fan-out.
    if (os.cpu_count() or 1) >= 4 and num_envs >= 4:
        return "subprocess"
    return "serial"


def _subproc_env_main(conn, env_fn_blob: bytes, indices, num_total: int,
                      seed: int):
    """Child process of a subprocess-mode VectorEnv: owns a slice of envs,
    steps them on command, and writes observations straight into the
    parent's shared-memory obs buffer (zero-copy hand-back; rewards/dones
    are tiny and ride the pipe reply)."""
    import os
    import sys

    # Env children step numpy: they must open no CUDA context and run no
    # torch intra-op pool of their own (under load a pool per process
    # slows every one of them many times over), whether torch came in
    # with the parent's main module, the env factory or the envs.
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    os.environ["OMP_NUM_THREADS"] = "1"
    import cloudpickle
    import numpy as np

    env_fn = cloudpickle.loads(env_fn_blob)
    envs = [env_fn() for _ in indices]
    if "torch" in sys.modules:
        sys.modules["torch"].set_num_threads(1)
    probe = None
    for e, gi in zip(envs, indices):
        o = e.reset(seed + gi)
        if probe is None:
            probe = np.asarray(o)
    conn.send(("meta", tuple(probe.shape), probe.dtype.str))
    shm, obs_view = None, None
    try:
        while True:
            try:
                msg = conn.recv()
            except (EOFError, OSError):
                return  # parent died: exit quietly
            cmd = msg[0]
            if cmd == "attach":
                from multiprocessing import shared_memory

                shm = shared_memory.SharedMemory(name=msg[1])
                # NO untrack here: a spawn child shares the parent's
                # resource-tracker daemon, so unregistering would strip
                # the parent's registration and make its eventual
                # unlink() a tracker KeyError.  The attach-side register
                # dedups into the parent's entry.
                obs_view = np.ndarray((num_total,) + tuple(probe.shape),
                                      dtype=np.dtype(msg[2]), buffer=shm.buf)
                conn.send(("ok",))
            elif cmd == "reset":
                for e, gi in zip(envs, indices):
                    obs_view[gi] = e.reset()
                conn.send(("ok",))
            elif cmd == "step":
                actions = msg[1]
                rews, dones, infos = [], [], []
                for a, e, gi in zip(actions, envs, indices):
                    o, r, done, info = _step_one(e, a)
                    obs_view[gi] = o
                    rews.append(r)
                    dones.append(done)
                    infos.append(info)
                conn.send((np.asarray(rews, np.float32),
                           np.asarray(dones), infos))
            elif cmd == "close":
                conn.send(("ok",))
                return
    finally:
        for e in envs:
            if hasattr(e, "close"):
                try:
                    e.close()
                except Exception:
                    pass
        if obs_view is not None:
            del obs_view
        if shm is not None:
            try:
                shm.close()
            except Exception:
                pass


def _slice_indices(num_envs: int, num_workers: int) -> List[List[int]]:
    """Contiguous env-index slices, one per worker (serial order preserved
    inside each slice so trajectories match the serial mode exactly)."""
    base, rem = divmod(num_envs, num_workers)
    out, start = [], 0
    for w in range(num_workers):
        n = base + (1 if w < rem else 0)
        out.append(list(range(start, start + n)))
        start += n
    return [s for s in out if s]


class VectorEnv:
    """N python envs stepped together (reference: rllib/env/vector_env.py
    + the subprocess fan-out of vector_env.py's remote modes).

    ``mode``:

    - ``"serial"`` (default): step envs in a python loop in this process.
    - ``"thread"``: persistent worker threads each own a contiguous slice
      of envs and step them concurrently, writing into preallocated
      [N, ...] buffers.  Pays off when env.step releases the GIL
      (numpy/C-backed dynamics); GIL-bound envs see no speedup but
      identical trajectories.
    - ``"subprocess"``: one child process per slice — true parallelism for
      GIL-bound envs (Box2D, ALE).  Observations come back through a
      preallocated shared-memory buffer (a recycled SegmentPool segment,
      the object plane's allocator), so the per-step IPC payload is
      one tiny action message + reward/done reply per worker.
    - ``"auto"``: subprocess when the host has >= 4 cores and >= 4 envs,
      else serial.

    All modes are step-equivalent: same seeds => identical trajectories
    (guarded by tests/test_torch_py_envs.py).
    """

    def __init__(self, env_fn, num_envs: int, seed: int = 0,
                 mode: str = "serial", num_workers: Optional[int] = None):
        self.num_envs = num_envs
        self.mode = _resolve_mode(mode, num_envs)
        if self.mode not in ("serial", "thread", "subprocess"):
            raise ValueError(f"unknown VectorEnv mode {mode!r}")
        import os

        if num_workers is None:
            num_workers = min(num_envs,
                              max(2, (os.cpu_count() or 2) // 2))
        self.num_workers = max(1, min(int(num_workers), num_envs))
        self.envs: List[Any] = []
        if self.mode == "subprocess":
            self._setup_subprocess(env_fn, seed)
        else:
            self.envs = [env_fn() for _ in range(num_envs)]
            for i, e in enumerate(self.envs):
                e.reset(seed + i)
            if self.mode == "thread":
                self._setup_threads()

    # ---- serial ---------------------------------------------------------
    def _step_serial(self, actions):
        obs, rews, dones, infos = [], [], [], []
        for e, a in zip(self.envs, actions):
            o, r, done, info = _step_one(e, a)
            obs.append(o)
            rews.append(r)
            dones.append(done)
            infos.append(info)
        return (np.stack(obs), np.asarray(rews, np.float32),
                np.asarray(dones), infos)

    # ---- threads --------------------------------------------------------
    def _setup_threads(self):
        import threading

        self._slices = _slice_indices(self.num_envs, self.num_workers)
        self._cv = threading.Condition()
        self._epoch = 0
        self._cmd: Optional[str] = None
        self._actions = None
        self._pending = 0
        self._err: Optional[BaseException] = None
        self._obs_buf = None  # allocated on first step/reset (shape probe)
        self._rew_buf = np.zeros(self.num_envs, np.float32)
        self._done_buf = np.zeros(self.num_envs, bool)
        self._info_buf: List[dict] = [{} for _ in range(self.num_envs)]
        self._threads = [
            threading.Thread(target=self._thread_main, args=(sl,),
                             name=f"rttp-env-{i}", daemon=True)
            for i, sl in enumerate(self._slices)
        ]
        for t in self._threads:
            t.start()

    def _ensure_obs_buf(self, probe: np.ndarray):
        if self._obs_buf is None:
            self._obs_buf = np.zeros((self.num_envs,) + probe.shape,
                                     probe.dtype)

    def _thread_main(self, indices: List[int]):
        local_epoch = 0
        while True:
            with self._cv:
                while self._epoch == local_epoch:
                    self._cv.wait()
                local_epoch = self._epoch
                cmd, actions = self._cmd, self._actions
            if cmd == "close":
                return
            try:
                if cmd == "reset":
                    for gi in indices:
                        self._obs_buf[gi] = self.envs[gi].reset()
                else:
                    for gi in indices:
                        o, r, done, info = _step_one(self.envs[gi],
                                                     actions[gi])
                        self._obs_buf[gi] = o
                        self._rew_buf[gi] = r
                        self._done_buf[gi] = done
                        self._info_buf[gi] = info
            except BaseException as e:  # noqa: BLE001 — surfaced to caller
                with self._cv:
                    self._err = e
                    self._pending -= 1
                    self._cv.notify_all()
                continue
            with self._cv:
                self._pending -= 1
                self._cv.notify_all()

    def _run_threads(self, cmd: str, actions=None):
        with self._cv:
            self._cmd, self._actions = cmd, actions
            self._pending = len(self._threads)
            self._err = None
            self._epoch += 1
            self._cv.notify_all()
            while self._pending > 0:
                self._cv.wait()
            if self._err is not None:
                raise self._err

    def _step_thread(self, actions):
        if self._obs_buf is None:
            raise RuntimeError(
                "thread-mode VectorEnv: call reset_all() before step() "
                "(the first reset defines the obs buffer shape)")
        self._run_threads("step", np.asarray(actions))
        return (self._obs_buf.copy(), self._rew_buf.copy(),
                self._done_buf.copy(), list(self._info_buf))

    # ---- subprocesses ---------------------------------------------------
    def _setup_subprocess(self, env_fn, seed: int):
        import multiprocessing as mp

        import cloudpickle

        self._slices = _slice_indices(self.num_envs, self.num_workers)
        ctx = mp.get_context("spawn")
        blob = cloudpickle.dumps(env_fn)
        self._conns, self._procs = [], []
        for sl in self._slices:
            parent, child = ctx.Pipe()
            p = ctx.Process(target=_subproc_env_main,
                            args=(child, blob, sl, self.num_envs, seed),
                            daemon=True)
            p.start()
            child.close()
            self._conns.append(parent)
            self._procs.append(p)
        metas = [self._recv(c) for c in self._conns]
        shape, dtype = tuple(metas[0][1]), np.dtype(metas[0][2])
        self._obs_shape, self._obs_dtype = shape, dtype
        nbytes = int(np.prod((self.num_envs,) + shape)) * dtype.itemsize
        self._shm, self._shm_pool_class, self._pool = \
            self._alloc_obs_segment(max(1, nbytes))
        self._obs_np = np.ndarray((self.num_envs,) + shape, dtype,
                                  buffer=self._shm.buf)
        self._obs_np[:] = 0
        for c in self._conns:
            c.send(("attach", self._shm.name, dtype.str))
        for c in self._conns:
            self._recv(c)

    @staticmethod
    def _alloc_obs_segment(nbytes: int):
        """Obs buffer segment: a recycled SegmentPool segment (pre-faulted,
        power-of-two class) when poolable, else a dedicated segment."""
        from multiprocessing import shared_memory

        from ray_tpu_torch._private.object_store import SegmentPool, note_owned

        pool = SegmentPool(max_bytes=2 * SegmentPool.MIN_CLASS + 2 * nbytes)
        acq = pool.acquire(nbytes)
        if acq is not None:
            shm, cls = acq
            return shm, cls, pool
        import os

        shm = shared_memory.SharedMemory(
            name=f"rttp_venv_{os.getpid()}_{id(pool) & 0xffffff:x}",
            create=True, size=nbytes)
        note_owned(shm)
        return shm, None, pool

    def _recv(self, conn):
        try:
            return conn.recv()
        except (EOFError, OSError) as e:
            raise RuntimeError(
                "VectorEnv subprocess died (env worker crashed or was "
                "killed)") from e

    def _step_subprocess(self, actions):
        actions = np.asarray(actions)
        for c, sl in zip(self._conns, self._slices):
            c.send(("step", actions[sl[0]: sl[-1] + 1]))
        rews = np.zeros(self.num_envs, np.float32)
        dones = np.zeros(self.num_envs, bool)
        infos: List[dict] = [{}] * self.num_envs
        for c, sl in zip(self._conns, self._slices):
            r, d, inf = self._recv(c)
            rews[sl[0]: sl[-1] + 1] = r
            dones[sl[0]: sl[-1] + 1] = d
            infos[sl[0]: sl[-1] + 1] = inf
        return self._obs_np.copy(), rews, dones, infos

    # ---- public API ------------------------------------------------------
    def reset_all(self) -> np.ndarray:
        if self.mode == "subprocess":
            for c in self._conns:
                c.send(("reset",))
            for c in self._conns:
                self._recv(c)
            return self._obs_np.copy()
        if self.mode == "thread":
            if self._obs_buf is None:
                # First reset_all runs inline: the first obs defines the
                # buffer shape/dtype.  Each env resets exactly once (same
                # RNG draws as serial mode).
                first = np.asarray(self.envs[0].reset())
                self._ensure_obs_buf(first)
                self._obs_buf[0] = first
                for gi in range(1, self.num_envs):
                    self._obs_buf[gi] = self.envs[gi].reset()
                return self._obs_buf.copy()
            self._run_threads("reset")
            return self._obs_buf.copy()
        return np.stack([e.reset() for e in self.envs])

    def step(self, actions) -> Tuple[np.ndarray, np.ndarray, np.ndarray, List[dict]]:
        if self.mode == "subprocess":
            return self._step_subprocess(actions)
        if self.mode == "thread":
            return self._step_thread(actions)
        return self._step_serial(actions)

    def close(self):
        if self.mode == "subprocess":
            for c in self._conns:
                try:
                    c.send(("close",))
                except (BrokenPipeError, OSError):
                    pass
            for p in self._procs:
                p.join(timeout=5.0)
                if p.is_alive():
                    p.terminate()
            for c in self._conns:
                try:
                    c.close()
                except Exception:
                    pass
            del self._obs_np
            from ray_tpu_torch._private.object_store import _unlink_quiet

            _unlink_quiet(self._shm)
            self._pool.close()
            return
        if self.mode == "thread":
            with self._cv:
                self._cmd = "close"
                self._epoch += 1
                self._cv.notify_all()
            for t in self._threads:
                t.join(timeout=5.0)
        for e in self.envs:
            if hasattr(e, "close"):
                e.close()
