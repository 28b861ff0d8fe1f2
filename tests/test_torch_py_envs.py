"""The port's numpy envs for the actor path against the JAX package's.

``ray_tpu_torch/rllib/env/py_envs.py`` is a copy of
``ray_tpu/rllib/env/py_envs.py``: the same seeds and actions must give the
same transitions bit for bit, for ``PyCartPole``, for ``VectorEnv`` in its
serial, thread and subprocess modes, for ``GymEnvAdapter`` on gymnasium's
CartPole-v1 and LunarLander-v3, and for ``PixelPreprocess`` over a seeded
fake-frame env.  The port's subprocess mode names its segment ``rttp_``
and its ``close()`` reaps the children."""
import numpy as np
import pytest

from ray_tpu.rllib.env import py_envs as jenvs
from ray_tpu_torch.rllib.env import py_envs as tenvs

MODES = ("serial", "thread", "subprocess")


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def _cartpole_run(mod, steps=300, seed=7):
    env = mod.PyCartPole(seed)
    out = [env.reset()]
    rng = np.random.default_rng(1)
    for _ in range(steps):
        obs, r, term, trunc, _ = env.step(int(rng.integers(2)))
        out.append((obs, r, term, trunc))
        if term or trunc:
            out.append(env.reset())
    return out


def test_py_cartpole_transitions_bit_for_bit():
    ref, port = _cartpole_run(jenvs), _cartpole_run(tenvs)
    assert len(ref) == len(port) > 300  # episodes ended and reset
    for a, b in zip(ref, port):
        if isinstance(a, tuple):
            _same(a[0], b[0])
            assert a[1:] == b[1:]
        else:
            _same(a, b)


def _vector_run(mod, mode, steps=30, num_envs=5, seed=11):
    v = mod.VectorEnv(lambda: mod.PyCartPole(), num_envs, seed=seed,
                      mode=mode, num_workers=2)
    try:
        out = [v.reset_all()]
        rng = np.random.default_rng(3)
        for _ in range(steps):
            obs, rew, done, _ = v.step(rng.integers(0, 2, num_envs))
            out.append((obs, rew, done))
        return out
    finally:
        v.close()


@pytest.mark.parametrize("mode", MODES)
def test_vector_env_bit_for_bit_in_each_mode(mode):
    """Each mode of the port against the same mode of the JAX package,
    and against the port's serial mode (the modes are step-equivalent)."""
    ref = _vector_run(jenvs, mode)
    port = _vector_run(tenvs, mode)
    serial = _vector_run(tenvs, "serial")
    for trajectory in (ref, serial):
        _same(trajectory[0], port[0])
        for s, t in zip(trajectory[1:], port[1:]):
            for a, b in zip(s, t):
                _same(a, b)
    assert any(d.any() for _, _, d in port[1:])  # auto-resets ran


def test_subprocess_segment_is_the_ports_and_close_reaps():
    v = tenvs.VectorEnv(lambda: tenvs.PyCartPole(), 4, seed=0,
                        mode="subprocess", num_workers=2)
    v.reset_all()
    assert v._shm.name.startswith("rttp_"), v._shm.name
    procs = list(v._procs)
    assert len(procs) == 2 and all(p.is_alive() for p in procs)
    v.close()
    for p in procs:
        assert not p.is_alive()


def test_resolve_mode_and_unknown_mode():
    assert tenvs._resolve_mode("thread", 8) == "thread"
    assert tenvs._resolve_mode("auto", 8) == jenvs._resolve_mode("auto", 8)
    assert tenvs._slice_indices(7, 3) == jenvs._slice_indices(7, 3)
    with pytest.raises(ValueError, match="unknown VectorEnv mode"):
        tenvs.VectorEnv(lambda: tenvs.PyCartPole(), 2, mode="fork")


def test_make_py_env_native_and_unknown():
    assert isinstance(tenvs.make_py_env("CartPole-v1", seed=0),
                      tenvs.PyCartPole)
    pytest.importorskip("gymnasium")
    with pytest.raises(Exception):
        tenvs.make_py_env("NoSuchEnv-v0")


@pytest.mark.parametrize("name", ["CartPole-v1", "LunarLander-v3"])
def test_gym_adapter_bit_for_bit(name):
    pytest.importorskip("gymnasium")
    if name.startswith("Lunar"):
        pytest.importorskip("Box2D")
    out = []
    for mod in (jenvs, tenvs):
        env = mod.GymEnvAdapter(name, seed=5)
        rng = np.random.default_rng(2)
        seq = [env.reset()]
        for _ in range(120):
            obs, r, term, trunc, _ = env.step(
                int(rng.integers(env.num_actions)))
            seq.append((obs, r, term, trunc))
            if term or trunc:
                seq.append(env.reset())
        out.append((seq, env.obs_dim, env.num_actions, env.obs_shape))
        env.close()
    (ref, *ref_dims), (port, *port_dims) = out
    assert ref_dims == port_dims
    assert len(ref) == len(port)
    for a, b in zip(ref, port):
        if isinstance(a, tuple):
            _same(a[0], b[0])
            assert a[1:] == b[1:]
        else:
            _same(a, b)


class _FakeFrames:
    """A seeded pixel env: random RGB frames of 60 x 48, reward = the
    action, episodes of 9 steps."""

    num_actions = 3
    obs_shape = (60, 48, 3)

    def __init__(self):
        self.rng = np.random.default_rng(0)
        self.t = 0

    def _frame(self):
        return self.rng.integers(0, 256, self.obs_shape, dtype=np.uint8)

    def reset(self, seed=None):
        if seed is not None:
            self.rng = np.random.default_rng(seed)
        self.t = 0
        return self._frame()

    def step(self, action):
        self.t += 1
        return self._frame(), float(action), self.t >= 9, False, {}


@pytest.mark.parametrize("grayscale", [True, False])
def test_pixel_preprocess_matches(grayscale):
    out = []
    for mod in (jenvs, tenvs):
        inner = _FakeFrames()
        if not grayscale:
            inner.obs_shape = (60, 48, 1)
        env = mod.PixelPreprocess(inner, size=20, stack=3, skip=2,
                                  grayscale=grayscale)
        seq = [env.reset(seed=4)]
        for t in range(12):
            obs, r, term, trunc, _ = env.step(t % 3)
            seq.append((obs, r, term, trunc))
            if term:
                seq.append(env.reset())
        out.append(seq)
    assert out[0][0].shape == (20, 20, 3) and out[0][0].dtype == np.uint8
    for a, b in zip(*out):
        if isinstance(a, tuple):
            _same(a[0], b[0])
            assert a[1:] == b[1:]
        else:
            _same(a, b)


def test_pixel_preprocess_refusals_match():
    for mod in (jenvs, tenvs):
        with pytest.raises(ValueError, match="obs_shape"):
            mod.PixelPreprocess(tenvs.PyCartPole(0))
        rgb = _FakeFrames()
        with pytest.raises(ValueError, match="grayscale=False"):
            mod.PixelPreprocess(rgb, grayscale=False)
