"""The port's batched envs against the JAX package's, on the CPU.

The same states (numpy, from a seed or built by hand) and actions go
through one JAX ``vector_step`` and the port's ``step_core``.  The port
does not reproduce JAX's PRNG bits, so the auto-reset draws differ: where
``done`` is false, the integer state, reward, done and uint8 frames must
be bitwise equal (CartPole's float state within 1e-6, the same fp32
arithmetic with another sin/cos); where ``done`` is true, reward and done
must be equal and the port's ``step`` must hand back its own reset (in the
reset ranges, its frame the render of it)."""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.rllib.env import jax_envs
from ray_tpu_torch.rllib.env import torch_envs

CARTPOLE_ATOL = 1e-6
B = torch_envs.Breakout84


@functools.lru_cache(maxsize=None)
def _jax_step(name):
    env = jax_envs.make_jax_env(name)
    return jax.jit(functools.partial(jax_envs.vector_step, env))


def _jax(name, states, actions):
    out = _jax_step(name)({k: jnp.asarray(v) for k, v in states.items()},
                          jnp.asarray(actions), jax.random.PRNGKey(0))
    st, obs, reward, done, _ = jax.tree_util.tree_map(np.asarray, out)
    return st, obs, reward, done


def _port(name, states, actions):
    env = torch_envs.make_torch_env(name)
    ts = {k: torch.from_numpy(v) for k, v in states.items()}
    ta = torch.from_numpy(actions)
    stepped, reward, done = env.step_core(ts, ta)
    st, obs, reward2, done2, _ = env.step(ts, ta, torch.Generator()
                                          .manual_seed(0))
    assert torch.equal(reward, reward2) and torch.equal(done, done2)
    return env, stepped, st, obs, reward.numpy(), done.numpy()


def _breakout_state(n=1, **overrides):
    s = {"px": 40, "bx": 40, "by": 50, "dx": 1, "dy": 2, "lx": 39, "ly": 48,
         "t": 100}
    s.update({k: v for k, v in overrides.items() if k != "bricks"})
    out = {k: np.full(n, v, np.int32) for k, v in s.items()}
    bricks = overrides.get("bricks")
    out["bricks"] = (np.ones((n, 6, 12), bool) if bricks is None
                     else np.broadcast_to(bricks, (n, 6, 12)).copy())
    return out


def _concat(states):
    return {k: np.concatenate([s[k] for s in states]) for k in states[0]}


def _one_brick(row, col):
    b = np.zeros((6, 12), bool)
    b[row, col] = True
    return b


# (name, state, action): the cases of tests/test_atari84.py and more.
CASES = [
    ("left wall", _breakout_state(bx=0, dx=-2), 0),
    ("left wall, 1 px out", _breakout_state(bx=1, dx=-2), 1),
    ("right wall", _breakout_state(bx=82, dx=2), 2),
    ("right wall, 1 px out", _breakout_state(bx=81, dx=2), 0),
    ("ceiling", _breakout_state(by=1, dy=-2), 0),
    ("ceiling, at 0", _breakout_state(by=0, dy=-2, bx=0, dx=-1), 1),
    ("brick hit", _breakout_state(bx=10, by=12 + 18 + 1, dx=0, dy=-2), 0),
    ("brick hit, top row", _breakout_state(bx=50, by=14, dx=2, dy=-2), 0),
    ("no brick left there", _breakout_state(
        bx=10, by=31, dx=0, dy=-2, bricks=~_one_brick(5, 1)), 0),
    ("paddle catch", _breakout_state(px=36, bx=40, by=79, dy=2), 0),
    ("paddle catch, left edge", _breakout_state(px=40, bx=37, by=79, dx=1,
                                                dy=2), 1),
    ("paddle miss", _breakout_state(px=0, bx=60, by=79, dy=2), 0),
    ("paddle moves into the ball", _breakout_state(px=47, bx=45, by=80,
                                                   dx=0, dy=2), 1),
    ("last brick cleared", _breakout_state(
        bx=10, by=31, dx=0, dy=-2, bricks=_one_brick(5, 1)), 0),
    ("t = max_steps - 1", _breakout_state(t=B.max_steps - 1), 2),
    ("paddle at the right limit", _breakout_state(px=76), 2),
    ("paddle at the left limit", _breakout_state(px=0), 1),
]


def _random_breakout(rng, n):
    density = rng.random((n, 1, 1))
    s = {"px": rng.integers(0, 77, n), "bx": rng.integers(0, 83, n),
         "by": rng.integers(0, 83, n), "dx": rng.choice([-2, -1, 1, 2], n),
         "dy": rng.choice([-2, 2], n), "lx": rng.integers(0, 83, n),
         "ly": rng.integers(0, 83, n), "t": rng.integers(0, 2500, n)}
    s = {k: v.astype(np.int32) for k, v in s.items()}
    s["bricks"] = rng.random((n, 6, 12)) < density
    return s


def _check_reset_breakout(env, st, obs, done):
    d = torch.from_numpy(done)
    if not d.any():
        return
    bx = st["bx"][d]
    assert ((bx >= 8) & (bx < 74)).all() and torch.equal(st["lx"][d], bx)
    assert ((st["px"][d] >= 0) & (st["px"][d] < 76)).all()
    assert set(st["dx"][d].tolist()) <= {-2, -1, 1, 2}
    assert (st["by"][d] == 40).all() and (st["ly"][d] == 38).all()
    assert (st["dy"][d] == 2).all() and (st["t"][d] == 0).all()
    assert st["bricks"][d].all()
    assert torch.equal(obs[d], env._obs(st)[d])


def _compare_breakout(states, actions):
    jst, jobs, jrew, jdone = _jax("Breakout-Atari84-v0", states, actions)
    env, stepped, st, obs, rew, done = _port("Breakout-Atari84-v0", states,
                                             actions)
    np.testing.assert_array_equal(done, jdone)
    np.testing.assert_array_equal(rew, jrew)
    assert rew.dtype == np.float32 and obs.dtype == torch.uint8
    live = ~done
    for k, v in st.items():
        assert v.dtype == {"bricks": torch.bool}.get(k, torch.int32), k
        np.testing.assert_array_equal(v.numpy()[live], jst[k][live], k)
        np.testing.assert_array_equal(stepped[k].numpy()[live],
                                      jst[k][live], k)
    np.testing.assert_array_equal(obs.numpy()[live], jobs[live])
    _check_reset_breakout(env, st, obs, done)
    return stepped, rew, done


@pytest.mark.parametrize("name,state,action", CASES,
                         ids=[c[0] for c in CASES])
def test_breakout84_case_matches_jax(name, state, action):
    stepped, rew, done = _compare_breakout(state, np.array([action]))
    if name.startswith("brick hit") or name == "last brick cleared":
        assert rew[0] == 1.0 and stepped["dy"][0] == 2
    if name == "last brick cleared":
        assert stepped["bricks"].all()  # the wall respawned
    if name in ("paddle miss", "t = max_steps - 1"):
        assert done[0]
    if name.startswith("paddle catch") or name.startswith("paddle moves"):
        assert not done[0] and stepped["dy"][0] == -2


def test_breakout84_random_states_match_jax():
    rng = np.random.default_rng(0)
    states = _concat([_random_breakout(rng, 512)]
                     + [c[1] for c in CASES])
    actions = np.concatenate([rng.integers(0, 3, 512),
                              [c[2] for c in CASES]])
    _, rew, done = _compare_breakout(states, actions)
    assert 0 < done.sum() < len(done) and 0 < rew.sum()


def test_breakout84_reset_renders_as_jax():
    """The port's reset states rendered by both envs: same frames."""
    env = torch_envs.Breakout84()
    st, obs = torch_envs.vector_reset(env, torch.Generator().manual_seed(0),
                                      64, "cpu")
    assert obs.shape == (64, 84, 84, 4) and obs.dtype == torch.uint8
    _check_reset_breakout(env, st, obs, np.ones(64, bool))
    jobs = jax.vmap(jax_envs.Breakout84()._obs)(
        {k: jnp.asarray(v.numpy()) for k, v in st.items()})
    np.testing.assert_array_equal(obs.numpy(), np.asarray(jobs))
    o = obs[0].numpy()
    assert (o[:, :, 0] > 0).sum() == 2 * B.PW
    assert (o[:, :, 1] > 0).sum() == 4
    assert (o[:, :, 3] > 0).sum() == 72 * B.BRICK_H * B.BRICK_W
    assert set(np.unique(obs.numpy()).tolist()) == {0, 255}


def _random_cartpole(rng, n):
    core = rng.uniform(-0.25, 0.25, (n, 4)).astype(np.float32)
    core[: n // 8, 0] = rng.uniform(2.35, 2.45, n // 8)  # at the x limit
    core[n // 8: n // 4, 2] = rng.uniform(0.2, 0.22, n // 8)  # angle limit
    t = rng.integers(0, CARTPOLE_T_MAX, n).astype(np.int32)
    t[-4:] = CARTPOLE_T_MAX - 1
    return {"core": core, "t": t}


CARTPOLE_T_MAX = torch_envs.CartPole.max_steps


def test_cartpole_matches_jax():
    rng = np.random.default_rng(1)
    states = _random_cartpole(rng, 512)
    actions = rng.integers(0, 2, 512)
    jst, jobs, jrew, jdone = _jax("CartPole-v1", states, actions)
    env, stepped, st, obs, rew, done = _port("CartPole-v1", states, actions)
    np.testing.assert_array_equal(done, jdone)
    np.testing.assert_array_equal(rew, jrew)
    assert 0 < done.sum() < len(done) and done[-4:].all()
    live = ~done
    np.testing.assert_allclose(st["core"].numpy()[live], jst["core"][live],
                               rtol=0, atol=CARTPOLE_ATOL)
    np.testing.assert_allclose(obs.numpy()[live], jobs[live], rtol=0,
                               atol=CARTPOLE_ATOL)
    np.testing.assert_array_equal(st["t"].numpy()[live], jst["t"][live])
    d = torch.from_numpy(done)
    assert (st["core"][d].abs() <= 0.05).all() and (st["t"][d] == 0).all()
    assert st["core"].dtype == torch.float32 and st["t"].dtype == torch.int32


def test_random_rollout_scores_and_resets():
    """As tests/test_atari84.py's: 8 envs, 2000 random steps."""
    env = torch_envs.make_torch_env("Breakout-Atari84-v0")
    gen = torch.Generator().manual_seed(0)
    st, _ = torch_envs.vector_reset(env, gen, 8, "cpu")
    rewards = dones = 0
    for _ in range(2000):
        a = torch.randint(0, 3, (8,), generator=gen)
        st, _, rew, done, _ = torch_envs.vector_step(env, st, a, gen)
        rewards += rew.sum().item()
        dones += done.sum().item()
    assert dones > 50          # episodes end and reset
    assert 0 < rewards < 500   # random play hits some bricks, not hundreds


def test_registry():
    assert isinstance(torch_envs.make_torch_env("CartPole-v1"),
                      torch_envs.CartPole)
    with pytest.raises(ValueError, match="unknown torch env"):
        torch_envs.make_torch_env("Pong-v0")
