"""The port's MinAtar and classic envs against the JAX package's, on the CPU.

``Breakout-MinAtar-v0``, ``SpaceInvaders-MinAtar-v0``, ``Pendulum-v1`` and
``StatelessCartPole-v1``: the same states (numpy, from a seed or built by
hand) and actions go through one JAX ``vector_step`` and the port's
``step_core``.  SpaceInvaders' step is random (enemy fire): the port's
``step_core`` takes the draws as inputs, and the test hands it the very
uniforms and Gumbel noise that JAX's ``bernoulli`` and ``categorical``
draw from the same keys, so its transition is checked bitwise too.

Where ``done`` is false the integer state, boards, reward, done and
observation must be bitwise equal; Pendulum's and CartPole's floats agree
within ``FLOAT_TOL`` (the same fp32 arithmetic, with another sin/cos).
Where ``done`` is true, reward and done must be equal and the port's
``step`` hands back its own reset.  Then one random-policy rollout per
env: the port's mean episode return against JAX's, within the two
rollouts' sampling error."""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.rllib.env import jax_envs
from ray_tpu_torch.rllib.env import torch_envs

# |port - jax| <= FLOAT_TOL * (1 + |jax|): one fp32 step of the same
# formulas; sin/cos and the floored remainder may round an ulp apart,
# which is ~1e-7 relative (8 * 2^-24 = 4.8e-7 on thdot near the clamp).
FLOAT_TOL = 1e-6
KEY = jax.random.PRNGKey(0)
SI = torch_envs.SpaceInvaders


@functools.lru_cache(maxsize=None)
def _jax_step(name):
    env = jax_envs.make_jax_env(name)
    return jax.jit(functools.partial(jax_envs.vector_step, env))

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tiny tensors gain nothing from more,
    and under the suite's parallel workers extra threads only contend for
    the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)



def _jax(name, states, actions):
    out = _jax_step(name)({k: jnp.asarray(v) for k, v in states.items()},
                          jnp.asarray(actions), KEY)
    st, obs, reward, done, _ = jax.tree_util.tree_map(np.asarray, out)
    return st, obs, reward, done


@jax.jit
def _invader_draws(n):
    """The uniforms and noise SpaceInvaders.step draws from each env's key
    of ``vector_step(..., KEY)``: ``bernoulli(k_fire, 0.2)`` compares
    ``uniform(k_fire)``; ``categorical(k_col, logits)`` is the argmax of
    ``logits + gumbel(k_col, (100,))``."""
    def one(key):
        k_fire, k_col = jax.random.split(key)
        return (jax.random.uniform(k_fire, (), jnp.float32),
                jax.random.gumbel(k_col, (100,), jnp.float32))

    return jax.vmap(one)(jax.random.split(KEY, n.shape[0]))


def _port(name, states, actions, draws=()):
    env = torch_envs.make_torch_env(name)
    ts = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in states.items()}
    ta = torch.from_numpy(np.asarray(actions))
    stepped, reward, done = env.step_core(
        ts, ta, *[torch.from_numpy(np.array(d)) for d in draws])
    return env, ts, ta, stepped, reward.numpy(), done.numpy()


def _compare(name, states, actions, floats=()):
    """Port ``step_core`` against JAX ``vector_step``; returns the port's
    (stepped state, reward, done)."""
    n = len(actions)
    draws = (tuple(np.asarray(x) for x in _invader_draws(jnp.zeros(n)))
             if name.startswith("SpaceInvaders") else ())
    jst, jobs, jrew, jdone = _jax(name, states, actions)
    env, ts, ta, stepped, rew, done = _port(name, states, actions, draws)
    np.testing.assert_array_equal(done, jdone)
    assert rew.dtype == np.float32
    live = ~done
    obs = env._obs(stepped).numpy()
    assert obs.dtype == jobs.dtype
    for k, v in stepped.items():
        assert v.dtype == {np.dtype(bool): torch.bool,
                           np.dtype(np.int32): torch.int32,
                           np.dtype(np.float32): torch.float32}[
                               jst[k].dtype], k
        if k in floats:
            np.testing.assert_allclose(v.numpy()[live], jst[k][live],
                                       rtol=FLOAT_TOL, atol=FLOAT_TOL,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(v.numpy()[live], jst[k][live], k)
    if floats:
        np.testing.assert_allclose(rew, jrew, rtol=FLOAT_TOL, atol=FLOAT_TOL)
        np.testing.assert_allclose(obs[live], jobs[live], rtol=FLOAT_TOL,
                                   atol=FLOAT_TOL)
    else:
        np.testing.assert_array_equal(rew, jrew)
        np.testing.assert_array_equal(obs[live], jobs[live])
    # The port's step: same reward and done where it draws nothing, its
    # own reset where done, the render of what it hands back.
    st, sobs, srew, sdone, _ = env.step(ts, ta,
                                        torch.Generator().manual_seed(0))
    if not draws:
        np.testing.assert_array_equal(srew.numpy(), rew)
        np.testing.assert_array_equal(sdone.numpy(), done)
    assert torch.equal(sobs, env._obs(st))
    d = sdone
    fresh = env.reset_state(int(d.sum()), torch.Generator().manual_seed(0),
                            "cpu")
    assert (st["t"][d] == 0).all()
    for k, v in fresh.items():
        if v.dtype != torch.float32 and k not in ("ball_x", "last_x", "dx"):
            assert torch.equal(st[k][d], v), k
    return stepped, rew, done


# ---- Breakout-MinAtar ------------------------------------------------------

def _breakout(n=1, **over):
    s = {"paddle_x": 5, "ball_x": 5, "ball_y": 6, "dx": 1, "dy": 1,
         "last_x": 4, "last_y": 5, "t": 100}
    s.update({k: v for k, v in over.items() if k != "bricks"})
    out = {k: np.full(n, v, np.int32) for k, v in s.items()}
    bricks = over.get("bricks")
    out["bricks"] = (np.ones((n, 3, 10), bool) if bricks is None
                     else np.broadcast_to(bricks, (n, 3, 10)).copy())
    return out


def _one_brick(row, col):
    b = np.zeros((3, 10), bool)
    b[row, col] = True
    return b


BREAKOUT_CASES = [
    ("left wall", _breakout(ball_x=0, dx=-1), 0),
    ("right wall", _breakout(ball_x=9, dx=1), 0),
    ("ceiling", _breakout(ball_y=0, dy=-1, ball_x=3, dx=-1), 1),
    ("brick hit, bottom row", _breakout(ball_y=4, dy=-1), 0),
    ("brick hit, top row", _breakout(ball_y=2, dy=-1, ball_x=8), 2),
    ("brick hit at the left wall", _breakout(ball_y=4, dy=-1, ball_x=0,
                                             dx=-1), 0),
    ("no brick there", _breakout(ball_y=4, dy=-1,
                                 bricks=~_one_brick(2, 6)), 0),
    ("last brick cleared", _breakout(ball_y=4, dy=-1,
                                     bricks=_one_brick(2, 6)), 0),
    ("paddle catch", _breakout(ball_y=8, dy=1, ball_x=4, paddle_x=5), 0),
    ("paddle miss", _breakout(ball_y=8, dy=1, ball_x=4, paddle_x=1), 0),
    ("paddle moves into the ball", _breakout(ball_y=8, dy=1, ball_x=5,
                                             paddle_x=5), 2),
    ("paddle at the left limit", _breakout(paddle_x=0), 1),
    ("paddle at the right limit", _breakout(paddle_x=9), 2),
    ("t = max_steps - 1", _breakout(t=torch_envs.Breakout.max_steps - 1), 0),
]


def _concat(states):
    return {k: np.concatenate([s[k] for s in states]) for k in states[0]}


@pytest.mark.parametrize("name,state,action", BREAKOUT_CASES,
                         ids=[c[0] for c in BREAKOUT_CASES])
def test_breakout_minatar_case_matches_jax(name, state, action):
    stepped, rew, done = _compare("Breakout-MinAtar-v0", state,
                                  np.array([action]))
    if name.startswith("brick hit") or name == "last brick cleared":
        assert rew[0] == 1.0 and stepped["dy"][0] == 1
    if name == "no brick there":
        assert rew[0] == 0.0
    if name == "last brick cleared":
        assert stepped["bricks"].all()
    if name in ("paddle miss", "t = max_steps - 1"):
        assert done[0]
    if name in ("paddle catch", "paddle moves into the ball"):
        assert not done[0] and stepped["dy"][0] == -1


def _random_breakout(rng, n):
    s = {"paddle_x": rng.integers(0, 10, n), "ball_x": rng.integers(0, 10, n),
         "ball_y": rng.integers(0, 9, n), "dx": rng.choice([-1, 1], n),
         "dy": rng.choice([-1, 1], n), "last_x": rng.integers(0, 10, n),
         "last_y": rng.integers(0, 10, n), "t": rng.integers(0, 1000, n)}
    s = {k: v.astype(np.int32) for k, v in s.items()}
    s["bricks"] = rng.random((n, 3, 10)) < rng.random((n, 1, 1))
    return s


def test_breakout_minatar_random_states_match_jax():
    rng = np.random.default_rng(0)
    states = _concat([_random_breakout(rng, 1024)]
                     + [c[1] for c in BREAKOUT_CASES])
    actions = np.concatenate([rng.integers(0, 3, 1024),
                              [c[2] for c in BREAKOUT_CASES]])
    _, rew, done = _compare("Breakout-MinAtar-v0", states, actions)
    assert 0 < done.sum() < len(done) and 0 < rew.sum()


def test_breakout_minatar_reset_renders_as_jax():
    env = torch_envs.Breakout()
    st, obs = env.reset(64, torch.Generator().manual_seed(0), "cpu")
    assert obs.shape == (64, 10, 10, 4) and obs.dtype == torch.float32
    assert set(st["dx"].tolist()) == {-1, 1}
    assert torch.equal(st["last_x"], st["ball_x"])
    jobs = jax.vmap(jax_envs.Breakout()._obs)(
        {k: jnp.asarray(v.numpy()) for k, v in st.items()})
    np.testing.assert_array_equal(obs.numpy(), np.asarray(jobs))


# ---- SpaceInvaders-MinAtar -------------------------------------------------

def _invaders(n=1, aliens=None, fbul=(), ebul=(), **over):
    s = {"pos": 5, "dir": 1, "move_t": 0, "shot_t": 0, "t": 100}
    s.update(over)
    out = {k: np.full(n, v, np.int32) for k, v in s.items()}
    if aliens is None:
        aliens = np.zeros((10, 10), bool)
        aliens[1:5, 2:8] = True
    out["aliens"] = np.broadcast_to(aliens, (n, 10, 10)).copy()
    for name, cells in (("fbul", fbul), ("ebul", ebul)):
        board = np.zeros((n, 10, 10), bool)
        for r, c in cells:
            board[:, r, c] = True
        out[name] = board
    return out


def _block(rows, cols):
    a = np.zeros((10, 10), bool)
    a[rows, cols] = True
    return a


INVADER_CASES = [
    ("fire", _invaders(), 3),
    ("fire during cooldown", _invaders(shot_t=2), 3),
    ("fire at the left limit", _invaders(pos=0), 3),
    ("alien shot", _invaders(fbul=[(5, 4)]), 0),
    ("two aliens shot", _invaders(fbul=[(5, 4), (5, 6)]), 2),
    ("last alien shot: the wave respawns", _invaders(
        aliens=_block(slice(2, 3), slice(4, 5)), fbul=[(3, 4)]), 0),
    ("march sideways", _invaders(move_t=3), 0),
    ("march at the right wall", _invaders(
        aliens=_block(slice(1, 5), slice(4, 10)), move_t=3), 0),
    ("march at the left wall", _invaders(
        aliens=_block(slice(1, 5), slice(0, 6)), dir=-1, move_t=3), 1),
    ("aliens reach the bottom", _invaders(
        aliens=_block(slice(5, 9), slice(4, 10)), move_t=3), 0),
    ("enemy bullet on the cannon", _invaders(ebul=[(8, 5)]), 0),
    ("cannon steps under a bullet", _invaders(ebul=[(8, 6)]), 2),
    ("enemy bullet leaves the board", _invaders(ebul=[(9, 2)]), 0),
    ("t = max_steps - 1", _invaders(t=SI.max_steps - 1), 0),
]


@pytest.mark.parametrize("name,state,action", INVADER_CASES,
                         ids=[c[0] for c in INVADER_CASES])
def test_space_invaders_case_matches_jax(name, state, action):
    stepped, rew, done = _compare("SpaceInvaders-MinAtar-v0", state,
                                  np.array([action]))
    if name == "fire":
        assert stepped["fbul"][0, 8, 5] and stepped["shot_t"][0] == 4
    if name == "fire during cooldown":
        assert not stepped["fbul"].any() and stepped["shot_t"][0] == 1
    if name.startswith("alien shot") or name.startswith("last alien"):
        assert rew[0] == 1.0
    if name == "two aliens shot":
        assert rew[0] == 2.0
    if name.startswith("last alien"):
        assert stepped["aliens"][0].sum() == 24
    if name.startswith("march at"):
        assert stepped["dir"][0] == -state["dir"][0]
    if name in ("aliens reach the bottom", "enemy bullet on the cannon",
                "cannon steps under a bullet", "t = max_steps - 1"):
        assert done[0]


def _random_invaders(rng, n):
    s = {"pos": rng.integers(0, 10, n), "dir": rng.choice([-1, 1], n),
         "move_t": rng.integers(0, 4, n), "shot_t": rng.integers(0, 5, n),
         "t": rng.integers(0, 1000, n)}
    s = {k: v.astype(np.int32) for k, v in s.items()}
    aliens = rng.random((n, 10, 10)) < rng.random((n, 1, 1))
    aliens[:, 9] = False  # an alien on the bottom row has already won
    aliens[~aliens.reshape(n, -1).any(1), 1, 4] = True
    s["aliens"] = aliens
    s["fbul"] = rng.random((n, 10, 10)) < 0.05
    s["ebul"] = rng.random((n, 10, 10)) < 0.05
    return s


def test_space_invaders_random_states_match_jax():
    rng = np.random.default_rng(1)
    states = _concat([_random_invaders(rng, 1024)]
                     + [c[1] for c in INVADER_CASES])
    actions = np.concatenate([rng.integers(0, 4, 1024),
                              [c[2] for c in INVADER_CASES]])
    stepped, rew, done = _compare("SpaceInvaders-MinAtar-v0", states,
                                  actions)
    assert 0 < done.sum() < len(done) and 0 < rew.sum()
    # Enemy fire was drawn: bullets on row 1 or below that no bullet
    # above could have moved into.
    before = torch.from_numpy(states["ebul"])
    moved = torch.cat([torch.zeros_like(before[:, :1]), before[:, :-1]], 1)
    assert (stepped["ebul"] & ~moved).any()


def test_space_invaders_port_draws_fire_at_the_rate():
    """The port's own draws: enemy fire in 20% of steps, each bullet under
    an alive alien (after the march)."""
    env = SI()
    gen = torch.Generator().manual_seed(0)
    st = env.reset_state(4096, gen, "cpu")
    st["move_t"][:] = 1  # no march this step
    stepped, _, _ = env.step_core(st, torch.zeros(4096, dtype=torch.long),
                                  *env.draws(4096, gen, "cpu"))
    fired = stepped["ebul"].flatten(1).any(1)
    assert abs(fired.float().mean().item() - 0.2) < 0.02
    assert not (stepped["ebul"] & ~st["aliens"]).any()


# ---- Pendulum and StatelessCartPole ----------------------------------------

def test_pendulum_matches_jax_on_negative_angles():
    rng = np.random.default_rng(2)
    n = 1024
    th = rng.uniform(-3 * np.pi, 3 * np.pi, n).astype(np.float32)
    th[:64] = -rng.uniform(np.pi - 1e-3, np.pi + 1e-3, 64)  # the wrap
    th[64:72] = [-np.pi, np.pi, -3 * np.pi, 3 * np.pi, 0, -1e-7, -5.0, -7.0]
    states = {"th": th,
              "thdot": rng.uniform(-8, 8, n).astype(np.float32),
              "t": rng.integers(0, 200, n).astype(np.int32)}
    states["t"][-8:] = 199
    actions = rng.integers(0, 3, n)
    _, rew, done = _compare("Pendulum-v1", states, actions,
                            floats=("th", "thdot"))
    assert done[-8:].all() and 0 < done.sum() < n
    assert (rew <= 0).all() and rew.min() < -9


def test_pendulum_wrap_is_a_floored_modulo():
    th = torch.tensor([-7.0, -np.pi - 0.5, -0.1, 0.1, 7.0])
    got = torch.remainder(th + np.pi, 2 * np.pi) - np.pi
    want = np.asarray((jnp.asarray(th.numpy()) + jnp.pi) % (2 * jnp.pi)
                      - jnp.pi)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=FLOAT_TOL)
    assert (got >= -np.pi).all() and (got < np.pi).all()


def test_stateless_cartpole_matches_jax():
    rng = np.random.default_rng(3)
    n = 512
    core = rng.uniform(-0.25, 0.25, (n, 4)).astype(np.float32)
    core[: n // 8, 0] = rng.uniform(2.35, 2.45, n // 8)
    states = {"core": core, "t": rng.integers(0, 500, n).astype(np.int32)}
    states["t"][-4:] = 499
    _, _, done = _compare("StatelessCartPole-v1", states,
                          rng.integers(0, 2, n), floats=("core",))
    assert done[-4:].all()
    env = torch_envs.make_torch_env("StatelessCartPole-v1")
    st, obs = env.reset(4, torch.Generator().manual_seed(0), "cpu")
    assert obs.shape == (4, 2)
    assert torch.equal(obs, st["core"][:, [0, 2]])


# ---- random-policy rollouts ------------------------------------------------

def _jax_returns(name, n, steps):
    env = jax_envs.make_jax_env(name)

    @jax.jit
    def run(key):
        states, _ = jax_envs.vector_reset(env, key, n)

        def body(carry, _):
            states, key, ret = carry
            key, ka, ks = jax.random.split(key, 3)
            acts = jax.random.randint(ka, (n,), 0, env.num_actions)
            states, _, r, d, _ = jax_envs.vector_step(env, states, acts, ks)
            ret = ret + r
            return (states, key, jnp.where(d, 0.0, ret)), (ret, d)

        _, (rets, dones) = jax.lax.scan(
            body, (states, key, jnp.zeros(n)), None, length=steps)
        return rets, dones

    rets, dones = map(np.asarray, run(jax.random.PRNGKey(5)))
    return rets[dones]


def _port_returns(name, n, steps):
    env = torch_envs.make_torch_env(name)
    gen = torch.Generator().manual_seed(5)
    st, _ = torch_envs.vector_reset(env, gen, n, "cpu")
    ret = torch.zeros(n)
    out = []
    for _ in range(steps):
        a = torch.randint(0, env.num_actions, (n,), generator=gen)
        st, _, r, d, _ = torch_envs.vector_step(env, st, a, gen)
        ret = ret + r
        out.append(ret[d])
        ret = torch.where(d, 0.0, ret)
    return torch.cat(out).numpy()


@pytest.mark.parametrize("name,n,steps,lo,hi", [
    ("Breakout-MinAtar-v0", 64, 400, 0.0, 2.0),
    ("SpaceInvaders-MinAtar-v0", 64, 400, 2.0, 12.0),
    ("Pendulum-v1", 64, 400, -1600.0, -800.0),
    ("StatelessCartPole-v1", 64, 200, 15.0, 35.0),
], ids=["breakout", "space_invaders", "pendulum", "stateless_cartpole"])
def test_random_policy_returns_match_jax(name, n, steps, lo, hi):
    """Mean return of the episodes a uniform random policy completes: the
    port's within 4 standard errors of JAX's (different draws, the same
    distribution), both inside the env's known range."""
    want, got = _jax_returns(name, n, steps), _port_returns(name, n, steps)
    assert len(want) > 30 and len(got) > 30
    se = np.sqrt(want.var() / len(want) + got.var() / len(got))
    assert abs(got.mean() - want.mean()) <= 4 * se + 1e-6, (
        got.mean(), want.mean(), se)
    assert lo < want.mean() < hi and lo < got.mean() < hi


def test_registry_refuses_the_continuous_pendulum():
    """The registry is the JAX package's, the continuous pendulum
    included since the SAC family came (its steps are held to JAX's in
    tests/test_torch_sac_td3.py); an unknown name still raises."""
    assert set(torch_envs.REGISTRY) == set(jax_envs.REGISTRY)
    env = torch_envs.make_torch_env("PendulumContinuous-v1")
    assert isinstance(env, torch_envs.PendulumContinuous)
    assert env.num_actions is None and env.action_dim == 1
    with pytest.raises(ValueError, match="unknown torch env"):
        torch_envs.make_torch_env("PendulumContinuous-v2")
