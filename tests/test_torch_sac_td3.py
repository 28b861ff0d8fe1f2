"""The port's SAC, TD3 and DDPG (``ray_tpu_torch/rllib/algorithms/sac.py``,
``td3.py``) and the continuous pendulum against the JAX package's, fp32,
on numpy-seeded inputs and converted flax weights.

- ``PendulumContinuous``'s step against JAX's from the same states and
  actions: 1e-6;
- ``SquashedGaussianPolicy``'s mean, log-std, action and log-prob under
  the JAX key's noise, ``TwinQ``, ``DeterministicPolicy``: 1e-5 of scale;
- SAC's three losses and TD3's two (target noise passed in), and one
  update of each (DDPG's too) against the JAX learner's own
  ``_update_many`` (the JAX actor mode built without workers): losses at
  1e-5 of scale, parameters within ``tests/test_torch_ppo.py``'s
  ``SGD_ATOL`` (each package's own gradients through Adam);
- the reference's checks: the tanh-corrected log-prob against an fp64
  change of variables, DDPG = TD3 minus the three tricks, checkpoint
  round trips, Anakin smoke runs;
- the learning gates (Pendulum to -300 within 200 iterations) are
  ``slow``; chip_smoke's ``[sac]`` and ``[td3]`` run them on the card.
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.rllib.algorithms import sac as jsac
from ray_tpu.rllib.algorithms import td3 as jtd3
from ray_tpu.rllib.env import jax_envs
from ray_tpu.rllib.evaluation import worker_set as jws
from ray_tpu_torch.models.convert import replay_family_from_flax
from ray_tpu_torch.rllib.algorithms import sac as tsac
from ray_tpu_torch.rllib.algorithms import td3 as ttd3
from ray_tpu_torch.rllib.env import torch_envs

SCALE_TOL = 1e-5
ENV_TOL = 1e-6
# Each package's own gradients through one clip + Adam step
# (tests/test_torch_ppo.py's SGD_ATOL): Adam's first step is ~lr * sign(g),
# so elements whose gradient is rounding noise move up to ~lr apart in
# principle; measured far below this.
UPDATE_ATOL = 1e-6
OBS_DIM, ADIM, B = 3, 1, 64


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_scale_close(got, want, tol=SCALE_TOL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-6), (what, err)


def _state(module, tree):
    module.load_state_dict(replay_family_from_flax(jax.device_get(tree)))
    return module


def _batch(rng):
    return {"obs": rng.standard_normal((B, OBS_DIM)).astype(np.float32),
            "actions": rng.uniform(-2, 2, (B, ADIM)).astype(np.float32),
            "rewards": rng.standard_normal(B).astype(np.float32),
            "next_obs": rng.standard_normal((B, OBS_DIM)).astype(np.float32),
            "dones": (rng.random(B) < 0.2).astype(np.float32)}


def _port_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jax_batch(batch, lead=False):
    return {k: jnp.asarray(v)[None] if lead else jnp.asarray(v)
            for k, v in batch.items()}


def _noise(key, shape=(B, ADIM)):
    return torch.from_numpy(np.array(jax.random.normal(key, shape)))


# ---- the continuous pendulum ------------------------------------------------

def test_pendulum_continuous_step_matches_jax():
    rng = np.random.default_rng(3)
    n = 512
    states = {"th": rng.uniform(-3 * np.pi, 3 * np.pi, n).astype(np.float32),
              "thdot": rng.uniform(-8, 8, n).astype(np.float32),
              "t": rng.integers(0, 200, n).astype(np.int32)}
    states["t"][-8:] = 199
    # Torques inside and outside the bounds (the env clips them).
    actions = rng.uniform(-3, 3, (n, 1)).astype(np.float32)
    jenv = jax_envs.make_jax_env("PendulumContinuous-v1")
    jst, jobs, jrew, jdone, _ = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda s, a: jax_envs.vector_step(jenv, s, a, jax.random.PRNGKey(0))
    )({k: jnp.asarray(v) for k, v in states.items()}, jnp.asarray(actions)))
    env = torch_envs.make_torch_env("PendulumContinuous-v1")
    ts = {k: torch.from_numpy(v) for k, v in states.items()}
    stepped, rew, done = env.step_core(ts, torch.from_numpy(actions))
    np.testing.assert_array_equal(done.numpy(), jdone)
    assert done[-8:].all() and 0 < int(done.sum()) < n
    live = ~done.numpy()
    np.testing.assert_allclose(rew.numpy(), jrew, rtol=ENV_TOL, atol=ENV_TOL)
    for k in ("th", "thdot"):
        np.testing.assert_allclose(stepped[k].numpy()[live], jst[k][live],
                                   rtol=ENV_TOL, atol=ENV_TOL, err_msg=k)
    np.testing.assert_allclose(env._obs(stepped).numpy()[live], jobs[live],
                               rtol=ENV_TOL, atol=ENV_TOL)
    # The discrete parent still maps 0/1/2 to -2/0/+2.
    _, rew3, _ = torch_envs.Pendulum().step_core(
        ts, torch.from_numpy(rng.integers(0, 3, n)))
    assert rew3.shape == (n,)


# ---- the networks -----------------------------------------------------------

def _sac_nets(hiddens=(32, 32), seed=0):
    k_pi, k_q = jax.random.split(jax.random.PRNGKey(seed))
    jpi = jsac.SquashedGaussianPolicy(OBS_DIM, ADIM, hiddens,
                                      jnp.asarray(-2.0), jnp.asarray(2.0))
    jq = jsac.TwinQ(hiddens)
    pi_params = jpi.init(k_pi, jnp.zeros((1, OBS_DIM)))
    q_params = jq.init(k_q, jnp.zeros((1, OBS_DIM)), jnp.zeros((1, ADIM)))
    pi = _state(tsac.SquashedGaussianPolicy(OBS_DIM, ADIM, hiddens, -2.0,
                                            2.0), pi_params)
    q = _state(tsac.TwinQ(OBS_DIM, ADIM, hiddens), q_params)
    return (jpi, pi_params, pi), (jq, q_params, q)


def test_squashed_gaussian_policy_matches_jax():
    (jpi, params, pi), _ = _sac_nets()
    obs = np.random.default_rng(0).standard_normal(
        (B, OBS_DIM)).astype(np.float32) * 3
    key = jax.random.PRNGKey(5)
    jmu, jlog_std = jpi.dist_params(params, obs)
    ja, jlogp = jpi.sample(params, obs, key)
    with torch.no_grad():
        mu, log_std = pi.dist_params(torch.from_numpy(obs))
        a, logp = pi.sample(torch.from_numpy(obs), noise=_noise(key))
        mode = pi.mode(torch.from_numpy(obs))
    for got, want, what in ((mu, jmu, "mu"), (log_std, jlog_std, "log_std"),
                            (a, ja, "action"), (logp, jlogp, "logp"),
                            (mode, jpi.mode(params, obs), "mode")):
        assert_scale_close(got.numpy(), want, what=what)


def test_squashed_gaussian_logp_matches_numeric():
    """tests/test_sac_offline.py's check on the port: the tanh-corrected
    log-prob against an fp64 change of variables from the same
    pre-activation."""
    pi = tsac.SquashedGaussianPolicy(3, 1, (32,), -2.0, 2.0,
                                     torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    obs = torch.randn((16, 3), generator=gen)
    noise = torch.randn((16, 1), generator=gen)
    with torch.no_grad():
        a, logp = pi.sample(obs, noise=noise)
        mu, log_std = (v.double().numpy() for v in pi.dist_params(obs))
    assert a.shape == (16, 1) and logp.shape == (16,)
    assert bool((a >= -2.0).all()) and bool((a <= 2.0).all())
    eps = noise.double().numpy()
    pre = mu + np.exp(log_std) * eps
    np.testing.assert_allclose(a.double().numpy(), np.tanh(pre) * 2.0,
                               rtol=1e-5, atol=1e-5)
    gauss = (-0.5 * eps ** 2 - log_std - 0.5 * np.log(2 * np.pi))
    expect = gauss - np.log1p(-np.tanh(pre) ** 2 + 1e-300) - np.log(2.0)
    np.testing.assert_allclose(logp.numpy(), expect[:, 0], rtol=1e-3,
                               atol=1e-3)


def test_twin_q_and_deterministic_policy_match_jax():
    _, (jq, q_params, q) = _sac_nets()
    rng = np.random.default_rng(1)
    obs = rng.standard_normal((B, OBS_DIM)).astype(np.float32)
    act = rng.uniform(-2, 2, (B, ADIM)).astype(np.float32)
    with torch.no_grad():
        q1, q2 = q(torch.from_numpy(obs), torch.from_numpy(act))
    jq1, jq2 = jq.apply(q_params, obs, act)
    assert_scale_close(q1.numpy(), jq1, what="q1")
    assert_scale_close(q2.numpy(), jq2, what="q2")
    jpi = jtd3.DeterministicPolicy(ADIM, (32, 32), jnp.asarray(-2.0),
                                   jnp.asarray(2.0))
    params = jpi.init(jax.random.PRNGKey(2), jnp.zeros((1, OBS_DIM)))
    pi = _state(ttd3.DeterministicPolicy(OBS_DIM, ADIM, (32, 32), -2.0, 2.0),
                params)
    with torch.no_grad():
        got = pi(torch.from_numpy(obs * 4))
    assert_scale_close(got.numpy(), jpi.apply(params, obs * 4))
    assert_scale_close(pi.mode(torch.from_numpy(obs)).detach().numpy(),
                       jpi.mode(params, obs))


# ---- losses -----------------------------------------------------------------

def test_sac_losses_match_jax():
    from ray_tpu.rllib import SACConfig as JConfig
    from ray_tpu_torch.rllib import SACConfig

    (jpi, pi_params, pi), (jq, q_params, q) = _sac_nets()
    tq_params = jax.tree_util.tree_map(lambda p: p * 0.95, q_params)
    q_target = _state(tsac.TwinQ(OBS_DIM, ADIM, (32, 32)), tq_params)
    jq_loss, jpi_loss, jalpha_loss = jsac.make_sac_losses(
        jpi, jq, JConfig(), -1.0)
    q_loss, pi_loss, alpha_loss = tsac.make_sac_losses(
        pi, q, q_target, SACConfig(), -1.0)
    batch = _batch(np.random.default_rng(2))
    k_q, k_pi = jax.random.split(jax.random.PRNGKey(7))
    log_alpha = jnp.asarray(-0.3, jnp.float32)
    t_alpha = torch.tensor(-0.3)
    want_q = jq_loss(q_params, tq_params, pi_params, log_alpha,
                     _jax_batch(batch), k_q)
    want_pi, want_logp = jpi_loss(pi_params, q_params, log_alpha,
                                  _jax_batch(batch), k_pi)
    want_a = jalpha_loss(log_alpha, want_logp)
    with torch.no_grad():
        got_q = q_loss(t_alpha, _port_batch(batch), _noise(k_q))
        got_pi, got_logp = pi_loss(t_alpha, _port_batch(batch),
                                   _noise(k_pi))
        got_a = alpha_loss(t_alpha, got_logp)
    assert_scale_close(got_q.item(), want_q, what="critic")
    assert_scale_close(got_pi.item(), want_pi, what="actor")
    assert_scale_close(got_logp.numpy(), want_logp, what="logp")
    assert_scale_close(got_a.item(), want_a, what="alpha")


@pytest.mark.parametrize("algo", ["TD3", "DDPG"])
def test_td3_losses_match_jax(algo):
    from ray_tpu import rllib as jrllib
    from ray_tpu_torch import rllib

    jcfg, cfg = (getattr(m, f"{algo}Config")() for m in (jrllib, rllib))
    _, (jq, q_params, q) = _sac_nets()
    jpi = jtd3.DeterministicPolicy(ADIM, (32, 32), jnp.asarray(-2.0),
                                   jnp.asarray(2.0))
    pi_params = jpi.init(jax.random.PRNGKey(3), jnp.zeros((1, OBS_DIM)))
    tpi_params = jax.tree_util.tree_map(lambda p: p * 1.1, pi_params)
    tq_params = jax.tree_util.tree_map(lambda p: p * 0.95, q_params)

    def port_pi(tree):
        return _state(ttd3.DeterministicPolicy(OBS_DIM, ADIM, (32, 32),
                                               -2.0, 2.0), tree)

    pi, pi_target = port_pi(pi_params), port_pi(tpi_params)
    q_target = _state(tsac.TwinQ(OBS_DIM, ADIM, (32, 32)), tq_params)
    low, high = jnp.asarray(-2.0), jnp.asarray(2.0)
    jq_loss, jpi_loss = jtd3.make_td3_losses(jpi, jq, jcfg, (high - low) / 2,
                                             low, high)
    q_loss, pi_loss = ttd3.make_td3_losses(pi, pi_target, q, q_target, cfg)
    batch = _batch(np.random.default_rng(4))
    key = jax.random.PRNGKey(9)
    want_q = jq_loss(q_params, tq_params, tpi_params, _jax_batch(batch), key)
    want_pi = jpi_loss(pi_params, q_params, _jax_batch(batch))
    with torch.no_grad():
        got_q = q_loss(_port_batch(batch), _noise(key))
        got_pi = pi_loss(_port_batch(batch))
    assert_scale_close(got_q.item(), want_q, what="critic")
    assert_scale_close(got_pi.item(), want_pi, what="actor")


# ---- one update against the JAX learner -------------------------------------

class _NoWorkers:
    """Stands in for the JAX package's WorkerSet: the JAX actor mode is
    built for its update alone, with no cluster."""

    def __init__(self, *args, **kwargs):
        self.workers = []

    def sync_weights(self, params):
        return 1


def _jax_actor(monkeypatch, cls):
    pytest.importorskip("gymnasium")
    cfg = (cls().environment("Pendulum-v1").rollouts(num_rollout_workers=1)
           .training(model={"fcnet_hiddens": [32, 32]}))
    monkeypatch.setattr(jws, "WorkerSet", _NoWorkers)
    algo = cfg.build()
    monkeypatch.undo()
    return algo


def _assert_module(module, tree, what):
    want = replay_family_from_flax(jax.device_get(tree))
    for k, v in module.state_dict().items():
        np.testing.assert_allclose(v.detach().numpy(), want[k].numpy(),
                                   rtol=1e-6, atol=UPDATE_ATOL,
                                   err_msg=f"{what}.{k}")


def test_one_sac_update_matches_jax(monkeypatch):
    from ray_tpu.rllib import SACConfig as JConfig
    from ray_tpu_torch.rllib import SACConfig

    j = _jax_actor(monkeypatch, JConfig)
    cfg = SACConfig().training(model={"fcnet_hiddens": [32, 32]})
    learner = tsac.SACLearner(cfg.resources(device="cpu"), OBS_DIM, ADIM,
                              [-2.0], [2.0], torch.device("cpu"))
    _state(learner.pi, j._pi_params)
    _state(learner.q, j._q_params)
    _state(learner.q_target, j._q_target)
    batch = _batch(np.random.default_rng(5))
    key = jax.random.PRNGKey(11)
    (pi_p, q_p, qt_p, log_alpha, _, _, _, qls, pls, als) = j._update_many(
        j._pi_params, j._q_params, j._q_target, j._log_alpha, j._pi_opt,
        j._q_opt, j._a_opt, _jax_batch(batch, lead=True), key[None])
    k_q, k_pi = jax.random.split(key)
    m = learner.update(_port_batch(batch),
                       noise=[_noise(k_q), _noise(k_pi)])
    assert_scale_close(m["critic_loss"].item(), qls[0], what="critic")
    assert_scale_close(m["actor_loss"].item(), pls[0], what="actor")
    np.testing.assert_allclose(learner.log_alpha.item(), float(log_alpha),
                               rtol=0, atol=UPDATE_ATOL)
    _assert_module(learner.pi, pi_p, "pi")
    _assert_module(learner.q, q_p, "q")
    _assert_module(learner.q_target, qt_p, "q_target")


@pytest.mark.parametrize("name", ["TD3", "DDPG"])
def test_two_td3_updates_match_jax(monkeypatch, name):
    """Two updates: TD3's delayed policy step lands on the first only,
    DDPG's on both."""
    from ray_tpu import rllib as jrllib
    from ray_tpu_torch import rllib

    j = _jax_actor(monkeypatch, getattr(jrllib, f"{name}Config"))
    cfg = getattr(rllib, f"{name}Config")().training(
        model={"fcnet_hiddens": [32, 32]}).resources(device="cpu")
    learner = ttd3.TD3Learner(cfg, OBS_DIM, ADIM, [-2.0], [2.0],
                              torch.device("cpu"))
    for module, tree in ((learner.pi, j._pi_params),
                         (learner.pi_target, j._pi_target),
                         (learner.q, j._q_params),
                         (learner.q_target, j._q_target)):
        _state(module, tree)
    rng = np.random.default_rng(6)
    batches = [_batch(rng) for _ in range(2)]
    keys = jax.random.split(jax.random.PRNGKey(13), 2)
    (pi_p, pit_p, q_p, qt_p, _, _, count, qls, pls) = j._update_many(
        j._pi_params, j._pi_target, j._q_params, j._q_target, j._pi_opt,
        j._q_opt, j._count,
        {k: jnp.stack([jnp.asarray(b[k]) for b in batches])
         for k in batches[0]}, keys)
    for u, batch in enumerate(batches):
        m = learner.update(_port_batch(batch), noise=[_noise(keys[u])])
        assert_scale_close(m["critic_loss"].item(), qls[u], what="critic")
        assert ("actor_loss" in m) == (u % cfg.policy_delay == 0)
    assert learner.update_count == int(count) == 2
    assert learner.policy_updates == (1 if name == "TD3" else 2)
    for module, tree in ((learner.pi, pi_p), (learner.pi_target, pit_p),
                         (learner.q, q_p), (learner.q_target, qt_p)):
        _assert_module(module, tree, name)


# ---- the reference's checks ---------------------------------------------------

def test_ddpg_config_is_td3_minus_tricks():
    from ray_tpu_torch.rllib import DDPGConfig, TD3Config

    td3, ddpg = TD3Config(), DDPGConfig()
    assert td3.twin_q and td3.policy_delay == 2 and td3.smooth_target_policy
    assert not ddpg.twin_q and ddpg.policy_delay == 1 \
        and not ddpg.smooth_target_policy
    algo = (DDPGConfig().environment("PendulumContinuous-v1")
            .anakin(num_envs=8, unroll_length=4).resources(device="cpu")
            .build())
    algo.config.learning_starts = 32
    m = algo.train()
    assert math.isfinite(m["critic_loss"])
    # The policy is updated at every one of DDPG's updates.
    assert algo.learner.policy_updates == algo.learner.update_count == 8


def _anakin(cls, **over):
    cfg = (cls().environment("PendulumContinuous-v1")
           .anakin(num_envs=8, unroll_length=4).resources(device="cpu"))
    cfg.learning_starts, cfg.num_updates_per_iter = 32, 2
    for k, v in over.items():
        setattr(cfg, k, v)
    return cfg.build()


@pytest.mark.parametrize("name", ["SAC", "TD3"])
def test_smoke_and_checkpoint(name):
    """tests/test_sac_offline.py's and tests/test_more_algos.py's round
    trips: the policy bit for bit in a second algorithm (TD3: the targets,
    both optimizers' moments and the update count too)."""
    from ray_tpu_torch import rllib

    cls = getattr(rllib, f"{name}Config")
    algo = _anakin(cls)
    m = algo.train()
    assert math.isfinite(m["critic_loss"]) and m["replay_size"] == 32
    assert m["episode_reward_mean"] != m["episode_reward_mean"]  # no episode
    ckpt = algo.save_checkpoint()
    algo2 = _anakin(cls)
    algo2.load_checkpoint(ckpt)
    assert algo2.iteration == 1
    state, state2 = (a.learner.checkpoint_state() for a in (algo, algo2))
    for part in ("pi", "q", "q_target"):
        for k, v in state[part].items():
            assert torch.equal(v, state2[part][k]), (part, k)
    if name == "TD3":
        assert state2["update_count"] == 2
        for opt in ("pi_opt", "q_opt"):
            for i, s in state[opt]["state"].items():
                assert torch.equal(s["exp_avg"],
                                   state2[opt]["state"][i]["exp_avg"])
    else:
        assert torch.equal(state["log_alpha"], state2["log_alpha"])
    # Training goes on from the restored state.
    assert math.isfinite(algo2.train()["critic_loss"])


def test_td3_checkpoint_loads_optimizers_in_place():
    """Loading a TD3 checkpoint copies both optimizers' moments and step
    counts into the learner's own state tensors (a captured CUDA graph of
    the update reads and writes those), and leaves ``capturable`` as the
    learner's device needs it (False on the CPU).  The next update of the
    restored learner equals the source's on the same batch and noise, bit
    for bit."""
    cfg = ttd3.TD3Config().training(
        model={"fcnet_hiddens": [32, 32]}).resources(device="cpu")
    rng = np.random.default_rng(8)
    learners = [ttd3.TD3Learner(cfg, OBS_DIM, ADIM, [-2.0], [2.0],
                                torch.device("cpu"),
                                torch.Generator().manual_seed(seed))
                for seed in (0, 1)]
    for learner in learners:
        for _ in range(3):
            learner.update(_port_batch(_batch(rng)),
                           torch.Generator().manual_seed(0))
    source, target = learners
    ckpt = source.checkpoint_state()
    opts = (target.pi_opt, target.q_opt)
    held = [dict(st) for opt in opts for st in opt.state.values()]
    target.load_checkpoint_state(ckpt)
    now = [st for opt in opts for st in opt.state.values()]
    assert len(held) == len(now) > 0
    for before, after in zip(held, now):
        assert set(before) == set(after)
        for k, v in after.items():
            assert v is before[k], k
    for opt, name in zip(opts, ("pi_opt", "q_opt")):
        assert not any(g["capturable"] for g in opt.param_groups)
        for i, st in enumerate(opt.state.values()):
            for k, v in st.items():
                assert torch.equal(v, ckpt[name]["state"][i][k]), (name, k)
    assert target.update_count == source.update_count == 3
    batch, noise = _port_batch(_batch(rng)), [torch.randn(B, ADIM)]
    for learner in learners:
        learner.update(batch, noise=noise)
    state, state2 = (l.checkpoint_state() for l in learners)
    for part in ("pi", "pi_target", "q", "q_target"):
        for k, v in state[part].items():
            assert torch.equal(v, state2[part][k]), (part, k)


def test_sac_anakin_metrics_and_alpha_moves():
    algo = _anakin(tsac.SACConfig)
    first = algo.train()
    for _ in range(3):
        m = algo.train()
    assert {"critic_loss", "actor_loss", "alpha_loss", "alpha"} <= set(m)
    assert m["alpha"] != first["alpha"] and 0 < m["alpha"] < 1.0
    assert m["num_env_steps_sampled"] == 4 * 32


@pytest.mark.slow
@pytest.mark.parametrize("name", ["SAC", "TD3"])
def test_learns_pendulum(name):
    """tests/test_sac_offline.py's and tests/test_more_algos.py's gates
    (reference bar: tuned_examples/sac/pendulum-sac.yaml ~ -250; floor
    -300)."""
    from ray_tpu_torch import rllib

    cfg = (getattr(rllib, f"{name}Config")()
           .environment("PendulumContinuous-v1")
           .anakin(num_envs=32, unroll_length=4)
           .debugging(seed=0).resources(device="cpu"))
    cfg.num_updates_per_iter = 64
    cfg.learning_starts = 1000
    algo = cfg.build()
    best = -float("inf")
    for _ in range(200):
        r = algo.train().get("episode_reward_mean", float("nan"))
        if not math.isnan(r):
            best = max(best, r)
        if best >= -300:
            break
    assert best >= -300, f"{name} failed to learn Pendulum: best={best}"
