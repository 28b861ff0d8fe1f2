"""The port's DQN (``ray_tpu_torch/rllib/algorithms/dqn.py``) against the
JAX package's, fp32, on numpy-seeded inputs and converted flax weights.

- ``QNetwork`` at 1e-5 of scale; the double-Q (and plain max) Huber TD
  loss and one clip + Adam update with its polyak sync against the JAX
  learner's own update (``DQN._update_many`` of the JAX actor mode, built
  without workers), the loss at 1e-5 of scale; the clip + Adam step on
  the same gradients within ``tests/test_torch_ppo.py``'s bound for
  optax's rounding, the whole update within its ``SGD_ATOL``;
- the reference's own checks (``tests/test_dqn.py``): the ring's wrap and
  its capacity rounding, the config registry, the checkpoint round trip;
  the epsilon schedule and the ring's fill against the JAX Anakin step;
  ``num_devices`` refused with the reference's message;
- the learning gate (CartPole to 150 within 90 iterations) is ``slow``;
  chip_smoke's ``[dqn]`` runs it on the card.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from ray_tpu.rllib.algorithms import dqn as jdqn
from ray_tpu.rllib.evaluation import worker_set as jws
from ray_tpu_torch.models.convert import replay_family_from_flax
from ray_tpu_torch.rllib.algorithms import dqn as tdqn

SCALE_TOL = 1e-5
# The clip + Adam step on the same gradients: tests/test_torch_ppo.py's
# bound (optax forms Adam's bias correction in fp32, torch in double:
# ~6.4e-6 of lr).
ADAM_RTOL, ADAM_ATOL = 1e-6, 1e-8
# The whole update from each package's own gradients: Adam's first step
# is ~lr * sign(g) whatever |g|, so the gradients' fp32 rounding
# differences come through unscaled where a gradient is itself rounding
# noise (a bias element with |g| ~1e-7 moved 3.3e-7 apart of lr 5e-4,
# measured).  tests/test_torch_ppo.py's SGD_ATOL for the same reason.
UPDATE_ATOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_scale_close(got, want, tol=SCALE_TOL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-6), (what, err)


class _NoWorkers:
    """Stands in for the JAX package's WorkerSet: the JAX actor mode is
    built for its update alone, with no cluster."""

    def __init__(self, *args, **kwargs):
        self.workers = []

    def sync_weights(self, params):
        return 1


def jax_actor_algo(monkeypatch, config):
    monkeypatch.setattr(jws, "WorkerSet", _NoWorkers)
    algo = config.build()
    monkeypatch.undo()
    return algo


def _batch(rng, B=64, obs_dim=4, num_actions=2):
    return {"obs": rng.standard_normal((B, obs_dim)).astype(np.float32),
            "actions": rng.integers(0, num_actions, B),
            "rewards": rng.standard_normal(B).astype(np.float32),
            "next_obs": rng.standard_normal((B, obs_dim)).astype(np.float32),
            "dones": (rng.random(B) < 0.2).astype(np.float32)}


def _port_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_q_network_matches_jax():
    jnet = jdqn.QNetwork(4, 2, (64, 64))
    params = jnet.init(jax.random.PRNGKey(0), jnp.zeros((1, 4)))
    net = tdqn.QNetwork(4, 2, (64, 64))
    net.load_state_dict(replay_family_from_flax(jax.device_get(params)))
    obs = np.random.default_rng(0).standard_normal((32, 4)).astype(np.float32)
    with torch.no_grad():
        got = net(torch.from_numpy(obs)).numpy()
    assert_scale_close(got, jnet.apply(params, obs))


@pytest.mark.parametrize("double_q", [True, False], ids=["double", "max"])
def test_td_loss_and_one_update_match_jax(monkeypatch, double_q):
    from ray_tpu.rllib import DQNConfig as JConfig
    from ray_tpu_torch.rllib import DQNConfig

    configs = []
    for cls in (JConfig, DQNConfig):
        cfg = (cls().environment("CartPole-v1")
               .rollouts(num_rollout_workers=1).training(lr=5e-4))
        cfg.double_q = double_q
        configs.append(cfg)
    jalgo = jax_actor_algo(monkeypatch, configs[0])
    learner = tdqn.DQNLearner(configs[1].resources(device="cpu"), 4, 2,
                              torch.device("cpu"))
    state = replay_family_from_flax(jax.device_get(jalgo._params))
    learner.module.load_state_dict(state)
    # A target apart from the online net, so double-Q's argmax matters.
    target = jax.tree_util.tree_map(lambda p: p * 0.9 + 0.01,
                                    jalgo._params)
    learner.target.load_state_dict(replay_family_from_flax(
        jax.device_get(target)))
    batch = _batch(np.random.default_rng(1))
    params, tparams, _, losses, tds = jalgo._update_many(
        jalgo._params, target, jalgo._opt_state,
        {k: jnp.asarray(v)[None] for k, v in batch.items()})
    with torch.no_grad():
        loss, td_abs = learner.td_loss(_port_batch(batch))
    assert_scale_close(loss.item(), losses[0], what="loss")
    assert_scale_close(td_abs.mean().item(), tds[0], what="td")
    # The optimizer on the port's own gradients against optax's.  The
    # arrays are copies: jnp.asarray shares a numpy array's memory on the
    # CPU, and the update below writes the parameters in place.
    loss, _ = learner.td_loss(_port_batch(batch))
    grads = torch.autograd.grad(loss, learner._params)
    jp = [jnp.asarray(p.detach().numpy().copy()) for p in learner._params]
    tx = optax.chain(optax.clip_by_global_norm(0.5), optax.adam(5e-4))
    upd, _ = tx.update([jnp.asarray(g.numpy().copy()) for g in grads],
                       tx.init(jp), jp)
    by_optax = [np.asarray(w) for w in optax.apply_updates(jp, upd)]
    m = learner.update(_port_batch(batch))
    assert_scale_close(m["total_loss"].item(), losses[0])
    for p, w in zip(learner._params, by_optax):
        np.testing.assert_allclose(p.detach().numpy(), w,
                                   rtol=ADAM_RTOL, atol=ADAM_ATOL)
    # The whole update and the polyak sync against the JAX learner's.
    for module, tree in ((learner.module, params), (learner.target, tparams)):
        want = replay_family_from_flax(jax.device_get(tree))
        for k, v in module.state_dict().items():
            np.testing.assert_allclose(v.numpy(), want[k].numpy(),
                                       rtol=ADAM_RTOL, atol=UPDATE_ATOL,
                                       err_msg=k)


def test_weighted_td_loss_with_unit_weights_is_the_plain_loss():
    """On a prioritized plane the loss takes the IS weights (the JAX
    package's actor path ignores them); weights of 1 give the plain loss
    bit for bit, and each row's |TD error| comes back as its priority."""
    from ray_tpu_torch.rllib import DQNConfig

    cfg = DQNConfig().resources(device="cpu")
    learner = tdqn.DQNLearner(cfg, 4, 2, torch.device("cpu"),
                              torch.Generator().manual_seed(0))
    batch = _port_batch(_batch(np.random.default_rng(2)))
    with torch.no_grad():
        plain, td = learner.td_loss(batch)
        weighted, td_w = learner.td_loss({**batch,
                                          "weights": torch.ones(64)})
        zeroed, _ = learner.td_loss({**batch, "weights": torch.zeros(64)})
    assert torch.equal(plain, weighted) and torch.equal(td, td_w)
    assert zeroed.item() == 0.0 and td.shape == (64,)
    out = learner.update({**batch, "weights": torch.ones(64)})
    assert out["priorities"].shape == (64,)


def test_replay_insert_wraps_circular():
    """Inserts are always slice-aligned (capacity is rounded up to a
    multiple of the insert size), so the cursor wraps exactly to 0 and
    every write lands where insert_pos says it did."""
    cap, d, n = 8, 3, 4
    replay = tdqn.ReplayState(
        obs=torch.zeros((cap, d)),
        actions=torch.zeros((cap,), dtype=torch.int64),
        rewards=torch.zeros((cap,)), next_obs=torch.zeros((cap, d)),
        dones=torch.zeros((cap,)), insert_pos=4, size=4)
    batch1 = {
        "obs": torch.ones((n, d)),
        "actions": torch.ones((n,), dtype=torch.int64),
        "rewards": torch.arange(n, dtype=torch.float32) + 1,
        "next_obs": torch.ones((n, d)), "dones": torch.zeros((n,)),
    }
    out = tdqn._replay_insert(replay, batch1)
    assert out.insert_pos == 0  # wrapped
    assert out.size == cap
    assert torch.equal(out.rewards[4:], batch1["rewards"])
    batch2 = {k: v * 10 for k, v in batch1.items()}
    out2 = tdqn._replay_insert(out, batch2)
    assert out2.insert_pos == 4
    assert torch.equal(out2.rewards[:4], batch2["rewards"])
    assert torch.equal(out2.rewards[4:], batch1["rewards"])


def test_replay_capacity_rounds_up_to_insert_multiple():
    from ray_tpu_torch.rllib import DQNConfig

    cfg = (DQNConfig().environment("CartPole-v1")
           .anakin(num_envs=8, unroll_length=16))
    cfg.buffer_size = 200  # not a multiple of 8*16=128 -> rounds to 256
    state, _, _ = tdqn.make_anakin_dqn(cfg, torch.device("cpu"))
    assert state.replay.actions.shape[0] == 256
    assert state.replay.actions.dtype == torch.int64


def test_dqn_config_registry():
    from ray_tpu_torch.rllib import ALGORITHMS, DQNConfig, \
        get_algorithm_config

    assert ALGORITHMS["DQN"] is DQNConfig
    assert isinstance(get_algorithm_config("DQN"), DQNConfig)
    with pytest.raises(ValueError, match="unknown algorithm"):
        get_algorithm_config("QMIX")


def test_anakin_epsilon_and_ring_fill_match_jax():
    """The epsilon schedule (over env steps, one tick a rollout step) and
    the ring's fill after each iteration, against the JAX Anakin step."""
    from ray_tpu.rllib import DQNConfig as JConfig
    from ray_tpu_torch.rllib import DQNConfig

    def build(cls, **kw):
        cfg = (cls().environment("CartPole-v1")
               .anakin(num_envs=8, unroll_length=16))
        cfg.buffer_size, cfg.learning_starts = 300, 100
        cfg.epsilon_decay_steps, cfg.num_updates_per_iter = 400, 2
        return cfg.resources(**kw).build()

    jalgo, algo = build(JConfig), build(DQNConfig, device="cpu")
    for _ in range(4):
        want, got = jalgo.train(), algo.train()
        assert got["epsilon"] == pytest.approx(want["epsilon"], abs=1e-7)
        assert got["replay_size"] == want["replay_size"]
        assert got["num_env_steps_sampled"] == want["num_env_steps_sampled"]
        assert np.isfinite(got["total_loss"]) == (got["replay_size"] >= 100)
    assert algo._anakin_state.replay.capacity == 384


def test_dqn_checkpoint_roundtrip():
    from ray_tpu_torch.rllib import DQNConfig

    def config():
        return (DQNConfig().environment("CartPole-v1")
                .anakin(num_envs=8, unroll_length=16)
                .resources(device="cpu"))

    cfg = config()
    cfg.learning_starts = 64
    algo = cfg.build()
    algo.train()
    ckpt = algo.save_checkpoint()
    algo2 = config().build()
    algo2.load_checkpoint(ckpt)
    assert algo2.iteration == 1
    p1, p2 = algo.module.state_dict(), algo2.module.state_dict()
    assert sorted(p1) == sorted(p2)
    for k in p1:
        assert torch.equal(p1[k], p2[k]), k
    with pytest.raises(NotImplementedError, match="evaluator"):
        algo.evaluate(10)


@pytest.mark.parametrize("name", ["DQN", "SAC", "TD3", "DDPG"])
def test_num_devices_refused(name):
    """tests/test_rllib_sharded.py:177: paths without a data-parallel
    step refuse num_devices instead of silently running on one device."""
    from ray_tpu_torch import rllib

    env = "CartPole-v1" if name == "DQN" else "PendulumContinuous-v1"
    with pytest.raises(NotImplementedError, match="num_devices"):
        (getattr(rllib, f"{name}Config")().environment(env)
         .resources(num_devices=2, device="cpu").build())


def test_defaults_to_cuda():
    from ray_tpu_torch.rllib import DQNConfig

    if torch.cuda.is_available():
        pytest.skip("this checks the raise where there is no CUDA")
    with pytest.raises(RuntimeError, match="cuda"):
        DQNConfig().environment("CartPole-v1").build()


@pytest.mark.slow
def test_dqn_learns_cartpole():
    """tests/test_dqn.py's gate (reference bar:
    tuned_examples/dqn/cartpole-dqn.yaml expects reward 150)."""
    from ray_tpu_torch.rllib import DQNConfig

    cfg = (DQNConfig()
           .environment("CartPole-v1")
           .anakin(num_envs=128, unroll_length=16)
           .training(lr=1e-3)
           .debugging(seed=0).resources(device="cpu"))
    cfg.num_updates_per_iter = 16
    cfg.dqn_batch_size = 256
    cfg.epsilon_decay_steps = 60_000
    cfg.learning_starts = 2_000
    algo = cfg.build()
    best = -1.0
    for _ in range(90):
        r = algo.train().get("episode_reward_mean", float("nan"))
        if np.isfinite(r):
            best = max(best, r)
        if best >= 150:
            break
    assert best >= 150, f"DQN failed to learn CartPole: best={best}"
