"""The port's ES, linear bandits (LinUCB, LinTS), Dyna-Q and QMIX against
the JAX package's, on the CPU in fp32, with JAX's draws handed in; then
the learning gates of ``tests/test_algo_families.py`` on the port's own
draws (each run under ~5 s here; chip_smoke's ``[es]``, ``[bandit]``,
``[dynaq]`` and ``[qmix]`` run them on the card).

- ES: one generation from JAX's noise and initial env states (its train
  step's key schedule): the same fitness (CartPole's integer returns,
  exactly; the population ties), the same centered ranks, the updated
  flat vector within 1e-5 (``es_flat_from_jax``); the stable double
  argsort on ties; ``torch.optim.SGD`` = optax's chain step for step;
- LinUCB and LinTS: 256 rounds from JAX's contexts, reward noise, arm
  weights and Thompson draws: each round's reward and regret within
  1e-5 (the same arms), and the per-arm statistics after them;
- Dyna-Q: the model loss and the Q loss (real + imagined rows, JAX's
  imagination draws) on one batch, and one update of each;
- QMIX: the mixer's output (1e-6) and its monotonicity (dQ_tot/dQ_i >=
  0), the mixed TD loss and one update.

The JAX functions are the reference's own closures (of its jitted train
step), the weights converted from its trees."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from ray_tpu.rllib import BanditLinTSConfig as JLinTSConfig
from ray_tpu.rllib import BanditLinUCBConfig as JLinUCBConfig
from ray_tpu.rllib import DynaQConfig as JDynaQConfig
from ray_tpu.rllib import ESConfig as JESConfig
from ray_tpu.rllib import QMixConfig as JQMixConfig
from ray_tpu.rllib.algorithms import dqn as jdqn
from ray_tpu.rllib.algorithms import es as jes
from ray_tpu.rllib.env.jax_envs import CartPole as JCartPole
from ray_tpu_torch.models.convert import (
    dyna_q_from_flax,
    es_flat_from_jax,
    qmix_from_flax,
)
from ray_tpu_torch.rllib import (
    ALGORITHMS,
    BanditLinTSConfig,
    BanditLinUCBConfig,
    DynaQConfig,
    ESConfig,
    QMixConfig,
    get_algorithm_config,
)
from ray_tpu_torch.rllib.algorithms import dqn as tdqn
from ray_tpu_torch.rllib.algorithms import es as tes
from ray_tpu_torch.rllib.algorithms.bandit import LinearBanditEnv
from ray_tpu_torch.rllib.algorithms.qmix import Mixer

# The updated ES vector: the same ranks, then (w @ eps) summed in another
# order (~1e-7 of |grad|) through SGD's elementwise step.
ES_ATOL = 1e-5
# 256 bandit rounds: each round's reward and regret, and the statistics.
BANDIT_ATOL = 1e-5
# One minibatch's losses; the parameters after one Adam update (lr 1e-3
# or 5e-4: the gradients' rounding moves elements ~1e-10 apart).
LOSS_RTOL = 1e-6
MIXER_RTOL = 1e-6
PARAM_ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def closure(fn, name):
    """A variable a JAX package function (or its jitted train step)
    closes over."""
    fn = getattr(fn, "__wrapped__", fn)
    return fn.__closure__[fn.__code__.co_freevars.index(name)].cell_contents


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_registry_has_the_reference_names():
    from ray_tpu.rllib import ALGORITHMS as JALGORITHMS

    assert sorted(ALGORITHMS) == sorted(JALGORITHMS)
    for name in ("ES", "BanditLinUCB", "BanditLinTS", "DynaQ", "QMIX"):
        assert get_algorithm_config(name).algo_class is not None


# ---- ES ----------------------------------------------------------------------

def test_centered_ranks_are_stable_on_ties():
    x = np.array([3.0, 1.0, 3.0, 2.0, 1.0, 3.0, 9.0, 1.0], np.float32)
    got = tes._centered_ranks(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jes._centered_ranks(
        jnp.asarray(x))))
    # Tied members keep their order: the first 1.0 ranks lowest.
    assert list(np.argsort(got)) == [1, 4, 7, 3, 0, 2, 5, 6]


def test_sgd_matches_optax_chain_step_for_step():
    rng = np.random.default_rng(0)
    p0 = rng.normal(size=50).astype(np.float32)
    lr, l2 = 0.03, 0.005
    tx = optax.chain(optax.add_decayed_weights(l2),
                     optax.sgd(lr, momentum=0.9))
    jp, st = jnp.asarray(p0), None
    st = tx.init(jp)
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = torch.optim.SGD([tp], lr=lr, momentum=0.9, weight_decay=l2,
                          dampening=0)
    for _ in range(6):
        g = rng.normal(size=50).astype(np.float32)
        up, st = tx.update(jnp.asarray(g), st, jp)
        jp = optax.apply_updates(jp, up)
        tp.grad = torch.from_numpy(g)
        opt.step()
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp),
                                   rtol=0, atol=1e-6)


def _es_pair(population=16):
    knobs = dict(population_size=population, noise_stdev=0.1, lr=0.03,
                 episode_length=200)
    jalgo = (JESConfig().environment("CartPole-v1").training(**knobs)
             .debugging(seed=0).build())
    talgo = (ESConfig().environment("CartPole-v1").training(**knobs)
             .resources(device="cpu").debugging(seed=0).build())
    return jalgo, talgo


# The fitness of one generation at episode_length 200: XLA fuses
# CartPole's update into FMAs inside the jitted scan, torch rounds each
# operation, and the env is chaotic: a 1-ulp difference in a velocity
# (measured at step 17 of member 5) grows until an episode ends a step
# or two apart.  Measured: 14 of the 16 members equal, the other two 2
# steps short of JAX's 168 and 200.
ES_FIT_EQUAL_AT_LEAST = 14
ES_FIT_RTOL = 0.02


def _es_generation_inputs(jalgo, P=16):
    """JAX's draws for one generation, as its train step makes them: the
    noise, each member's key and initial CartPole state; and the
    population and its fitness by the reference's ``episode_return``."""
    st = jalgo._anakin_state
    _, k_noise, k_ep = jax.random.split(st.rng, 3)
    eps = jax.random.normal(k_noise, (P // 2, st.flat_params.shape[0]))
    keys = jax.random.split(k_ep, P)
    env = JCartPole()
    init_core = np.stack([np.asarray(env.reset(jax.random.split(k)[1])[0]
                                     ["core"]) for k in keys])
    sigma = jalgo.config.noise_stdev
    pop = jnp.concatenate([st.flat_params + sigma * eps,
                           st.flat_params - sigma * eps])
    jfit = np.asarray(jax.vmap(closure(jalgo._train_step, "episode_return"))(
        pop, keys))
    return eps, init_core, jfit


def test_es_fitness_matches_jax():
    jalgo, talgo = _es_pair()
    eps, init_core, jfit = _es_generation_inputs(jalgo)
    with torch.no_grad():
        talgo.flat.copy_(es_flat_from_jax(jalgo._anakin_state.flat_params,
                                          4, (64, 64), 2))
    out = talgo.generation(es_flat_from_jax(eps, 4, (64, 64), 2),
                           torch.from_numpy(init_core))
    fit = out["fitness"].numpy()
    assert (fit == jfit).sum() >= ES_FIT_EQUAL_AT_LEAST, (fit, jfit)
    np.testing.assert_allclose(fit, jfit, rtol=ES_FIT_RTOL)
    assert np.all(fit == np.round(fit))


def test_es_update_from_jax_fitness_matches_jax():
    """The ranks and the update from JAX's own fitness, which ties (six
    members share three returns): the same ranks, exactly, and the
    updated flat vector within 1e-5."""
    jalgo, talgo = _es_pair()
    eps, _, jfit = _es_generation_inputs(jalgo)
    assert len(np.unique(jfit)) < len(jfit), "no tied fitness"
    st = jalgo._anakin_state
    jalgo._anakin_state, _ = jalgo._train_step(st)
    with torch.no_grad():
        talgo.flat.copy_(es_flat_from_jax(st.flat_params, 4, (64, 64), 2))
    ranks = tes.es_update(talgo.flat, talgo.optimizer,
                          es_flat_from_jax(eps, 4, (64, 64), 2),
                          torch.from_numpy(jfit), jalgo.config.noise_stdev)
    np.testing.assert_array_equal(ranks.numpy(), np.asarray(
        jes._centered_ranks(jnp.asarray(jfit))))
    np.testing.assert_allclose(
        talgo.flat.detach().numpy(),
        es_flat_from_jax(jalgo._anakin_state.flat_params, 4, (64, 64),
                         2).numpy(), rtol=0, atol=ES_ATOL)


def test_es_checkpoint_round_trip():
    _, talgo = _es_pair(population=8)
    talgo.train()
    ckpt = talgo.save_checkpoint()
    _, other = _es_pair(population=8)
    other.load_checkpoint(ckpt)
    assert torch.equal(other.flat, talgo.flat)
    assert other.iteration == 1


def test_es_learns_cartpole():
    algo = (ESConfig().environment("CartPole-v1")
            .training(population_size=128, noise_stdev=0.1, lr=0.03,
                      episode_length=200)
            .resources(device="cpu").debugging(seed=0).build())
    best = -1.0
    for _ in range(30):
        best = max(best, algo.train()["episode_reward_mean"])
        if best >= 120:
            break
    assert best >= 120, f"ES failed to evolve CartPole: best={best}"


# ---- bandits -----------------------------------------------------------------

@pytest.mark.parametrize("jcls, tcls, seed", [
    (JLinUCBConfig, BanditLinUCBConfig, 0),
    (JLinTSConfig, BanditLinTSConfig, 1)], ids=["linucb", "lints"])
def test_bandit_rounds_match_jax(jcls, tcls, seed):
    jalgo = jcls().debugging(seed=seed).build()
    st = jalgo._anakin_state
    one_round = closure(jalgo._train_step, "one_round")
    jenv = closure(one_round, "env")
    K, d, R = jenv.num_arms, jenv.context_dim, 256
    xs, zs, epss, rng = [], [], [], st.rng
    for _ in range(R):  # one_round's key schedule
        rng, k_env, k_explore = jax.random.split(rng, 3)
        kx, kn = jax.random.split(k_env)
        xs.append(jax.random.normal(kx, (d,)))
        zs.append(jax.random.normal(kn, (K,)))
        epss.append(jax.random.normal(k_explore, (K, d)))
    final, (rs, regs) = jax.lax.scan(one_round, st, None, length=R)

    env = LinearBanditEnv(K, d, jenv.noise, weights=torch.from_numpy(
        np.asarray(jenv.weights)))
    talgo = tcls().environment(env).resources(device="cpu").debugging(
        seed=seed).build()
    as_t = lambda xs: torch.from_numpy(np.stack([np.asarray(x) for x in xs]))
    out = talgo.rounds(as_t(xs), as_t(zs),
                       as_t(epss) if talgo._explore == "ts" else None)
    np.testing.assert_allclose(out["rewards"].numpy(), np.asarray(rs),
                               rtol=0, atol=BANDIT_ATOL)
    np.testing.assert_allclose(out["regrets"].numpy(), np.asarray(regs),
                               rtol=0, atol=BANDIT_ATOL)
    np.testing.assert_allclose(out["regret_this_iter"].item(),
                               float(np.asarray(regs).sum()), rtol=1e-5)
    tst = talgo._anakin_state
    np.testing.assert_allclose(tst.b.numpy(), np.asarray(final.b), rtol=0,
                               atol=BANDIT_ATOL)
    np.testing.assert_allclose(tst.A_inv.numpy(), np.asarray(final.A_inv),
                               rtol=0, atol=BANDIT_ATOL)


@pytest.mark.parametrize("cls, seed", [(BanditLinUCBConfig, 0),
                                       (BanditLinTSConfig, 1)],
                         ids=["linucb", "lints"])
def test_bandit_regret_sublinear(cls, seed):
    """tests/test_algo_families.py's gate: the 9th iteration's regret
    under 0.3x the first's."""
    algo = cls().resources(device="cpu").debugging(seed=seed).build()
    m1 = algo.train()
    for _ in range(8):
        m = algo.train()
    assert m["regret_this_iter"] < 0.3 * max(m1["regret_this_iter"], 1e-9)
    assert m["episode_reward_mean"] > 0.0
    assert m["rounds"] == 9 * 256


# ---- Dyna-Q ------------------------------------------------------------------

def _dyna_pair():
    knobs = dict(lr=1e-3, learning_starts=0)
    jalgo = (JDynaQConfig().environment("CartPole-v1")
             .anakin(num_envs=8, unroll_length=4).training(**knobs)
             .debugging(seed=0).build())
    talgo = (DynaQConfig().environment("CartPole-v1")
             .anakin(num_envs=8, unroll_length=4).training(**knobs)
             .resources(device="cpu").debugging(seed=0).build())
    st = jalgo._anakin_state
    talgo.learner.load_checkpoint_state(dyna_q_from_flax(
        _np(st.params), _np(st.model_params)))
    talgo.learner.target.load_state_dict(talgo.learner.module.state_dict())
    rng = np.random.default_rng(7)
    n = 256
    rows = {"obs": rng.normal(0, 0.5, (n, 4)).astype(np.float32),
            "actions": rng.integers(0, 2, n),
            "rewards": np.ones(n, np.float32),
            "next_obs": rng.normal(0, 0.5, (n, 4)).astype(np.float32),
            "dones": (rng.random(n) < 0.1).astype(np.float32)}
    jreplay = jdqn._replay_insert(jdqn.make_replay_state(1024, n, 4),
                                  {k: jnp.asarray(v) for k, v in rows.items()})
    treplay = tdqn._replay_insert(
        tdqn.make_replay_state(1024, n, 4),
        {k: torch.from_numpy(v) for k, v in rows.items()})
    talgo.learner.replay = treplay
    return jalgo, talgo, jreplay, treplay


def test_dyna_q_model_loss_and_update_match_jax():
    jalgo, talgo, jreplay, treplay = _dyna_pair()
    st = jalgo._anakin_state
    train_step = jalgo._train_step
    B = 128
    idx = np.array(jax.random.randint(jax.random.PRNGKey(3), (B,), 0, 256))
    jbatch = {k: getattr(jreplay, k)[idx] for k in tdqn.REPLAY_COLS}
    tbatch = tdqn.replay_batch(treplay, torch.from_numpy(idx))
    model_loss_fn = closure(train_step, "model_loss_fn")
    jloss, grads = jax.value_and_grad(model_loss_fn)(st.model_params, jbatch)
    with torch.no_grad():
        tloss = talgo.learner.model.module.loss(tbatch)
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=LOSS_RTOL)
    mtx = closure(train_step, "mtx")
    up, _ = mtx.update(grads, st.model_opt, st.model_params)
    want = dyna_q_from_flax(_np(st.params), _np(optax.apply_updates(
        st.model_params, up)))
    out = talgo.learner.model.device_update(tbatch)
    np.testing.assert_allclose(out["model_loss"].item(), float(jloss),
                               rtol=LOSS_RTOL)
    for name, p in talgo.learner.checkpoint_state().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=0,
                                   atol=PARAM_ATOL, err_msg=name)


def test_dyna_q_q_loss_and_update_match_jax():
    jalgo, talgo, jreplay, treplay = _dyna_pair()
    st = jalgo._anakin_state
    train_step = jalgo._train_step
    B = BI = 128
    # One q_update's draws, as the JAX step makes them.
    k_real, k_imag = jax.random.split(jax.random.PRNGKey(11))
    real_idx = np.array(jax.random.randint(k_real, (B,), 0, 256))
    k_idx, k_eps, k_act = jax.random.split(k_imag, 3)
    noise = [torch.from_numpy(np.array(jax.random.randint(
                 k_idx, (BI,), 0, 256)).astype(np.int64)),
             torch.from_numpy(np.array(jax.random.uniform(k_eps, (BI,)))),
             torch.from_numpy(np.array(jax.random.randint(
                 k_act, (BI,), 0, 2)).astype(np.int64))]
    real = closure(train_step, "sample_real")(jreplay, k_real, B)
    imag = closure(train_step, "imagine")(st.model_params, st.params,
                                          jreplay, k_imag, BI)
    jbatch = {k: jnp.concatenate([real[k], imag[k]]) for k in real}
    q_loss_fn = closure(train_step, "q_loss_fn")
    jloss, grads = jax.value_and_grad(q_loss_fn)(st.params,
                                                 st.target_params, jbatch)
    learner = talgo.learner
    tbatch = tdqn.replay_batch(treplay, torch.from_numpy(real_idx))
    timag = learner.imagine(*noise)
    np.testing.assert_array_equal(timag["actions"].numpy(),
                                  np.asarray(imag["actions"]))
    np.testing.assert_array_equal(timag["dones"].numpy(),
                                  np.asarray(imag["dones"]))
    with torch.no_grad():
        tloss = learner.q_loss({k: torch.cat([tbatch[k], timag[k]])
                                for k in tbatch})
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=LOSS_RTOL)
    tx = closure(train_step, "tx")
    up, _ = tx.update(grads, st.opt_state, st.params)
    p = optax.apply_updates(st.params, up)
    tau = jalgo.config.target_network_tau
    tp = jax.tree_util.tree_map(lambda t, o: t * (1 - tau) + o * tau,
                                st.target_params, p)
    out = learner.device_update(tbatch, noise)
    np.testing.assert_allclose(out["total_loss"].item(), float(jloss),
                               rtol=LOSS_RTOL)
    want = dyna_q_from_flax(_np(p), _np(st.model_params))
    want_target = dyna_q_from_flax(_np(tp), _np(st.model_params))
    for name, v in learner.module.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[f"q.{name}"].numpy(),
                                   rtol=0, atol=PARAM_ATOL, err_msg=name)
    for name, v in learner.target.state_dict().items():
        np.testing.assert_allclose(
            v.numpy(), want_target[f"q.{name}"].numpy(), rtol=0,
            atol=PARAM_ATOL, err_msg=name)


def test_dynaq_learns_cartpole_and_model_converges():
    """tests/test_algo_families.py's gate (slow there, ~4 s here): best
    >= 100 within 80 iterations, and the model loss falls."""
    algo = (DynaQConfig().environment("CartPole-v1")
            .anakin(num_envs=32, unroll_length=16)
            .training(lr=1e-3, learning_starts=500,
                      num_updates_per_iter=8, epsilon_decay_steps=15_000)
            .resources(device="cpu").debugging(seed=0).build())
    best, first_mloss, last = -1.0, None, {}
    for _ in range(80):
        last = algo.train()
        r = last["episode_reward_mean"]
        if np.isfinite(r):
            best = max(best, r)
        if first_mloss is None and np.isfinite(last["model_loss"]):
            first_mloss = last["model_loss"]
        if best >= 100:
            break
    assert best >= 100, f"DynaQ failed to learn CartPole: best={best}"
    assert last["model_loss"] < first_mloss


def test_dynaq_checkpoint_holds_the_q_net_and_the_model():
    _, talgo, _, _ = _dyna_pair()
    ckpt = talgo.save_checkpoint()
    _, other, _, _ = _dyna_pair()
    with torch.no_grad():
        for p in other.learner.model.module.parameters():
            p.zero_()
    other.load_checkpoint(ckpt)
    for a, b in zip(talgo.learner.checkpoint_state().values(),
                    other.learner.checkpoint_state().values()):
        assert torch.equal(a, b)


# ---- QMIX --------------------------------------------------------------------

def _qmix_pair():
    jalgo = JQMixConfig().debugging(seed=0).build()
    talgo = QMixConfig().resources(device="cpu").debugging(seed=0).build()
    st = jalgo._anakin_state
    talgo.learner.module.load_state_dict(qmix_from_flax(_np(st.params)))
    talgo.learner.target.load_state_dict(qmix_from_flax(_np(
        jax.tree_util.tree_map(lambda x: x * 0.9 + 0.01, st.params))))
    return jalgo, talgo


def _qmix_batch(rng, B=128, M=2, d=6):
    obs = rng.normal(0, 0.5, (B, M, d)).astype(np.float32)
    return {"obs": obs,
            "actions": rng.integers(0, 2, (B, M)),
            "rewards": rng.random(B).astype(np.float32),
            "next_obs": rng.normal(0, 0.5, (B, M, d)).astype(np.float32),
            "dones": (rng.random(B) < 0.1).astype(np.float32)}


def test_qmix_mixer_matches_jax_and_is_monotonic():
    jalgo, talgo = _qmix_pair()
    mixer = closure(closure(jalgo._train_step, "td_loss"), "mixer")
    rng = np.random.default_rng(8)
    qs = rng.normal(size=(64, 2)).astype(np.float32)
    state = rng.normal(0, 0.5, (64, 12)).astype(np.float32)
    want = mixer.apply(jalgo._anakin_state.params["mixer"], qs, state)
    tq = torch.from_numpy(qs).requires_grad_(True)
    got = talgo.learner.module.mixer(tq, torch.from_numpy(state))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=MIXER_RTOL, atol=MIXER_RTOL)
    got.sum().backward()
    assert (tq.grad >= 0).all(), "dQ_tot/dQ_i < 0"
    m = Mixer(3, 5, 4, generator=torch.Generator().manual_seed(1))
    q = torch.randn(32, 3, requires_grad=True)
    m(q, torch.randn(32, 5)).sum().backward()
    assert (q.grad >= 0).all()


def test_qmix_td_loss_and_one_update_match_jax():
    jalgo, talgo = _qmix_pair()
    st = jalgo._anakin_state
    tparams = jax.tree_util.tree_map(lambda x: x * 0.9 + 0.01, st.params)
    batch = _qmix_batch(np.random.default_rng(9))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    td_loss = closure(jalgo._train_step, "td_loss")
    jloss, grads = jax.value_and_grad(td_loss)(st.params, tparams, jbatch)
    learner = talgo.learner
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        tloss = learner.td_loss(tbatch)
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=LOSS_RTOL)
    tx = closure(jalgo._train_step, "tx")
    up, _ = tx.update(grads, st.opt_state, st.params)
    p = optax.apply_updates(st.params, up)
    tau = jalgo.config.target_network_tau
    tp = jax.tree_util.tree_map(lambda t, o: t * (1 - tau) + o * tau,
                                tparams, p)
    out = learner.device_update(tbatch)
    np.testing.assert_allclose(out["total_loss"].item(), float(jloss),
                               rtol=LOSS_RTOL)
    for module, tree in ((learner.module, p), (learner.target, tp)):
        want = qmix_from_flax(_np(tree))
        for name, v in module.state_dict().items():
            np.testing.assert_allclose(v.numpy(), want[name].numpy(),
                                       rtol=0, atol=PARAM_ATOL,
                                       err_msg=name)


def test_qmix_learns_coordination():
    """tests/test_algo_families.py's gate: best >= 12 of 16 within 150."""
    algo = (QMixConfig().environment("CoordinationGame-v0")
            .resources(device="cpu").debugging(seed=0).build())
    best = -1.0
    for _ in range(150):
        r = algo.train()["episode_reward_mean"]
        if np.isfinite(r):
            best = max(best, r)
        if best >= 12:
            break
    assert best >= 12, f"QMIX failed to coordinate: best={best}"
