"""The port's offline RL (``ray_tpu_torch/rllib/offline``, BC, MARWIL)
against the JAX package's, on the CPU in fp32 (the OPE estimators in
float64, as both packages compute them).

- JSON-lines IO: each package reads the other's files, the round trip is
  exact, and the two writers' files are the same bytes;
- the IS and WIS estimates of both packages on the same episodes, to
  1e-12, and the reference's analytic bandit check;
- BC and MARWIL: the loss of one minibatch (1e-6 relative) and the
  parameters after one update (1e-5) on JAX's own indices (its train
  step's key schedule), the weights converted from JAX's;
  ``discounted_returns`` exactly; MARWIL with beta = 0 has BC's loss;
- the learning gates of ``tests/test_more_algos.py`` (MARWIL on 60%
  random scripted data, its weighting property) and
  ``tests/test_sac_offline.py`` (BC clones a PPO expert), on the port's
  own data and draws.  chip_smoke's ``[offline]`` runs them on the card.

The JAX losses are the reference's own closures (``loss_fn`` of the
jitted train step)."""
import numpy as np
import pytest
import torch

import jax

from ray_tpu.rllib import BCConfig as JBCConfig
from ray_tpu.rllib import MARWILConfig as JMARWILConfig
from ray_tpu.rllib.algorithms import marwil as jmarwil
from ray_tpu.rllib.offline import ImportanceSampling as JIS
from ray_tpu.rllib.offline import JsonReader as JReader
from ray_tpu.rllib.offline import JsonWriter as JWriter
from ray_tpu.rllib.offline import WeightedImportanceSampling as JWIS
from ray_tpu.rllib.policy.sample_batch import SampleBatch as JBatch
from ray_tpu_torch.models.convert import actor_critic_from_flax
from ray_tpu_torch.rllib import BCConfig, MARWILConfig, PPOConfig
from ray_tpu_torch.rllib.algorithms import marwil as tmarwil
from ray_tpu_torch.rllib.env.torch_envs import (
    CartPole,
    vector_reset,
    vector_step,
)
from ray_tpu_torch.rllib.offline import (
    ImportanceSampling,
    JsonReader,
    JsonWriter,
    WeightedImportanceSampling,
)
from ray_tpu_torch.rllib.policy.sample_batch import SampleBatch

# One minibatch's loss: the same fp32 network and means, ~1e-7 apart.
LOSS_RTOL = 1e-6
# One clip + Adam update of lr 1e-3 from each package's gradients:
# elements move by ~lr, the gradients' fp32 rounding (1e-7 relative)
# moves them ~1e-10 apart; held to 1e-5 as the task states.
PARAM_ATOL = 1e-5
OPE_TOL = 1e-12


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def closure(jitted, name):
    """A variable the JAX package's jitted train step closes over."""
    fn = getattr(jitted, "__wrapped__", jitted)
    return fn.__closure__[fn.__code__.co_freevars.index(name)].cell_contents


def _columns(rng, n=300):
    return {"obs": rng.standard_normal((n, 4)).astype(np.float32),
            "actions": rng.integers(0, 2, n).astype(np.int64),
            "rewards": rng.random(n).astype(np.float32),
            "dones": (rng.random(n) < 0.05).astype(np.float32)}


def _write(writer_cls, batch_cls, path, columns, parts=2):
    w = writer_cls(str(path))
    n = len(columns["obs"])
    for i in range(parts):
        lo, hi = i * n // parts, (i + 1) * n // parts
        w.write(batch_cls({k: v[lo:hi] for k, v in columns.items()}))
    w.close()
    return str(path)


def test_each_package_reads_the_others_files_exactly(tmp_path):
    cols = _columns(np.random.default_rng(0), 50)
    cols["obs"] = cols["obs"].astype(np.float64)  # exact through JSON
    port = _write(JsonWriter, SampleBatch, tmp_path / "port", cols)
    ref = _write(JWriter, JBatch, tmp_path / "ref", cols)
    for reader in (JsonReader(ref), JReader(port), JsonReader(port)):
        got = reader.read_all()
        assert sorted(got) == sorted(cols)
        for k, v in cols.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert [len(b) for b in JsonReader(ref)] == [25, 25]
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "ref").iterdir())
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "ref" / name).read_bytes()


def test_json_writer_rotates_files_as_the_reference(tmp_path):
    cols = _columns(np.random.default_rng(1), 40)
    for cls, batch, tag in ((JsonWriter, SampleBatch, "port"),
                            (JWriter, JBatch, "ref")):
        w = cls(str(tmp_path / tag), max_file_size=1000)
        for i in range(4):
            w.write(batch({k: v[i * 10:(i + 1) * 10]
                           for k, v in cols.items()}))
        w.close()
    port = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert len(port) > 1
    assert port == sorted(p.name for p in (tmp_path / "ref").iterdir())
    assert len(JsonReader(str(tmp_path / "ref")).read_all()) == 40


def _episodes(rng, cls, count=200):
    out = []
    for _ in range(count):
        T = int(rng.integers(1, 6))
        out.append(cls({
            "actions": rng.integers(0, 2, T),
            "action_logp": np.log(rng.uniform(0.2, 0.8, T)),
            "rewards": rng.normal(size=T)}))
    return out


def _target_logp(ep):
    return np.log(np.where(np.asarray(ep["actions"]) == 0, 0.3, 0.7))


@pytest.mark.parametrize("gamma", [1.0, 0.9])
def test_is_and_wis_estimates_match_jax(gamma):
    for port, ref in ((ImportanceSampling, JIS),
                      (WeightedImportanceSampling, JWIS)):
        got = port(gamma).estimate(
            _episodes(np.random.default_rng(3), SampleBatch), _target_logp)
        want = ref(gamma).estimate(
            _episodes(np.random.default_rng(3), JBatch), _target_logp)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=OPE_TOL,
                                       atol=OPE_TOL, err_msg=k)


def test_ope_importance_sampling_bandit():
    """tests/test_sac_offline.py's analytic check on the port: behavior
    picks arm 0 w.p. 0.8, target w.p. 0.2; arm 0 pays 1: V^pi = 0.2."""
    rng = np.random.default_rng(0)
    episodes = []
    for _ in range(4000):
        a = int(rng.random() < 0.2)
        episodes.append(SampleBatch({
            "actions": np.array([a]),
            "action_logp": np.array([np.log(0.8 if a == 0 else 0.2)]),
            "rewards": np.array([1.0 if a == 0 else 0.0])}))

    def target_logp(ep):
        return np.log(np.where(np.asarray(ep["actions"]) == 0, 0.2, 0.8))

    is_est = ImportanceSampling().estimate(episodes, target_logp)
    wis_est = WeightedImportanceSampling().estimate(episodes, target_logp)
    assert abs(is_est["v_target"] - 0.2) < 0.05, is_est
    assert abs(wis_est["v_target"] - 0.2) < 0.05, wis_est
    assert 0 < wis_est["effective_sample_size"] <= len(episodes)


def test_discounted_returns_match_jax_exactly():
    rng = np.random.default_rng(4)
    r = rng.normal(size=500).astype(np.float32)
    d = (rng.random(500) < 0.1).astype(np.float32)
    np.testing.assert_array_equal(
        tmarwil.discounted_returns(r, d, 0.99),
        jmarwil.discounted_returns(r, d, 0.99))
    np.testing.assert_allclose(
        tmarwil.discounted_returns(np.ones(4, np.float32),
                                   np.array([0, 1, 0, 0], np.float32), 0.5),
        [1.5, 1.0, 1.5, 1.0])


def _pair(tmp_path, jcls, tcls, **knobs):
    """The JAX and the port algorithm on one dataset (written by the JAX
    package), one update an iteration, the port's weights JAX's."""
    path = _write(JWriter, JBatch, tmp_path / "data",
                  _columns(np.random.default_rng(5)))
    algos = []
    for cls, extra in ((jcls, {}), (tcls, {"device": "cpu"})):
        cfg = (cls().environment("CartPole-v1").offline_data(input_=path)
               .training(lr=1e-3).resources(**extra).debugging(seed=0))
        cfg.num_sgd_per_iter = 1
        for k, v in knobs.items():
            setattr(cfg, k, v)
        algos.append(cfg.build())
    jalgo, talgo = algos
    talgo.module.load_state_dict(actor_critic_from_flax(
        jax.tree_util.tree_map(np.asarray, jalgo._anakin_state.params)))
    # JAX's minibatch, as its train step draws it.
    n = jalgo._obs.shape[0]
    mb = min(256, n)
    _, k = jax.random.split(jalgo._anakin_state.rng)
    idx = np.array(jax.random.randint(jax.random.split(k, 1)[0], (mb,),
                                      0, n))
    return jalgo, talgo, idx


def _assert_params_close(talgo, jparams):
    want = actor_critic_from_flax(jax.tree_util.tree_map(np.asarray,
                                                         jparams))
    for name, p in talgo.module.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=0,
                                   atol=PARAM_ATOL, err_msg=name)


def test_bc_loss_and_one_update_match_jax(tmp_path):
    jalgo, talgo, idx = _pair(tmp_path, JBCConfig, BCConfig)
    params = jalgo._anakin_state.params
    jloss = closure(jalgo._train_step, "loss_fn")(
        params, jalgo._obs[idx], jalgo._actions[idx])
    with torch.no_grad():
        loss, _ = talgo.loss({k: v[torch.from_numpy(idx)]
                              for k, v in talgo._data.items()})
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
    jalgo._anakin_state, jmean = jalgo._train_step(jalgo._anakin_state)
    out = talgo.sgd_update(torch.from_numpy(idx))
    np.testing.assert_allclose(out["total_loss"].item(), float(jmean),
                               rtol=LOSS_RTOL)
    _assert_params_close(talgo, jalgo._anakin_state.params)


def test_marwil_loss_and_one_update_match_jax(tmp_path):
    jalgo, talgo, idx = _pair(tmp_path, JMARWILConfig, MARWILConfig,
                              beta=2.0)
    np.testing.assert_array_equal(talgo._data["returns"].numpy(),
                                  np.asarray(jalgo._returns))
    st = jalgo._anakin_state
    jtotal, (jpl, jvl, jnorm) = closure(jalgo._train_step, "loss_fn")(
        st.params, st.ma_adv_norm, jalgo._obs[idx], jalgo._actions[idx],
        jalgo._returns[idx])
    out = talgo.sgd_update(torch.from_numpy(idx))
    for got, want in ((out["total_loss"], jtotal),
                      (out["policy_loss"], jpl), (out["vf_loss"], jvl),
                      (talgo.ma_adv_norm, jnorm)):
        np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL)
    jalgo._anakin_state, *_ = jalgo._train_step(st)
    _assert_params_close(talgo, jalgo._anakin_state.params)
    np.testing.assert_allclose(talgo.ma_adv_norm.item(),
                               float(jalgo._anakin_state.ma_adv_norm),
                               rtol=LOSS_RTOL)


def test_marwil_with_beta_zero_has_bcs_loss(tmp_path):
    jalgo, bc, idx = _pair(tmp_path, JBCConfig, BCConfig)
    cfg = (MARWILConfig().environment("CartPole-v1")
           .offline_data(input_=bc.config.offline_input)
           .resources(device="cpu").debugging(seed=0))
    cfg.beta = 0.0
    marwil = cfg.build()
    marwil.module.load_state_dict(bc.module.state_dict())
    batch = {k: v[torch.from_numpy(idx)] for k, v in marwil._data.items()}
    with torch.no_grad():
        bc_loss, _ = bc.loss(batch)
        _, aux = marwil.loss(batch)
    assert torch.equal(aux["policy_loss"], bc_loss)
    jloss = closure(jalgo._train_step, "loss_fn")(
        jalgo._anakin_state.params, jalgo._obs[idx], jalgo._actions[idx])
    np.testing.assert_allclose(aux["policy_loss"].item(), float(jloss),
                               rtol=LOSS_RTOL)


def scripted_cartpole_data(path, frac_random: float, seed: int = 0) -> str:
    """tests/test_more_algos.py's mixture dataset on the port's env and
    draws: a balancing heuristic diluted with random actions, 32 envs x
    96 steps, env-major, each env's last step marked done."""
    env = CartPole()
    g = torch.Generator().manual_seed(seed)
    states, obs = vector_reset(env, g, 32, "cpu")
    cols = {"obs": [], "actions": [], "rewards": [], "dones": []}
    for _ in range(96):
        good = (obs[:, 2] + 0.3 * obs[:, 3] > 0).to(torch.int64)
        rand = torch.randint(0, 2, good.shape, generator=g)
        use_rand = torch.rand(good.shape, generator=g) < frac_random
        act = torch.where(use_rand, rand, good)
        states, obs2, rew, done, _ = vector_step(env, states, act, g)
        cols["obs"].append(obs.numpy())
        cols["actions"].append(act.numpy())
        cols["rewards"].append(rew.numpy())
        cols["dones"].append(done.numpy().astype(np.float32))
        obs = obs2
    cols["dones"][-1] = np.ones(32, np.float32)
    stacked = {k: np.stack(v, 1).reshape(-1, *np.asarray(v[0]).shape[1:])
               for k, v in cols.items()}
    w = JsonWriter(str(path))
    w.write(SampleBatch(stacked))
    w.close()
    return str(path)


def test_marwil_learns_from_mixed_data(tmp_path):
    """tests/test_more_algos.py's gate: >= 250 after 40 iterations on
    60%-random demonstrations, beta 2."""
    path = scripted_cartpole_data(tmp_path / "mix", frac_random=0.6)
    cfg = (MARWILConfig().environment("CartPole-v1")
           .offline_data(input_=path).training(lr=1e-3)
           .resources(device="cpu").debugging(seed=0))
    cfg.beta = 2.0
    algo = cfg.build()
    for _ in range(40):
        m = algo.train()
    assert np.isfinite(m["marwil_loss"]) and m["ma_adv_norm"] > 0
    score = algo.evaluate(num_steps=500)["episode_reward_mean"]
    assert score >= 250, f"MARWIL clone too weak: {score}"


def test_marwil_weighting_prefers_high_advantage_actions(tmp_path):
    """tests/test_more_algos.py's property: on one state where action 0
    returned 10 and action 1 returned 0, BC stays near 0.5 and MARWIL
    (beta 2) puts more than 0.8 on action 0."""
    obs = np.tile(np.array([[0.1, 0.0, 0.05, 0.0]], np.float32), (64, 1))
    actions = np.array([0, 1] * 32, np.int64)
    w = JsonWriter(str(tmp_path / "bandit"))
    w.write(SampleBatch({"obs": obs, "actions": actions,
                         "rewards": np.where(actions == 0, 10.0, 0.0)
                         .astype(np.float32),
                         "dones": np.ones(64, np.float32)}))
    w.close()

    def p_action0(beta):
        cfg = (MARWILConfig().environment("CartPole-v1")
               .offline_data(input_=str(tmp_path / "bandit"))
               .training(lr=1e-2).resources(device="cpu").debugging(seed=0))
        cfg.beta = beta
        algo = cfg.build()
        for _ in range(10):
            algo.train()
        with torch.no_grad():
            logp, _, _ = algo.module.forward_train(
                torch.from_numpy(obs[:1]), torch.zeros(1, dtype=torch.int64))
        return float(logp.exp()[0])

    p_bc, p_marwil = p_action0(0.0), p_action0(2.0)
    assert abs(p_bc - 0.5) < 0.1, f"BC should stay near 0.5, got {p_bc}"
    assert p_marwil > 0.8, f"MARWIL should prefer action 0, got {p_marwil}"


def expert_data(path, expert, seed=3, num_envs=32, steps=64) -> str:
    """The expert's greedy rollout (tests/test_sac_offline.py's 32 envs x
    64 steps), written with JsonWriter."""
    env = CartPole()
    device = next(expert.module.parameters()).device
    g = torch.Generator(device=device).manual_seed(seed)
    states, obs = vector_reset(env, g, num_envs, device)
    all_obs, all_act = [], []
    with torch.no_grad():
        for _ in range(steps):
            act = expert.module.forward_inference(obs)
            states, obs2, _r, _d, _ = vector_step(env, states, act, g)
            all_obs.append(obs.cpu().numpy())
            all_act.append(act.cpu().numpy())
            obs = obs2
    w = JsonWriter(str(path))
    w.write(SampleBatch({"obs": np.concatenate(all_obs),
                         "actions": np.concatenate(all_act)}))
    w.close()
    return str(path)


def test_bc_clones_expert_cartpole(tmp_path):
    """tests/test_sac_offline.py's gate: a PPO expert (best >= 150, up to
    400 within 80 iterations), its greedy rollouts written, BC for 30
    iterations: bc_loss < 0.3 and a greedy score >= 100."""
    expert = (PPOConfig().environment("CartPole-v1")
              .anakin(num_envs=32, unroll_length=64)
              .training(lr=3e-4, num_sgd_iter=4, sgd_minibatch_size=512,
                        entropy_coeff=0.01)
              .resources(device="cpu").debugging(seed=0).build())
    best = 0.0
    for _ in range(80):
        r = expert.train()["episode_reward_mean"]
        if r == r:
            best = max(best, r)
        if best >= 400:
            break
    assert best >= 150, f"expert never got good: {best}"
    path = expert_data(tmp_path / "expert", expert)
    bc = (BCConfig().environment("CartPole-v1").offline_data(input_=path)
          .training(lr=1e-3).resources(device="cpu").debugging(seed=0)
          .build())
    for _ in range(30):
        m = bc.train()
    assert m["bc_loss"] < 0.3, f"BC did not fit the data: {m}"
    score = bc.evaluate(num_steps=500)["episode_reward_mean"]
    assert score >= 100, f"BC clone scored {score}"


def test_offline_algorithms_need_data_and_refuse_a_mesh():
    with pytest.raises(ValueError, match="offline_data"):
        BCConfig().resources(device="cpu").build()
    with pytest.raises(ValueError, match="offline_data"):
        MARWILConfig().resources(device="cpu").build()
