"""The actor path's batches, GAE and learner against the JAX package's.

- ``SampleBatch``/``MultiAgentBatch`` (a numpy copy): every method gives
  the JAX package's arrays bit for bit on the same arrays and seed.
- GAE: the numpy ``compute_gae`` equals the JAX package's bit for bit and
  ``gae_jax`` to 1e-6; the rollout worker's GAE columns (``gae_torch`` on
  CPU tensors) match ``gae_jax`` to 1e-6.
- ``TorchLearner`` against ``JaxLearner`` (converted weights, the same
  batches): after 1 and after 3 updates, with the PPO loss and with the
  IMPALA time-major loss, the loss and every parameter agree to 1e-5
  relative.  Adam's fp32 bias correction rounds differently in optax
  and torch (ROADMAP, Queue 3), well inside that bound.
"""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import optax

from ray_tpu.rllib.algorithms import impala as jimpala
from ray_tpu.rllib.algorithms import ppo as jppo
from ray_tpu.rllib.core.learner import JaxLearner
from ray_tpu.rllib.core.rl_module import RLModuleSpec as JSpec
from ray_tpu.rllib.evaluation import postprocessing as jpost
from ray_tpu.rllib.policy import sample_batch as jsb
from ray_tpu_torch.models.convert import actor_critic_from_flax
from ray_tpu_torch.rllib import RLModuleSpec
from ray_tpu_torch.rllib.algorithms import impala as timpala
from ray_tpu_torch.rllib.algorithms import ppo as tppo
from ray_tpu_torch.rllib.core import learner as tlearner
from ray_tpu_torch.rllib.evaluation import postprocessing as tpost
from ray_tpu_torch.rllib.evaluation.worker_set import fragment_batch
from ray_tpu_torch.rllib.policy import sample_batch as tsb

GAE_ATOL = 1e-6
# Learner parity: the same fp32 forward, gradient and clip + Adam in two
# frameworks; their sums and Adam's bias correction round differently by
# a few ulp a step.  Held to 1e-5 relative, with an absolute floor of
# 1e-7 for parameters near zero.
LEARNER_RTOL, LEARNER_ATOL = 1e-5, 1e-7


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def _same_batch(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        _same(a[k], b[k])


def _columns(rng, n, eps_lengths=None):
    cols = {"obs": rng.normal(size=(n, 3)).astype(np.float32),
            "actions": rng.integers(0, 2, n),
            "rewards": rng.normal(size=n).astype(np.float32)}
    if eps_lengths is not None:
        cols["eps_id"] = np.repeat(np.arange(len(eps_lengths)), eps_lengths)
    return cols


# ---- SampleBatch ------------------------------------------------------------

def test_sample_batch_methods_match():
    rng = np.random.default_rng(0)
    cols = _columns(rng, 17, eps_lengths=[5, 1, 7, 4])
    j, t = jsb.SampleBatch(cols), tsb.SampleBatch(cols)
    assert len(j) == len(t) == t.count == 17
    _same_batch(j.shuffle(3), t.shuffle(3))
    _same_batch(j.slice(2, 9), t.slice(2, 9))
    for a, b in zip(j.minibatches(4), t.minibatches(4)):
        _same_batch(a, b)
    assert len(list(t.minibatches(4))) == 4  # the remainder is dropped
    ja, ta = j.split_by_episode(), t.split_by_episode()
    assert [len(x) for x in ta] == [5, 1, 7, 4]
    for a, b in zip(ja, ta):
        _same_batch(a, b)
    for states in (None, ["obs"]):
        _same_batch(j.to_sequences(3, states), t.to_sequences(3, states))
    _same_batch(jsb.SampleBatch({"x": np.zeros((0, 2))}).to_sequences(4),
                tsb.SampleBatch({"x": np.zeros((0, 2))}).to_sequences(4))
    _same(jsb.SampleBatch.sequence_mask(np.array([3, 1, 0]), 4),
          tsb.SampleBatch.sequence_mask(np.array([3, 1, 0]), 4))
    parts = [_columns(rng, n) for n in (4, 6, 2)]
    _same_batch(jsb.SampleBatch.concat_samples(
        [jsb.SampleBatch(p) for p in parts]),
        tsb.SampleBatch.concat_samples([tsb.SampleBatch(p) for p in parts]))
    with pytest.raises(ValueError, match="identical columns"):
        tsb.SampleBatch.concat_samples([tsb.SampleBatch({"a": [1]}),
                                        tsb.SampleBatch({"b": [1]})])


def test_concat_samples_into_reuses_buffers():
    def frags():
        return [tsb.SampleBatch({"obs": np.arange(8, dtype=np.float32
                                                  ).reshape(4, 2) + i,
                                 "rewards": np.full(4, float(i), np.float32)})
                for i in range(3)]

    a = tsb.SampleBatch.concat_samples_into(frags(), None)
    _same_batch(a, tsb.SampleBatch.concat_samples(frags()))
    ids = {k: id(v) for k, v in a.items()}
    b = tsb.SampleBatch.concat_samples_into(frags(), a)
    assert {k: id(v) for k, v in b.items()} == ids  # arrays reused
    _same_batch(b, tsb.SampleBatch.concat_samples(frags()))
    bigger = [tsb.SampleBatch({"obs": np.ones((6, 2), np.float32),
                               "rewards": np.ones(6, np.float32)})]
    c = tsb.SampleBatch.concat_samples_into(bigger, b)
    assert len(c) == 6 and id(c["obs"]) != ids["obs"]


def test_to_tensors_matches_as_jax():
    rng = np.random.default_rng(1)
    cols = _columns(rng, 6)
    jt = jsb.SampleBatch(cols).as_jax()
    tt = tsb.SampleBatch(cols).to_tensors("cpu")
    for k in cols:
        assert tt[k].device.type == "cpu"
        np.testing.assert_array_equal(np.asarray(jt[k]), tt[k].numpy())


def test_multi_agent_batch_matches():
    rng = np.random.default_rng(2)
    agents = {a: _columns(rng, n) for a, n in (("a0", 3), ("a1", 4),
                                              ("b0", 2))}

    def mapping(agent):
        return agent[0]

    out = []
    for mod in (jsb, tsb):
        mb = mod.MultiAgentBatch.from_agent_batches(
            {a: mod.SampleBatch(c) for a, c in agents.items()}, mapping, 7)
        both = mod.MultiAgentBatch.concat_samples([mb, mb])
        out.append((mb, both))
    for j, t in zip(*out):
        assert (t.env_steps(), t.agent_steps()) == (j.env_steps(),
                                                    j.agent_steps())
        assert sorted(t.policy_batches) == sorted(j.policy_batches)
        for pid in j.policy_batches:
            _same_batch(j.policy_batches[pid], t.policy_batches[pid])
    assert repr(out[1][1]) == repr(out[0][1])


# ---- GAE --------------------------------------------------------------------

def _gae_inputs(seed, T=48, N=6):
    rng = np.random.default_rng(seed)
    rewards = rng.normal(size=(T, N)).astype(np.float32)
    values = rng.normal(size=(T, N)).astype(np.float32)
    dones = rng.random((T, N)) < 0.1
    last = rng.normal(size=N).astype(np.float32)
    return rewards, values, dones, last


def test_compute_gae_matches():
    rewards, values, dones, last = _gae_inputs(0)
    col = {"rewards": rewards[:, 0], "vf_preds": values[:, 0],
           "dones": dones[:, 0]}
    j = jpost.compute_gae(jsb.SampleBatch(col), float(last[0]), 0.99, 0.9)
    t = tpost.compute_gae(tsb.SampleBatch(col), float(last[0]), 0.99, 0.9)
    _same_batch(j, t)
    adv, vtarg = jpost.gae_jax(jnp.asarray(rewards[:, :1]),
                               jnp.asarray(values[:, :1]),
                               jnp.asarray(dones[:, :1], jnp.float32),
                               jnp.asarray(last[:1]), 0.99, 0.9)
    np.testing.assert_allclose(t["advantages"], np.asarray(adv)[:, 0],
                               rtol=0, atol=GAE_ATOL)
    np.testing.assert_allclose(t["value_targets"], np.asarray(vtarg)[:, 0],
                               rtol=0, atol=GAE_ATOL)


def test_worker_gae_columns_match_gae_jax():
    rewards, values, dones, last = _gae_inputs(1)
    T, N = rewards.shape
    rng = np.random.default_rng(9)
    cols = {"obs": rng.normal(size=(T, N, 4)).astype(np.float32),
            "actions": rng.integers(0, 2, (T, N)),
            "action_logp": rng.normal(size=(T, N)).astype(np.float32),
            "vf_preds": values, "rewards": rewards, "dones": dones}
    batch = fragment_batch("gae", cols, last, 0.999, 0.95)
    adv, vtarg = jpost.gae_jax(rewards, values, dones.astype(np.float32),
                               last, 0.999, 0.95)
    np.testing.assert_allclose(batch["advantages"],
                               np.asarray(adv).reshape(-1), rtol=0,
                               atol=GAE_ATOL)
    np.testing.assert_allclose(batch["value_targets"],
                               np.asarray(vtarg).reshape(-1), rtol=0,
                               atol=GAE_ATOL)
    assert batch["obs"].shape == (T * N, 4)
    _same(batch["dones"], dones.reshape(-1))
    tm = fragment_batch("timemajor", cols, last, 0.999, 0.95)
    assert tm["dones"].dtype == np.float32 and tm["obs"].shape == (T, N, 4)
    with pytest.raises(ValueError, match="fragment kind"):
        fragment_batch("bogus", cols, last, 0.99, 0.95)


# ---- the learner ------------------------------------------------------------

PPO_COEFFS = dict(clip_param=0.2, vf_clip_param=10.0, vf_loss_coeff=0.5,
                  entropy_coeff=0.01)
IMPALA_COEFFS = dict(gamma=0.99, clip_rho=1.0, clip_c=1.0,
                     vf_loss_coeff=0.5, entropy_coeff=0.01)


def _ppo_batches(rng, n=3, size=64):
    return [{"obs": rng.normal(size=(size, 4)).astype(np.float32),
             "actions": rng.integers(0, 2, size).astype(np.int32),
             "action_logp": (-0.69 + 0.1 * rng.normal(size=size)
                             ).astype(np.float32),
             "advantages": rng.normal(size=size).astype(np.float32),
             "value_targets": rng.normal(size=size).astype(np.float32)}
            for _ in range(n)]


def _impala_batches(rng, n=3, T=8, N=4):
    return [{"obs": rng.normal(size=(T, N, 4)).astype(np.float32),
             "actions": rng.integers(0, 2, (T, N)).astype(np.int32),
             "behaviour_logp": (-0.69 + 0.1 * rng.normal(size=(T, N))
                                ).astype(np.float32),
             "rewards": np.ones((T, N), np.float32),
             "dones": (rng.random((T, N)) < 0.1).astype(np.float32),
             "last_value": rng.normal(size=N).astype(np.float32)}
            for _ in range(n)]


@pytest.mark.parametrize("kind", ["ppo", "impala"])
def test_torch_learner_matches_jax_learner(kind):
    rng = np.random.default_rng(4)
    lr, clip = 5e-3, 0.5
    jspec = JSpec(obs_dim=4, num_actions=2, hiddens=(32, 32))
    if kind == "ppo":
        jloss = functools.partial(jppo.ppo_loss, **PPO_COEFFS)
        tloss = functools.partial(tppo.ppo_loss, **PPO_COEFFS)
        batches = _ppo_batches(rng)
    else:
        jloss = functools.partial(jimpala.impala_loss, **IMPALA_COEFFS)
        tloss = timpala.time_major_loss(
            functools.partial(timpala.impala_objective, vf_loss_coeff=0.5,
                              entropy_coeff=0.01),
            gamma=0.99, clip_rho=1.0, clip_c=1.0)
        batches = _impala_batches(rng)
    jl = JaxLearner(jspec.build(), jloss,
                    optimizer=optax.chain(optax.clip_by_global_norm(clip),
                                          optax.adam(lr)),
                    example_obs=jspec.example_obs(), seed=3)
    module = RLModuleSpec(obs_dim=4, num_actions=2, hiddens=(32, 32)).build()
    module.load_state_dict(actor_critic_from_flax(jl.get_weights()))
    tl = tlearner.TorchLearner(module, tloss, lr=lr, grad_clip=clip,
                               device="cpu")
    for step, batch in enumerate(batches):
        jm = jl.update(batch)
        tm = tlearner.metrics_to_host(tl.update(batch))
        jm = tlearner.metrics_to_host({k: torch.tensor(float(v))
                                       for k, v in jm.items()})
        assert sorted(jm) == sorted(tm)
        for k in jm:
            np.testing.assert_allclose(tm[k], jm[k], rtol=LEARNER_RTOL,
                                       atol=LEARNER_ATOL, err_msg=k)
        if step in (0, 2):  # after 1 and after 3 updates
            want = actor_critic_from_flax(jl.get_weights())
            got = tl.get_weights()
            assert sorted(want) == sorted(got)
            for name in want:
                np.testing.assert_allclose(
                    got[name].numpy(), want[name].numpy(),
                    rtol=LEARNER_RTOL, atol=LEARNER_ATOL,
                    err_msg=f"{name} after {step + 1} updates")


def test_learner_weights_round_trip_and_copy():
    module = RLModuleSpec(obs_dim=4, num_actions=2, hiddens=(8,)).build(
        torch.Generator().manual_seed(0))
    tl = tlearner.TorchLearner(
        module, functools.partial(tppo.ppo_loss, **PPO_COEFFS), lr=1e-2,
        device="cpu")
    before = tl.get_weights()
    metrics = tl.update(_ppo_batches(np.random.default_rng(0), 1)[0])
    assert all(isinstance(v, torch.Tensor) and v.dim() == 0
               for v in metrics.values())
    after = tl.get_weights()
    assert any(not torch.equal(before[k], after[k]) for k in before)
    tl.set_weights(before)
    assert all(torch.equal(before[k], v) for k, v in tl.get_weights().items())
    group = tlearner.LearnerGroup(tl)
    assert set(group.get_weights()) == set(before)
    group.shutdown()


def test_learner_takes_read_only_arrays():
    """Object-store views arrive read-only: the learner copies them."""
    tl = tlearner.TorchLearner(
        RLModuleSpec(obs_dim=4, num_actions=2, hiddens=(8,)).build(),
        functools.partial(tppo.ppo_loss, **PPO_COEFFS), device="cpu")
    batch = _ppo_batches(np.random.default_rng(1), 1)[0]
    for v in batch.values():
        v.flags.writeable = False
    assert np.isfinite(tlearner.metrics_to_host(
        tl.update(batch))["total_loss"])


def test_learner_defaults_to_cuda_and_distributed_group_raises():
    module = RLModuleSpec(obs_dim=4, num_actions=2).build()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tlearner.TorchLearner(module, tppo.ppo_loss)
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        tlearner.DistributedLearnerGroup(lambda: None, num_hosts=2)
