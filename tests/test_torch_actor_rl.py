"""Actor-mode RL of the port: CPU rollout actors, the streaming sample
plane and the learner, against the JAX package where they can be held to
it and on the port's runtime where they cannot.

- Fragments: ``collect_fragment`` under a deterministic ``act_fn`` gives
  the JAX package's columns byte for byte, with and without the
  preallocated buffers; the port's policy gives the JAX module's
  log-probabilities and values on a fragment's observations (converted
  weights, 1e-6).
- The runtime (one port cluster for the module, every get bounded):
  ``RolloutWorker`` versioning, ``WorkerSet`` replacing a SIGKILLed
  worker, one put per weights version, the stream's liveness under
  SIGKILL, the staleness gate, PPO (lockstep and streaming), IMPALA and
  APPO in actor mode for 3 iterations (``tests/test_rllib_actor_path.py``'s
  runs), a lockstep run repeating itself bit for bit, the checkpoint
  round trip, and the refusals.
- The learning gates are ``slow``, as in the JAX package: CartPole to 100
  and LunarLander to -50 (``tests/test_real_env.py``'s floor).
"""
import os
import signal
import time

import numpy as np
import pytest
import torch

import jax

from ray_tpu.rllib.core.rl_module import RLModuleSpec as JSpec
from ray_tpu.rllib.env import py_envs as jenvs
from ray_tpu.rllib.evaluation import worker_set as jws
from ray_tpu_torch.models.convert import actor_critic_from_flax
from ray_tpu_torch.rllib.env import py_envs as tenvs
from ray_tpu_torch.rllib.evaluation import worker_set as tws

T = 120  # seconds: the bound of every get
POLICY_ATOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fake_act(obs, key):
    """Deterministic numpy policy: ignores the key, exercises every
    column dtype (int actions, float32 logp/values)."""
    s = obs.sum(axis=-1)
    action = (s > 0).astype(np.int32)
    logp = np.full(obs.shape[0], -0.69, np.float32)
    value = s.astype(np.float32)
    return action, logp, value


def _fragment(envs, ws, bufs, T_=50, N=4, fragments=3):
    env = envs.VectorEnv(lambda: envs.PyCartPole(), N, seed=5)
    obs = env.reset_all().astype(np.float32)
    ep, completed, out = np.zeros(N), [], []
    for _ in range(fragments):
        # The reference takes one key a step, the port a step count and
        # one generator.
        steps = ([None] * T_,) if ws is jws else (T_, None)
        obs, cols = ws.collect_fragment(
            env, _fake_act, obs, *steps, ep, completed,
            bufs=bufs, cast=lambda o: o.astype(np.float32))
        out.append({k: v.copy() for k, v in cols.items()})
    env.close()
    return obs, out, completed


@pytest.mark.parametrize("buffers", [False, True])
def test_collect_fragment_byte_identical_to_jax(buffers):
    ref = _fragment(jenvs, jws, jws.FragmentBuffers(50) if buffers
                    else None)
    port = _fragment(tenvs, tws, tws.FragmentBuffers(50) if buffers
                     else None)
    legacy = _fragment(tenvs, tws, None)
    for other in (ref, legacy):
        assert other[2] == port[2] and port[2]  # episodes completed
        assert other[0].tobytes() == port[0].tobytes()
        for a, b in zip(other[1], port[1]):
            assert sorted(a) == sorted(b)
            for k in a:
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
                assert a[k].tobytes() == b[k].tobytes(), k


def test_fragment_buffers_reused_across_fragments():
    env = tenvs.VectorEnv(lambda: tenvs.PyCartPole(), 3, seed=1)
    obs = env.reset_all().astype(np.float32)
    bufs = tws.FragmentBuffers(6)
    ep, completed = np.zeros(3), []
    obs, cols1 = tws.collect_fragment(env, _fake_act, obs, 6, None, ep,
                                      completed, bufs=bufs)
    ids1 = {k: id(v) for k, v in cols1.items()}
    obs, cols2 = tws.collect_fragment(env, _fake_act, obs, 6, None, ep,
                                      completed, bufs=bufs)
    assert {k: id(v) for k, v in cols2.items()} == ids1
    env.close()


def test_policy_logp_and_value_on_a_fragment_match_jax():
    from ray_tpu_torch.rllib import RLModuleSpec

    jspec = JSpec(obs_dim=4, num_actions=2, hiddens=(64, 64))
    jmodule = jspec.build()
    params = jmodule.init(jax.random.PRNGKey(3), jspec.example_obs())
    module = RLModuleSpec(obs_dim=4, num_actions=2, hiddens=(64, 64)).build()
    module.load_state_dict(actor_critic_from_flax(params))
    _, cols, _ = _fragment(tenvs, tws, None, T_=32, N=8, fragments=1)
    obs = cols[0]["obs"].reshape(-1, 4)
    actions = np.random.default_rng(0).integers(0, 2, len(obs))
    jlogp, jvalue, jent = jmodule.forward_train(params, obs, actions)
    with torch.inference_mode():
        logp, value, ent = module.forward_train(torch.from_numpy(obs),
                                                torch.from_numpy(actions))
    for got, want in ((logp, jlogp), (value, jvalue), (ent, jent)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=POLICY_ATOL)


# ---- the runtime ------------------------------------------------------------

@pytest.fixture(scope="module")
def cluster():
    import ray_tpu_torch

    ray_tpu_torch.init(num_cpus=8, object_store_memory=256 * 1024**2)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def _config(num_workers=2, num_envs=2, fragment=8, **rollouts):
    from ray_tpu_torch.rllib import PPOConfig

    return (PPOConfig().environment("CartPole-v1")
            .rollouts(num_rollout_workers=num_workers,
                      num_envs_per_worker=num_envs,
                      rollout_fragment_length=fragment, mode="actor",
                      **rollouts)
            .training(model={"fcnet_hiddens": [16]})
            .resources(device="cpu"))


def _weights(config):
    from ray_tpu_torch.rllib import RLModuleSpec

    spec = RLModuleSpec.for_env(tenvs.make_py_env("CartPole-v1"),
                                tuple(config.hiddens))
    module = spec.build(torch.Generator().manual_seed(0))
    return spec, {k: v.clone() for k, v in module.state_dict().items()}


def _make_stream(num_workers=2, num_envs=2, fragment=8, k=2,
                 staleness=None):
    from ray_tpu_torch.rllib.evaluation.sample_stream import SampleStream

    config = _config(num_workers, num_envs, fragment)
    spec, weights = _weights(config)
    workers = tws.WorkerSet(config, spec)
    stream = SampleStream(workers, kind="gae", max_in_flight_per_worker=k,
                          max_weight_staleness=staleness)
    return workers, stream, weights


def test_sample_batch_gather_through_the_store(cluster):
    from ray_tpu_torch.rllib.policy.sample_batch import SampleBatch

    rng = np.random.default_rng(0)
    parts = [SampleBatch({"obs": rng.normal(size=(n, 4)).astype(np.float32),
                          "actions": rng.integers(0, 2, n)})
             for n in (3, 5, 2)]
    refs = [cluster.put(b) for b in parts]
    got = SampleBatch.gather_concat(refs)
    want = SampleBatch.concat_samples(parts)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].tobytes() == want[k].tobytes()


def test_rollout_worker_versioning(cluster):
    config = _config(num_workers=1, num_envs=3, fragment=5)
    spec, weights = _weights(config)
    w = tws.RolloutWorker.remote("CartPole-v1", spec, 0, 3, 5, 0.99, 0.95,
                                 0)
    try:
        with pytest.raises(cluster.exceptions.RayTpuError,
                           match="before any set_weights"):
            cluster.get(w.sample_fragment.remote("gae"), timeout=T)
        assert cluster.get(w.set_weights.remote(weights, 7), timeout=T) == 7
        batch, completed, info = cluster.get(
            w.sample_fragment.remote("gae"), timeout=T)
        assert info["weights_version"] == 7 and info["env_steps"] == 15
        assert len(batch) == 15 and batch["obs"].dtype == np.float32
        assert int(batch["dones"].sum()) == len(completed)
        ref = cluster.put(weights)
        assert cluster.get(w.set_weights.remote(ref, 8), timeout=T) == 8
        tm, _, info = cluster.get(w.sample_fragment.remote("timemajor"),
                                  timeout=T)
        assert tm["obs"].shape == (5, 3, 4) and tm["last_value"].shape == (3,)
        assert info["weights_version"] == 8
        gae, _ = cluster.get(w.sample.remote(), timeout=T)
        assert set(gae) >= {"advantages", "value_targets"}
    finally:
        cluster.kill(w)


def test_worker_set_replaces_a_sigkilled_worker(cluster):
    config = _config(num_envs=2, fragment=16)
    spec, weights = _weights(config)
    ws = tws.WorkerSet(config, spec)
    try:
        ws.sync_weights(weights)
        batches, _ = ws.sample_sync()
        assert len(batches) == 2 and ws.num_healthy_workers == 2
        old = ws.workers[0]
        os.kill(cluster.get(old.pid.remote(), timeout=T), signal.SIGKILL)
        # The runtime restarts the actor once (max_restarts=1) without
        # weights, so it fails again: past two strikes it is replaced and
        # given the current version.
        deadline = time.monotonic() + T
        batches = []
        while time.monotonic() < deadline and (len(batches) < 2
                                               or ws.workers[0] is old):
            batches, _ = ws.sample_sync()
        assert ws.workers[0] is not old and ws.num_replaced >= 1
        assert len(batches) == 2, "the replacement never sampled"
        assert ws.probe_health() == 2
    finally:
        ws.stop()


def test_stream_broadcast_is_one_put_per_version(cluster, monkeypatch):
    workers, stream, weights = _make_stream(fragment=4)
    try:
        puts = []
        put = cluster.put

        def counting_put(value):
            puts.append(1)
            return put(value)

        monkeypatch.setattr(cluster, "put", counting_put)
        for _ in range(3):
            stream.publish_weights(weights)
        monkeypatch.undo()
        assert len(puts) == 3, f"{len(puts)} puts for 3 versions"
        frag = stream.next_fragment(timeout=T)
        assert frag is not None and frag.weights_version >= 1
    finally:
        stream.close()
        workers.stop()


def test_stream_liveness_under_worker_sigkill(cluster):
    """A worker SIGKILLed mid-stream must not stall the stream, and every
    consumed fragment carries exactly the returns of the episodes that
    ended in it (sum(dones) == len(returns): nothing counted twice).

    The kill reaches the driver when the runtime sees the worker's
    channel close, 0.03-1.1 s later on an idle host, and the other worker
    may deliver more than six small fragments first: so the loop runs
    until it has both six fragments and the failure, within the
    deadline."""
    workers, stream, weights = _make_stream(fragment=8)
    try:
        stream.publish_weights(weights)
        for _ in range(2):
            frag = stream.next_fragment(timeout=T)
            assert frag is not None
            assert int(frag.batch["dones"].sum()) == \
                len(frag.episode_returns)
        os.kill(cluster.get(workers.workers[0].pid.remote(), timeout=T),
                signal.SIGKILL)
        consumed = 0
        deadline = time.monotonic() + T
        while (consumed < 6 or stream.failures_seen < 1) and \
                time.monotonic() < deadline:
            frag = stream.next_fragment(timeout=T)
            if frag is None:
                break
            assert int(frag.batch["dones"].sum()) == \
                len(frag.episode_returns)
            consumed += 1
        assert consumed >= 6, (
            f"stream stalled after SIGKILL: {consumed} fragments, "
            f"stats={stream.stats()}")
        assert stream.failures_seen >= 1
    finally:
        stream.close()
        workers.stop()


def test_stream_consumes_every_worker(cluster):
    """The stream takes the oldest dispatch first.  The consumer here is
    slower than the workers, as a learner is, so every fragment in flight
    is ready when it asks: listed worker by worker, ``wait`` would then
    always hand back worker 0's and worker 1's would never be consumed."""
    workers, stream, weights = _make_stream(fragment=4, k=2)
    try:
        assert workers.probe_health() == 2
        stream.publish_weights(weights)
        seen = []
        for _ in range(8):
            frag = stream.next_fragment(timeout=T)
            assert frag is not None
            seen.append(frag.worker_index)
            time.sleep(0.2)  # the learner's step
        assert set(seen) == {0, 1}, seen
    finally:
        stream.close()
        workers.stop()


def test_stream_staleness_bound_enforced(cluster):
    """With max_weight_staleness=1, fragments produced under weights more
    than one version behind the latest publish are dropped before the
    learner sees them.  The actor mailbox is FIFO, so the v1 fragments
    queued before the v2/v3 publishes are exactly the stale set."""
    workers, stream, weights = _make_stream(fragment=4, k=2, staleness=1)
    try:
        # Every worker up before v1: a worker still starting delivers its
        # v1 fragments only after the other has delivered the 10 the loop
        # below allows (each takes milliseconds), so they would never be
        # seen.
        assert workers.probe_health() == 2
        stream.publish_weights(weights)           # v1
        first = stream.next_fragment(timeout=T)
        assert first is not None and first.weights_version == 1
        stream.publish_weights(weights)           # v2
        stream.publish_weights(weights)           # v3
        # The 3 in-flight v1 fragments (one window popped once, one still
        # full) are dropped as the consumer encounters them; everything
        # actually consumed satisfies the bound.
        consumed = 0
        deadline = time.monotonic() + T
        while stream.stale_dropped < 3 and consumed < 10 and \
                time.monotonic() < deadline:
            frag = stream.next_fragment(timeout=T)
            assert frag is not None
            assert stream.weights_version - frag.weights_version <= 1, \
                stream.stats()
            consumed += 1
        assert stream.stale_dropped == 3, stream.stats()
    finally:
        stream.close()
        workers.stop()


def _train(config, iters):
    algo = config.build()
    try:
        return [algo.train() for _ in range(iters)], algo
    except BaseException:
        algo.stop()
        raise


@pytest.mark.parametrize("streaming", [False, True],
                         ids=["lockstep", "streaming"])
def test_ppo_actor_mode_runs(cluster, streaming):
    """tests/test_rllib_actor_path.py::test_ppo_actor_mode_runs."""
    from ray_tpu_torch.rllib import PPOConfig

    config = (PPOConfig().environment("CartPole-v1")
              .rollouts(num_rollout_workers=2, num_envs_per_worker=4,
                        rollout_fragment_length=64,
                        sample_streaming=streaming)
              .training(num_sgd_iter=2, sgd_minibatch_size=128, lr=5e-4)
              .resources(device="cpu"))
    results, algo = _train(config, 3)
    try:
        result = results[-1]
        assert algo.config.mode == "actor"
        assert algo.learner.device.type == "cpu"
        assert np.isfinite(result["total_loss"])
        assert result["num_env_steps_sampled"] >= 3 * 2 * 4 * 64
        assert ("rollout_weight_lag_max" in result) == streaming
        with pytest.raises(NotImplementedError, match="anakin"):
            algo.evaluate(10)
    finally:
        algo.stop()


@pytest.mark.parametrize("name", ["IMPALA", "APPO"])
def test_impala_family_actor_mode_runs(cluster, name):
    """tests/test_rllib_actor_path.py::test_impala_actor_mode_runs, and
    the same for APPO (which takes IMPALA's actor path)."""
    from ray_tpu_torch import rllib

    config = (getattr(rllib, f"{name}Config")()
              .environment("CartPole-v1")
              .rollouts(num_rollout_workers=2, num_envs_per_worker=4,
                        rollout_fragment_length=32)
              .training(lr=5e-4).resources(device="cpu"))
    results, algo = _train(config, 3)
    try:
        result = results[-1]
        assert np.isfinite(result["total_loss"])
        assert result["num_env_steps_sampled"] == 3 * 2 * 4 * 32
        assert result["rollout_weight_lag_max"] <= \
            algo.config.max_weight_staleness
    finally:
        algo.stop()


def test_lockstep_ppo_repeats_itself_bit_for_bit(cluster):
    """The same seed in lockstep mode: the same losses and weights twice
    (seeded envs, worker generators and minibatch shuffles; the barrier
    fixes which weights each fragment acts under)."""
    runs = []
    for _ in range(2):
        results, algo = _train(_config(num_envs=4, fragment=32,
                                       sample_streaming=False)
                               .training(sgd_minibatch_size=64,
                                         num_sgd_iter=2), 2)
        try:
            runs.append(([r["total_loss"] for r in results],
                         algo.learner.get_weights()))
        finally:
            algo.stop()
    (losses_a, weights_a), (losses_b, weights_b) = runs
    assert losses_a == losses_b
    assert all(torch.equal(weights_a[k], weights_b[k]) for k in weights_a)


def test_checkpoint_round_trip(cluster):
    """save_checkpoint -> load_checkpoint into a second algorithm: the
    learner's weights equal bit for bit, and the next fragments act under
    the new version."""
    config = _config(num_envs=4, fragment=16, sample_streaming=False)
    _, a = _train(config, 2)
    try:
        ckpt = a.save_checkpoint()
        saved = a.learner.get_weights()
    finally:
        a.stop()
    b = config.copy().debugging(seed=1).build()
    try:
        version = b.workers.weights_version
        b.load_checkpoint(ckpt)
        assert b.iteration == 2
        assert b.workers.weights_version == version + 1
        got = b.learner.get_weights()
        assert all(torch.equal(saved[k], got[k]) for k in saved)
        infos = cluster.get([w.sample_fragment.remote("gae")
                             for w in b.workers.workers], timeout=T)
        assert [info["weights_version"] for _, _, info in infos] == \
            [version + 1] * 2
        assert np.isfinite(b.train()["total_loss"])
    finally:
        b.stop()


def test_actor_mode_refusals(cluster):
    from ray_tpu_torch.rllib import PPOConfig

    with pytest.raises(NotImplementedError, match="anakin mode only"):
        _config().training(model={"use_lstm": True}).build()
    with pytest.raises(NotImplementedError,
                       match="num_devices.*Queue 1 item 6"):
        _config().resources(num_devices=1).build()
    # The replay family's actor modes refuse the wrong action space before
    # they start a worker.
    from ray_tpu_torch.rllib import DQNConfig, SACConfig

    with pytest.raises(ValueError, match="continuous"):
        (SACConfig().environment("CartPole-v1")
         .rollouts(num_rollout_workers=1).resources(device="cpu").build())
    with pytest.raises(ValueError, match="discrete action env"):
        (DQNConfig().environment("Pendulum-v1")
         .rollouts(num_rollout_workers=1).resources(device="cpu").build())
    if not torch.cuda.is_available():
        # The learner defaults to CUDA: without it the build raises
        # before it starts any worker.
        with pytest.raises(RuntimeError, match="cuda"):
            PPOConfig().rollouts(num_rollout_workers=2).build()


# ---- learning gates ---------------------------------------------------------

def _best(algo, floor, iters):
    best = float("-inf")
    for _ in range(iters):
        r = algo.train()["episode_reward_mean"]
        if r == r:
            best = max(best, r)
        if best >= floor:
            break
    return best


@pytest.mark.slow
def test_ppo_actor_mode_learns_cartpole(cluster):
    """tests/test_rllib_actor_path.py's gate: CartPole to 100."""
    from ray_tpu_torch.rllib import PPOConfig

    algo = (PPOConfig().environment("CartPole-v1")
            .rollouts(num_rollout_workers=2, num_envs_per_worker=8,
                      rollout_fragment_length=128)
            .training(num_sgd_iter=6, sgd_minibatch_size=256, lr=3e-4,
                      entropy_coeff=0.0)
            .resources(device="cpu").build())
    try:
        best = _best(algo, 100.0, 40)
    finally:
        algo.stop()
    assert best >= 100.0, f"actor-path PPO failed to learn: best={best}"


@pytest.mark.slow
def test_ppo_actor_mode_learns_lunar_lander(cluster):
    """tests/test_real_env.py's gate: LunarLander-v3 (gymnasium, Box2D)
    from ~-200 to -50 within 45 iterations, at its settings."""
    pytest.importorskip("gymnasium")
    pytest.importorskip("Box2D")
    from ray_tpu_torch.rllib import PPOConfig

    algo = (PPOConfig().environment("LunarLander-v3")
            .rollouts(num_rollout_workers=2, num_envs_per_worker=8,
                      rollout_fragment_length=256, mode="actor")
            .training(lr=3e-4, num_sgd_iter=6, sgd_minibatch_size=512,
                      entropy_coeff=0.01, gamma=0.999)
            .debugging(seed=0).resources(device="cpu").build())
    try:
        best = _best(algo, -50.0, 45)
    finally:
        algo.stop()
    assert best >= -50.0, f"LunarLander PPO failed to learn: best={best}"
