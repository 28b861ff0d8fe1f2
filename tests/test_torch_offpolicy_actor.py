"""The replay family's actor mode on the port's runtime: CPU
``OffPolicyRolloutWorker`` actors feeding the replay plane (local and
sharded over the object store), the learner on the CPU here (the card in
chip_smoke's ``[dqn-actor]``).

One port cluster for the module; every get and wait has a deadline, and
every algorithm is stopped in a ``finally``.  The runs are smoke tests
at ``tests/test_rllib_actor_path.py``'s sizes for a few iterations (its
CartPole gate, 100 within 80 iterations, is ``slow`` here and runs on
the card): DQN on the local plane and on a sharded prioritized plane
(one ``get_many`` gather a sampled batch, payloads only by reference,
priorities back to the shards), TD3 and SAC on gymnasium's Pendulum-v1
through the Box bridge, the worker's n-step folding, its versions, and
the checkpoint round trip.
"""
import math
import time

import numpy as np
import pytest
import torch

from ray_tpu_torch.rllib.evaluation import worker_set as tws
from ray_tpu_torch.rllib.execution import replay_plane as tplane

T = 120  # seconds: the bound of every get and wait in this file


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cluster():
    import ray_tpu_torch

    ray_tpu_torch.init(num_cpus=6, object_store_memory=256 * 1024**2)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def _dqn_config(**replay):
    from ray_tpu_torch.rllib import DQNConfig

    cfg = (DQNConfig().environment("CartPole-v1")
           .rollouts(num_rollout_workers=2, num_envs_per_worker=4,
                     rollout_fragment_length=64)
           .training(lr=5e-4).resources(device="cpu"))
    cfg.learning_starts = 256
    for k, v in replay.items():
        setattr(cfg, k, v)
    return cfg


def _train(config, iters):
    algo = config.build()
    try:
        return [algo.train() for _ in range(iters)], algo
    except BaseException:
        algo.stop()
        raise


def test_off_policy_worker_versions_and_nstep_publish(cluster):
    import cloudpickle

    from ray_tpu_torch.rllib.algorithms.dqn import QNetwork

    def act_factory():  # nested: pickled by value (workers cannot
        # import this test module)
        from ray_tpu_torch.rllib.algorithms.dqn import (
            QNetwork,
            epsilon_greedy,
        )

        module = QNetwork(4, 2, (16,))

        def act(obs, generator, epsilon):
            return epsilon_greedy(module(obs), generator, epsilon)

        return module, act

    blob = cloudpickle.dumps(act_factory)
    weights = QNetwork(4, 2, (16,), torch.Generator().manual_seed(0)
                       ).state_dict()
    w = tws.OffPolicyRolloutWorker.remote("CartPole-v1", blob, 1, 3, 20, 0)
    try:
        with pytest.raises(cluster.exceptions.RayTpuError,
                           match="before any set_weights"):
            cluster.get(w.sample.remote(0.5), timeout=T)
        assert cluster.get(w.set_weights.remote(weights, 4), timeout=T) == 4
        batch, completed = cluster.get(w.sample.remote(1.0), timeout=T)
        assert sorted(batch) == ["actions", "dones", "next_obs", "obs",
                                 "rewards"]
        assert batch["obs"].shape == (60, 4) and batch["actions"].shape == \
            (60,)
        assert batch["obs"].dtype == batch["rewards"].dtype == np.float32
        assert int(batch["dones"].sum()) == len(completed)
        # Row t * N + e: env e's step t, so row t's successor is N ahead
        # wherever the episode goes on.
        live = batch["dones"][:-3] == 0
        assert np.array_equal(batch["next_obs"][:-3][live],
                              batch["obs"][3:][live])
        refs, meta, _ = cluster.get(
            w.sample_publish.remote(1.0, 0.9, 3), timeout=T)
        assert meta == {"n": 60, "version": 4}
        assert sorted(refs) == ["actions", "discounts", "dones", "next_obs",
                                "obs", "rewards"]
        cols = dict(zip(refs, cluster.get(list(refs.values()), timeout=T)))
        # The fold is compute_nstep's on the raw fragment (its rewards
        # are all 1 on CartPole: at most 1 + 0.9 + 0.81).
        assert cols["rewards"].max() <= 2.71 + 1e-6
        assert (cols["discounts"][cols["dones"] == 1] == 0).all()
        assert cluster.get(w.close.remote(), timeout=T)
    finally:
        cluster.kill(w)


def test_dqn_actor_mode_local_plane(cluster):
    results, algo = _train(_dqn_config(), 3)
    try:
        assert algo.config.mode == "actor" and not algo._rb.distributed
        assert algo.learner.device.type == "cpu"
        last = results[-1]
        assert last["replay_size"] == 3 * 2 * 4 * 64
        assert last["num_env_steps_sampled"] == 3 * 2 * 4 * 64
        assert math.isfinite(last["total_loss"])
        assert last["epsilon"] < results[0]["epsilon"] <= 1.0
        # (2 workers x 4 envs x 64 steps) * 4 / 128: 16 updates an
        # iteration, then a weights version each.
        assert algo._actor_updates == 16
        assert algo.workers.weights_version == 1 + 3
        assert algo._rb.stats()["num_shards"] == 0
        # The checkpoint round trip: the Q network bit for bit, the next
        # fragments at the new version.
        ckpt = algo.save_checkpoint()
        saved = algo.learner.get_weights()
    finally:
        algo.stop()
    b = _dqn_config().build()
    try:
        version = b.workers.weights_version
        b.load_checkpoint(ckpt)
        assert b.iteration == 3 and b.workers.weights_version == version + 1
        got = b.learner.get_weights()
        assert all(torch.equal(saved[k], got[k]) for k in saved)
        assert math.isfinite(b.train()["total_loss"])
    finally:
        b.stop()


def test_dqn_actor_mode_sharded_prioritized_plane(cluster, monkeypatch):
    """Every sampled batch one get_many gather; the plane takes fragment
    refs only (no payload through the insert path or a shard); the TD
    errors come back as priorities; finite losses."""
    from ray_tpu_torch.object_ref import ObjectRef

    inserts = {"payload": 0, "refs": 0, "samples": 0}
    insert, insert_refs = tplane.ReplayPlane.insert, \
        tplane.ReplayPlane.insert_refs
    sample = tplane.ReplayPlane.sample

    def count_insert(self, *a, **k):
        inserts["payload"] += 1
        return insert(self, *a, **k)

    def count_refs(self, refs, *a, **k):
        assert all(isinstance(r, ObjectRef) for r in refs.values())
        inserts["refs"] += 1
        return insert_refs(self, refs, *a, **k)

    def count_sample(self, *a, **k):
        inserts["samples"] += 1
        return sample(self, *a, **k)

    monkeypatch.setattr(tplane.ReplayPlane, "insert", count_insert)
    monkeypatch.setattr(tplane.ReplayPlane, "insert_refs", count_refs)
    monkeypatch.setattr(tplane.ReplayPlane, "sample", count_sample)
    results, algo = _train(_dqn_config(replay_num_shards=2,
                                       replay_prioritized=True), 3)
    try:
        plane = algo._rb
        assert plane.distributed and plane.alpha == 0.6
        assert inserts["payload"] == 0 and inserts["refs"] == 3 * 2
        assert inserts["samples"] == plane.gather_calls == 3 * 16
        assert all(math.isfinite(r["total_loss"]) for r in results)

        def landed():
            # Updates in flight land on the shards; a sample refreshes
            # the plane's view of their masses (all 1.0 at insert).
            plane.sample(8)
            masses = plane.stats()["per_shard_mass"]
            return abs(sum(masses) - plane.size) > 1.0

        deadline = time.monotonic() + T
        while not landed():
            assert time.monotonic() < deadline, "no priority update landed"
            time.sleep(0.2)
        assert plane.stats()["num_healthy_shards"] == 2
    finally:
        algo.stop()


@pytest.mark.parametrize("name", ["TD3", "SAC"])
def test_continuous_actor_mode_on_gym_pendulum(cluster, name):
    """tests/test_rllib_actor_path.py's TD3 run (and SAC's at its size):
    gymnasium's Pendulum-v1 through the Box bridge, finite losses."""
    pytest.importorskip("gymnasium")
    from ray_tpu_torch import rllib

    cfg = (getattr(rllib, f"{name}Config")().environment("Pendulum-v1")
           .rollouts(num_rollout_workers=2, num_envs_per_worker=2,
                     rollout_fragment_length=64)
           .training(lr=3e-4).resources(device="cpu"))
    cfg.learning_starts, cfg.num_updates_per_iter = 256, 4
    results, algo = _train(cfg, 3)
    try:
        last = results[-1]
        assert last["replay_size"] == 3 * 2 * 2 * 64
        assert math.isfinite(last["critic_loss"])
        assert math.isfinite(last["actor_loss"])
        assert last["num_healthy_workers"] == 2
        actions = cluster.get(algo.workers.workers[0].sample.remote(0.1),
                              timeout=T)[0]["actions"]
        assert actions.shape == (128, 1) and actions.dtype == np.float32
        assert np.abs(actions).max() <= 2.0
    finally:
        algo.stop()


@pytest.mark.slow
def test_dqn_actor_mode_learns_cartpole(cluster):
    """tests/test_rllib_actor_path.py's gate: CartPole to 100 within 80
    iterations, 2 workers x 4 envs x 64 steps, lr 5e-4."""
    from ray_tpu_torch.rllib import DQNConfig

    algo = (DQNConfig().environment("CartPole-v1")
            .rollouts(num_rollout_workers=2, num_envs_per_worker=4,
                      rollout_fragment_length=64)
            .training(lr=5e-4).resources(device="cpu").build())
    best = 0.0
    try:
        for _ in range(80):
            r = algo.train().get("episode_reward_mean", 0.0)
            if r == r:
                best = max(best, r)
            if best >= 100.0:
                break
    finally:
        algo.stop()
    assert best >= 100.0, f"actor-path DQN failed to learn: best={best}"
