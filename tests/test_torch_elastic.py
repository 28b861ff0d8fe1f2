"""The port's elastic data parallelism against the JAX package's
(``ray_tpu_torch/parallel/elastic.py`` vs ``ray_tpu/parallel/elastic.py``).

The keystone property carries over: the slot-deterministic step makes
the parameter trajectory bitwise identical for every world size that
divides ``slots`` (the counterparts of ``test_elastic.py``'s
``test_trajectory_bitwise_world_invariant`` and
``test_midrun_reshard_bitwise_parity``), and a gang of gloo ranks that
shrinks on a notice, grows on an offer and loses a rank with no notice
finishes bitwise-equal to the in-process ``reference_trajectory``.  The
port's trajectory is held to JAX's on the same problem at fp32
tolerance.  Torch runs on one thread, in this process and in every
rank (the per-slot program must be the same program)."""
import numpy as np
import pytest
import torch

T = 120  # seconds: the bound of every get
# The port's Adam and optax's, the same sums in other orders: measured
# <= 8.2e-6 apart on losses of ~10 and <= 5.4e-7 on the parameters.
JAX_RTOL, JAX_ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_thread_and_fns_by_value():
    import sys

    import cloudpickle

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    cloudpickle.register_pickle_by_value(sys.modules[__name__])
    yield
    cloudpickle.unregister_pickle_by_value(sys.modules[__name__])
    torch.set_num_threads(threads)


def _problem(seed: int = 0):
    """test_elastic.py's regression problem in torch: closures, so they
    ship to gang ranks by value."""

    def loss_fn(params, mb):
        h = torch.tanh(mb["x"] @ params["w1"] + params["b1"])
        pred = (h @ params["w2"])[:, 0]
        return ((pred - mb["y"]) ** 2).mean()

    def params_factory():
        rng = np.random.default_rng(seed)
        return {"w1": rng.normal(size=(3, 8)).astype(np.float32),
                "b1": np.zeros((8,), np.float32),
                "w2": rng.normal(size=(8, 1)).astype(np.float32)}

    def tx_factory():
        return lambda ps: torch.optim.Adam(ps, 1e-2, eps=1e-8)

    def batch_fn(step_idx):
        # 4 slots x 2 examples x 3 features; content depends only on the
        # step index, so a replay sees identical data.
        rng = np.random.default_rng(10_000 * (seed + 1) + step_idx)
        x = rng.normal(size=(4, 2, 3)).astype(np.float32)
        return {"x": x, "y": x.sum(axis=-1).astype(np.float32)}

    return loss_fn, params_factory, tx_factory, batch_fn


def _bitwise(a, b) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def _reference(**kw):
    from ray_tpu_torch.parallel.elastic import reference_trajectory

    return reference_trajectory(*_problem(), slots=4, device="cpu", **kw)


@pytest.mark.parametrize("grad_clip", [None, 0.5])
def test_trajectory_bitwise_world_invariant(grad_clip):
    ref = _reference(steps=6, world=1, grad_clip=grad_clip)
    for world in (2, 4):
        got = _reference(steps=6, world=world, grad_clip=grad_clip)
        assert np.array_equal(ref["losses"], got["losses"]), world
        assert _bitwise(ref["params"], got["params"]), world


@pytest.mark.parametrize("start,plan", [
    (4, {3: 2}),               # shrink 4 -> 2 mid-run
    (2, {3: 4}),               # grow 2 -> 4 mid-run
    (2, {1: 4, 3: 1, 5: 4}),   # grow-shrink-grow
])
def test_midrun_reshard_bitwise_parity(start, plan):
    ref = _reference(steps=6, world=1)
    got = _reference(steps=6, world=start, resize_plan=plan)
    assert np.array_equal(ref["losses"], got["losses"])
    assert _bitwise(ref["params"], got["params"])


def test_trajectory_matches_jax():
    """The same problem through ``ray_tpu.parallel.elastic``'s
    ``reference_trajectory`` (optax.adam, 2 virtual devices) within
    (JAX_RTOL, JAX_ATOL), with and without the clip."""
    import jax.numpy as jnp
    import optax

    from ray_tpu.parallel.elastic import reference_trajectory

    _, params_factory, _, batch_fn = _problem()

    def jloss(params, mb):
        h = jnp.tanh(mb["x"] @ params["w1"] + params["b1"])
        return jnp.mean(((h @ params["w2"])[:, 0] - mb["y"]) ** 2)

    for clip in (None, 0.5):
        j = reference_trajectory(
            jloss, lambda: {k: jnp.asarray(v)
                            for k, v in params_factory().items()},
            lambda: optax.adam(1e-2), batch_fn, steps=6, slots=4, world=2,
            grad_clip=clip)
        t = _reference(steps=6, world=2, grad_clip=clip)
        np.testing.assert_allclose(t["losses"], j["losses"], rtol=JAX_RTOL,
                                   atol=JAX_ATOL)
        for k in t["params"]:
            np.testing.assert_allclose(t["params"][k].numpy(),
                                       np.asarray(j["params"][k]),
                                       rtol=JAX_RTOL, atol=JAX_ATOL)


def test_elastic_gang_shrink_grow_expiry_bitwise():
    """Gloo ranks on one port cluster, ``num_hosts=(1, 2)``: 2 ranks, a
    ``preemption_notice`` shrinks to 1 at step 2, an offer grows back to
    2 at step 4, rank 1 is SIGKILLed with no notice in step 6 (the
    boundary snapshot is step 4's, so step 5 is replayed), 8 steps in
    all.  No step is lost and the losses and parameters equal the
    in-process reference bit for bit."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.parallel.elastic import ElasticMeshGroup

    rt.init(num_cpus=4, num_gpus=0, object_store_memory=256 * 1024**2)
    try:
        emg = ElasticMeshGroup(*_problem(), num_hosts=(1, 2), slots=4,
                               snapshot_interval=2, device="cpu",
                               bootstrap_timeout=T)
        try:
            losses = emg.run(2)
            emg.preemption_notice(1)
            losses += emg.run(2)
            assert emg.stats()["hosts"] == 1
            emg.offer_capacity(1)
            losses += emg.run(1)
            assert emg.stats()["hosts"] == 2
            emg.arm_lease_expiry(1, after_steps=1)
            losses += emg.run(3)
            stats = emg.stats()
            params = emg.params_host()
        finally:
            emg.shutdown()
    finally:
        rt.shutdown()
    assert stats["hosts"] == 1 and stats["step"] == 8, stats
    assert stats["elastic_notice_shrinks_total"] == 1, stats
    assert stats["elastic_grows_total"] == 1, stats
    assert stats["elastic_expiry_shrinks_total"] == 1, stats
    assert stats["elastic_replayed_steps_total"] >= 1, stats
    assert stats["elastic_steps_lost_total"] == 0, stats
    ref = _reference(steps=8, world=1)
    assert np.array_equal(np.asarray(losses, np.float64), ref["losses"])
    assert _bitwise(params, ref["params"])
