"""The port's MPMD pipeline against the JAX package's: the fault and
tracing scenarios of ``tests/test_mpmd_pipeline.py`` (a stage's worker
killed mid-step, replayed onto the unkilled run's parameters at rtol
1e-5, atol 1e-6 and 1e-6, 1e-7) and ``tests/test_observability.py``'s
``test_mpmd_step_assembles_one_trace`` (one training step is one
cross-process trace).  Stages are actors of one module cluster on the
CPU; torch runs on one thread; chunk functions ship by value."""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

T = 120  # seconds: the bound of every get and gang call


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


@pytest.fixture(scope="module")
def cluster():
    import ray_tpu_torch

    ray_tpu_torch.init(num_cpus=6, num_gpus=0,
                       object_store_memory=256 * 1024**2)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def _mlp_stages():
    """The two-stage MLP + MSE loss in both packages (nested: shipped by
    value)."""

    def stage0(params, x):
        return torch.tanh(x @ params["w0"] + params["b0"])

    def stage1_loss(params, h, target):
        pred = h @ params["w1"] + params["b1"]
        return ((pred - target) ** 2).mean()

    def j_stage0(params, x):
        return jnp.tanh(x @ params["w0"] + params["b0"])

    def j_stage1_loss(params, h, target):
        pred = h @ params["w1"] + params["b1"]
        return jnp.mean((pred - target) ** 2)

    return (stage0, stage1_loss), (j_stage0, j_stage1_loss)


def _mlp_params(rng, d_in=6, d_h=16, d_out=3):
    p0 = {"w0": rng.normal(0, 0.3, (d_in, d_h)).astype(np.float32),
          "b0": np.zeros((d_h,), np.float32)}
    p1 = {"w1": rng.normal(0, 0.3, (d_h, d_out)).astype(np.float32),
          "b1": np.zeros((d_out,), np.float32)}
    return p0, p1


def _opt(kind, lr):
    """The same optimizer in both packages: (torch factory, optax)."""
    from ray_tpu_torch.train.torch import adamw

    if kind == "sgd":
        return functools.partial(torch.optim.SGD, lr=lr), optax.sgd(lr)
    if kind == "adam":
        return functools.partial(torch.optim.Adam, lr=lr), optax.adam(lr)
    return functools.partial(adamw, learning_rate=lr), optax.adamw(lr)


def _assert_params_close(got, want, rtol=1e-4, atol=1e-5):
    for stage, (g, w) in enumerate(zip(got, want)):
        assert sorted(g) == sorted(w), stage
        for k in w:
            np.testing.assert_allclose(np.asarray(g[k]), np.asarray(w[k]),
                                       rtol=rtol, atol=atol,
                                       err_msg=f"stage {stage} {k}")


def _pipe(fns, params, tx, **kw):
    from ray_tpu_torch.parallel.mpmd_pipeline import MPMDPipeline

    kw.setdefault("drain_timeout", T)
    return MPMDPipeline(fns, params, optimizer=tx, device="cpu", **kw)


def test_mpmd_stage_death_replay_matches_unkilled(cluster):
    """Kill one stage's worker process mid-step: every stage restarts,
    restores the store-resident snapshot, replays the in-flight steps in
    order and lands on the unkilled run's params."""
    from ray_tpu_torch._private.chaos import _kill_actor_process

    (s0, s1), _ = _mlp_stages()
    rng = np.random.default_rng(7)
    p0, p1 = _mlp_params(rng)
    x = rng.normal(size=(32, 6)).astype(np.float32)
    t = rng.normal(size=(32, 3)).astype(np.float32)
    tx, _ = _opt("sgd", 0.05)
    steps = 5

    ref = _pipe([s0, s1], [p0, p1], tx, num_microbatches=4)
    ref_losses = [ref.train_step(x, t) for _ in range(steps)]
    ref_params = ref.get_params()
    ref.stop()

    pipe = _pipe([s0, s1], [p0, p1], tx, num_microbatches=4, step_window=2,
                 max_restarts=2, snapshot_interval=1, drain_timeout=60.0)
    losses = {}
    for i in range(steps):
        pipe.submit_step(x, t)
        if i == 2:
            assert _kill_actor_process(pipe.stages[1])
    for idx, loss in pipe.flush():
        losses[idx] = loss
    params = pipe.get_params()
    assert pipe.restart_count >= 1, "kill never triggered a restart"
    pipe.stop()

    np.testing.assert_allclose([losses[i] for i in range(steps)],
                               ref_losses, rtol=1e-5, atol=1e-6)
    _assert_params_close(params, ref_params, rtol=1e-6, atol=1e-7)



def test_mpmd_step_assembles_one_trace(cluster):
    """One 2-stage MPMD training step is one trace: the driver's dispatch
    root, the mpmd_stage_* spans stamped with the step's context, and
    execute spans from both stage processes (>= 3 procs), joined by
    cross-process flow edges (``test_observability.py``'s scenario)."""
    import time

    import ray_tpu_torch
    from ray_tpu_torch.observability.timeline import trace_stats
    from ray_tpu_torch.util import tracing

    (s0, s1), _ = _mlp_stages()
    rng = np.random.default_rng(0)
    p0, p1 = _mlp_params(rng)
    x = rng.normal(size=(16, 6)).astype(np.float32)
    t = rng.normal(size=(16, 3)).astype(np.float32)
    tx, _ = _opt("sgd", 0.05)

    tracing.enable_tracing()
    try:
        pipe = _pipe([s0, s1], [p0, p1], tx, num_microbatches=2)
        try:
            for _ in range(4):
                pipe.train_step(x, t)
        finally:
            pipe.stop()
        head = ray_tpu_torch._head
        good = []
        deadline = time.monotonic() + 30
        while not good and time.monotonic() < deadline:
            head._drain_local_spans()
            tids = {s["trace_id"] for s in head.trace_store.spans()
                    if s["name"] == "mpmd_step_dispatch" and s["trace_id"]}
            for tid in tids:
                st = trace_stats(ray_tpu_torch.timeline(trace_id=tid))
                if st["procs"] >= 3 and st["flow_edges"] >= 1:
                    good.append(tid)
                    break
            else:
                time.sleep(0.2)
        assert good, "no step assembled into one cross-process trace"
        names = {s["name"] for s in head.trace_store.spans(good[0])}
    finally:
        tracing.disable_tracing()
        tracing.pop_local_spans()
    assert "mpmd_step_dispatch" in names
    assert names & {"mpmd_stage_fwd", "mpmd_stage_bwd", "mpmd_stage_apply"}
