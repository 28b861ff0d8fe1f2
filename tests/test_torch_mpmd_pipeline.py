"""The port's MPMD pipeline against the JAX package's math
(``ray_tpu_torch/parallel/mpmd_pipeline.py`` vs
``ray_tpu/parallel/mpmd_pipeline.py``): the scenarios of
``tests/test_mpmd_pipeline.py``.

The same numpy-seeded MLP chunks (or GPT-2 tiny chunks with converted
weights) train through the port's pipeline, stages in actors of one
module cluster on the CPU, and through the JAX package's composed
reference: ``jax.value_and_grad`` of the same chunks with the same optax
optimizer, in this process.  Losses and final parameters are held at the
JAX test's own tolerances (rtol 1e-4, atol 1e-5).  Its stage-death
replay is in ``test_torch_mpmd_recovery.py``, its internally-SPMD stage
(a gang here) in ``test_torch_mpmd_gangs.py``, its GPT-2 split in
``test_torch_mpmd_gpt2.py``.  Torch runs on one
thread; chunk functions ship by value."""
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


def _jax_reference(j_fns, params, x, t, tx, steps):
    """JAX's composed reference: full-batch ``value_and_grad`` of the
    chunks in one process, one optax update a chunk."""
    def full_loss(ps, xb, tb):
        h = xb
        for i in range(len(j_fns) - 1):
            h = j_fns[i](ps[i], h)
        return j_fns[-1](ps[-1], h, tb)

    ps = [jax.tree_util.tree_map(jnp.asarray, p) for p in params]
    opt = [tx.init(p) for p in ps]
    losses = []
    for _ in range(steps):
        loss, grads = jax.value_and_grad(full_loss)(ps, x, t)
        for i in range(len(ps)):
            upd, opt[i] = tx.update(grads[i], opt[i], ps[i])
            ps[i] = optax.apply_updates(ps[i], upd)
        losses.append(float(loss))
    return losses, [jax.tree_util.tree_map(np.asarray, p) for p in ps]


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


def test_mpmd_two_stage_matches_jax_reference(cluster):
    (s0, s1), jfns = _mlp_stages()
    rng = np.random.default_rng(0)
    p0, p1 = _mlp_params(rng)
    x = rng.normal(size=(32, 6)).astype(np.float32)
    w_true = rng.normal(size=(6, 3)).astype(np.float32)
    t = (x @ w_true).astype(np.float32)
    tx, jtx = _opt("sgd", 0.05)

    pipe = _pipe([s0, s1], [p0, p1], tx, num_microbatches=4)
    losses = [pipe.train_step(x, t) for _ in range(6)]
    params = pipe.get_params()
    pipe.stop()

    ref_losses, ref_params = _jax_reference(jfns, [p0, p1], x, t, jtx, 6)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4, atol=1e-5)
    _assert_params_close(params, ref_params)
    assert losses[-1] < losses[0]


def test_mpmd_ragged_batch_matches_reference(cluster):
    """len(x) % M != 0: microbatch gradients weighted by their true
    sizes reproduce the full-batch gradients."""
    (s0, s1), jfns = _mlp_stages()
    rng = np.random.default_rng(3)
    p0, p1 = _mlp_params(rng)
    x = rng.normal(size=(30, 6)).astype(np.float32)  # 30 % 4 != 0
    t = rng.normal(size=(30, 3)).astype(np.float32)
    tx, jtx = _opt("sgd", 0.05)

    pipe = _pipe([s0, s1], [p0, p1], tx, num_microbatches=4)
    losses = [pipe.train_step(x, t) for _ in range(3)]
    params = pipe.get_params()
    pipe.stop()

    ref_losses, ref_params = _jax_reference(jfns, [p0, p1], x, t, jtx, 3)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4, atol=1e-5)
    _assert_params_close(params, ref_params)


def test_mpmd_1f1b_and_gpipe_schedule_parity(cluster):
    """1F1B, GPipe and the JAX reference agree on losses and params over
    3 steps: the schedule changes execution order, never math."""
    (s0, s1), jfns = _mlp_stages()
    rng = np.random.default_rng(1)
    p0, p1 = _mlp_params(rng)
    x = rng.normal(size=(32, 6)).astype(np.float32)
    t = rng.normal(size=(32, 3)).astype(np.float32)
    tx, jtx = _opt("sgd", 0.05)
    ref_losses, ref_params = _jax_reference(jfns, [p0, p1], x, t, jtx, 3)

    for sched in ("1f1b", "gpipe"):
        pipe = _pipe([s0, s1], [p0, p1], tx, num_microbatches=8,
                     schedule=sched)
        losses = [pipe.train_step(x, t) for _ in range(3)]
        params = pipe.get_params()
        pipe.stop()
        np.testing.assert_allclose(losses, ref_losses, rtol=1e-4,
                                   atol=1e-5, err_msg=sched)
        _assert_params_close(params, ref_params)


def test_mpmd_schedule_order_inflight_bounds(cluster):
    """1F1B peaks at S - k microbatches holding residuals on stage k;
    GPipe holds all M on stage 0; the driver's admission window is S."""
    (s0, s1), _ = _mlp_stages()
    rng = np.random.default_rng(2)
    p0, p1 = _mlp_params(rng)
    x = rng.normal(size=(32, 6)).astype(np.float32)
    t = rng.normal(size=(32, 3)).astype(np.float32)
    tx, _ = _opt("sgd", 0.05)
    M = 8

    peaks = {}
    for sched in ("1f1b", "gpipe"):
        pipe = _pipe([s0, s1], [p0, p1], tx, num_microbatches=M,
                     schedule=sched)
        pipe.train_step(x, t)
        peaks[sched] = dict(pipe.last_step_report()["peak_inflight"])
        if sched == "1f1b":
            assert pipe.stats()["driver_peak_window"] == 2
        pipe.stop()
    for k in range(2):
        assert peaks["1f1b"][k] == 2 - k, peaks
    assert peaks["gpipe"][0] == M, peaks


def test_mpmd_three_stages_run(cluster):
    def mid(params, x):
        return torch.tanh(x @ params["w"])

    def last(params, h, target):
        return ((h @ params["w"] - target) ** 2).mean()

    rng = np.random.default_rng(1)
    dims = [4, 8, 8, 2]
    ps = [{"w": rng.normal(0, 0.4, (dims[i], dims[i + 1]))
           .astype(np.float32)} for i in range(3)]
    tx, _ = _opt("adam", 1e-2)
    pipe = _pipe([mid, mid, last], ps, tx, num_microbatches=2)
    x = rng.normal(size=(16, 4)).astype(np.float32)
    t = rng.normal(size=(16, 2)).astype(np.float32)
    losses = [pipe.train_step(x, t) for _ in range(20)]
    rep = pipe.last_step_report()
    for k, peak in rep["peak_inflight"].items():
        assert peak <= min(3 - k, 2), rep["peak_inflight"]
    pipe.stop()
    assert losses[-1] < losses[0] * 0.9


def test_mpmd_rejects_undersized_batch(cluster):
    def last(params, x, t):
        return ((x @ params["w"] - t) ** 2).mean()

    pipe = _pipe([last], [{"w": np.ones((3, 2), np.float32)}], None,
                 num_microbatches=4)
    with pytest.raises(ValueError, match="cannot fill"):
        pipe.train_step(np.ones((2, 3), np.float32),
                        np.ones((2, 2), np.float32))
    pipe.stop()


def test_mpmd_step_streaming_and_jit_cache_constant(cluster):
    """submit_step streams with zero lockstep syncs; the step callables
    a stage built (``jit_cache``) are one a kind and stay so."""
    from ray_tpu_torch.parallel import mpmd_pipeline as mp

    (s0, s1), _ = _mlp_stages()
    rng = np.random.default_rng(5)
    p0, p1 = _mlp_params(rng)
    x = rng.normal(size=(32, 6)).astype(np.float32)
    t = rng.normal(size=(32, 3)).astype(np.float32)
    tx, _ = _opt("sgd", 0.05)

    pipe = _pipe([s0, s1], [p0, p1], tx, num_microbatches=4, step_window=2)
    syncs_before = mp.mpmd_driver_sync_count()
    caches = []
    for _ in range(6):
        pipe.submit_step(x, t)
        rep = pipe.last_step_report()
        if rep is not None:
            caches.append(rep["jit_cache"])
    results = pipe.flush()
    assert mp.mpmd_driver_sync_count() == syncs_before
    assert [i for i, _ in results] == list(range(6))
    losses = [l for _, l in results]
    assert losses[-1] < losses[0]
    caches.append(pipe.last_step_report()["jit_cache"])
    pipe.stop()
    assert caches[0] == caches[-1], caches
    for stage_caches in caches[-1].values():
        assert set(stage_caches.values()) == {1}, caches[-1]


def test_mpmd_metrics_exported(cluster):
    """The mpmd_* metrics land in the /metrics source."""
    from ray_tpu_torch.util.metrics import prometheus_text

    (s0, s1), _ = _mlp_stages()
    rng = np.random.default_rng(13)
    p0, p1 = _mlp_params(rng)
    x = rng.normal(size=(32, 6)).astype(np.float32)
    t = rng.normal(size=(32, 3)).astype(np.float32)
    tx, _ = _opt("sgd", 0.05)
    pipe = _pipe([s0, s1], [p0, p1], tx, num_microbatches=4)
    for _ in range(2):
        pipe.train_step(x, t)
    pipe._metrics["act_bytes"].flush()  # Meter batches kv writes
    pipe.stop()
    text = prometheus_text()
    for name in ("mpmd_bubble_fraction", "mpmd_steps_total",
                 "mpmd_activation_bytes", "mpmd_stage_idle_frac",
                 "mpmd_peak_inflight_microbatches"):
        assert name in text, f"{name} missing from metrics export"
