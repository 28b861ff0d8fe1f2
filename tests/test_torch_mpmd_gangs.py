"""The port's MPMD stage gangs against the JAX package's: the gang
scenarios of ``tests/test_mpmd_3d.py``.

Each stage is a 2-rank gloo gang of one module cluster (the JAX tests'
2-process ``jax.distributed`` worlds): parameters replicated, each
microbatch cut in two, gradients averaged over the gang, the optimizer
ZeRO-sharded where asked.  Losses and params are held to the JAX
composed reference (``jax.value_and_grad`` of the same chunks with
optax) at the JAX tests' tolerances: rtol 1e-4, atol 1e-5; the full 3D
composition within 0.07 of the reference loss with >= 3x fewer wire
bytes; a gang-rank death's replay on the unkilled run at rtol 1e-5, atol
1e-6 (params 1e-6, 1e-7); ``test_mpmd_pipeline.py``'s
internally-SPMD stage with a ZeRO-sharded Adam as a gang, at rtol 1e-4,
atol 1e-5, its optimizer state 1/2 per rank.  ``spmd_devices > 1``
raises, naming ``gang_hosts``.  Torch runs on one thread; chunk
functions ship by value."""
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

    ray_tpu_torch.init(num_cpus=8, num_gpus=0,
                       object_store_memory=256 * 1024**2)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def _mlp_chunks(dims, seed):
    def mid(params, x):
        return torch.tanh(x @ params["w"])

    def last(params, h, target):
        return ((h @ params["w"] - target) ** 2).mean()

    def j_mid(params, x):
        return jnp.tanh(x @ params["w"])

    def j_last(params, h, target):
        return jnp.mean((h @ params["w"] - target) ** 2)

    rng = np.random.default_rng(seed)
    n = len(dims) - 1
    ps = [{"w": rng.normal(0, 0.4, (dims[i], dims[i + 1]))
           .astype(np.float32)} for i in range(n)]
    return [mid] * (n - 1) + [last], [j_mid] * (n - 1) + [j_last], ps


def _jax_reference(j_fns, params, x, t, tx, steps):
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


def _assert_chunk_params_close(got, want, rtol=1e-4, atol=1e-5):
    for c, (g, w) in enumerate(zip(got, want)):
        for k in w:
            np.testing.assert_allclose(np.asarray(g[k]), np.asarray(w[k]),
                                       rtol=rtol, atol=atol,
                                       err_msg=f"chunk {c} {k}")


def _mlp_stages():
    """``test_mpmd_pipeline.py``'s two-stage MLP + MSE loss in both
    packages (nested: shipped by value)."""

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
    if kind == "adam":
        return functools.partial(torch.optim.Adam, lr=lr), optax.adam(lr)
    return functools.partial(torch.optim.SGD, lr=lr), optax.sgd(lr)


def _pipe(fns, params, tx, **kw):
    from ray_tpu_torch.parallel.mpmd_pipeline import MPMDPipeline

    kw.setdefault("drain_timeout", T)
    kw.setdefault("bootstrap_timeout", T)
    return MPMDPipeline(fns, params, optimizer=tx, device="cpu", **kw)


def test_gang_stage_parity_with_zero(cluster):
    """2 stages, each a 2-rank gang, stage 0's Adam ZeRO-sharded: losses
    and params match the JAX reference."""
    fns, jfns, ps = _mlp_chunks([8, 32, 4], seed=6)
    rng = np.random.default_rng(6)
    x = rng.normal(size=(32, 8)).astype(np.float32)
    t = rng.normal(size=(32, 4)).astype(np.float32)
    ref_losses, ref_params = _jax_reference(jfns, ps, x, t,
                                            optax.adam(1e-2), 3)
    pipe = _pipe(fns, ps, functools.partial(torch.optim.Adam, lr=1e-2),
                 num_microbatches=4, gang_hosts=2,
                 stage_options=[{"zero_sharding": "opt+grads"}, {}])
    try:
        losses = [pipe.train_step(x, t) for _ in range(3)]
        params = pipe.get_params()
        stats = pipe.stats()
    finally:
        pipe.stop()
    assert stats["gang_hosts"] == 2
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4, atol=1e-5)
    _assert_chunk_params_close(params, ref_params)


def test_gang_3d_composed_interleaved_int8(cluster):
    """2 stages x 2-rank gangs x interleaved v=2 x ZeRO x the int8 wire
    trains within the quantization envelope with >= 3x fewer bytes."""
    fns, jfns, ps = _mlp_chunks([6, 64, 64, 64, 4], seed=7)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(32, 6)).astype(np.float32)
    t = rng.normal(size=(32, 4)).astype(np.float32)
    ref_losses, _ = _jax_reference(jfns, ps, x, t, optax.sgd(0.05), 4)
    pipe = _pipe(fns, ps, functools.partial(torch.optim.SGD, lr=0.05),
                 num_microbatches=4, virtual_per_rank=2, wire_dtype="int8",
                 gang_hosts=2,
                 stage_options=[{"zero_sharding": "opt+grads"},
                                {"zero_sharding": "opt+grads"}])
    try:
        losses = [pipe.train_step(x, t) for _ in range(4)]
        stats = pipe.stats()
    finally:
        pipe.stop()
    assert stats["wire_reduction_vs_fp32"] >= 3.0, stats
    for a, b in zip(losses, ref_losses):
        assert abs(a - b) < 0.07, (losses, ref_losses)


def test_gang_rank_death_replay_matches_unkilled(cluster):
    """SIGKILL one rank of one stage gang mid-step: every gang tears
    down, respawns, restores the snapshot and replays in order, landing
    on the params of an unkilled (solo-stage) run."""
    from ray_tpu_torch._private.chaos import _kill_actor_process

    fns, _, ps = _mlp_chunks([8, 32, 4], seed=8)
    rng = np.random.default_rng(8)
    x = rng.normal(size=(32, 8)).astype(np.float32)
    t = rng.normal(size=(32, 4)).astype(np.float32)
    sgd = functools.partial(torch.optim.SGD, lr=0.05)
    steps = 5

    ref = _pipe(fns, ps, sgd, num_microbatches=4)
    ref_losses = [ref.train_step(x, t) for _ in range(steps)]
    ref_params = ref.get_params()
    ref.stop()

    pipe = _pipe(fns, ps, sgd, num_microbatches=4, gang_hosts=2,
                 step_window=2, max_restarts=2, snapshot_interval=1)
    try:
        losses = {}
        for i in range(steps):
            pipe.submit_step(x, t)
            if i == 2:
                assert _kill_actor_process(pipe._gangs[1].workers[0])
        for idx, loss in pipe.flush():
            losses[idx] = loss
        params = pipe.get_params()
        assert pipe.restart_count >= 1, "kill never triggered a restart"
    finally:
        pipe.stop()
    np.testing.assert_allclose([losses[i] for i in range(steps)],
                               ref_losses, rtol=1e-5, atol=1e-6)
    _assert_chunk_params_close(params, ref_params, rtol=1e-6, atol=1e-7)


def test_spmd_devices_raises_naming_gang_hosts():
    """Several devices inside one stage process are not ported: the
    stage's data parallelism is a gang of processes (``gang_hosts``)."""
    from ray_tpu_torch.parallel.mpmd_pipeline import MPMDPipeline, StageCore

    fns, _, ps = _mlp_chunks([4, 4, 2], seed=0)
    with pytest.raises(NotImplementedError, match="gang_hosts"):
        MPMDPipeline(fns, ps, device="cpu",
                     stage_options=[{"spmd_devices": 2}, {}])
    with pytest.raises(NotImplementedError, match="gang_hosts"):
        StageCore([fns[0]], [ps[0]], stage_id=0, num_stages=2,
                  spmd_devices=2, device="cpu")
    with pytest.raises(ValueError, match="gang_hosts"):
        StageCore([fns[0]], [ps[0]], stage_id=0, num_stages=2,
                  zero_sharding="opt+grads", device="cpu")


def test_mpmd_gang_stage_with_zero_sharded_optimizer(cluster):
    """The JAX test's internally-SPMD stage (``spmd_devices=2``) as a
    2-rank gang: with a ZeRO-sharded Adam on stage 0 it matches the JAX
    reference, and its optimizer state is 1/2 per rank."""
    from ray_tpu_torch.parallel.mesh_group import gang_get

    (s0, s1), jfns = _mlp_stages()
    rng = np.random.default_rng(9)
    p0, p1 = _mlp_params(rng)
    x = rng.normal(size=(32, 6)).astype(np.float32)
    t = rng.normal(size=(32, 3)).astype(np.float32)
    tx, jtx = _opt("adam", 1e-2)

    pipe = _pipe([s0, s1], [p0, p1], tx, num_microbatches=4, gang_hosts=2,
                 stage_options=[{"zero_sharding": "opt+grads"}, {}],
                 bootstrap_timeout=T)
    try:
        losses = [pipe.train_step(x, t) for _ in range(4)]
        params = pipe.get_params()
        h = pipe._handles[0]
        stats = gang_get(h.submit("stats", [() for _ in range(h.width)]),
                         timeout=T)[0]
    finally:
        pipe.stop()

    ref_losses, ref_params = _jax_reference(jfns, [p0, p1], x, t, jtx, 4)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4, atol=1e-5)
    _assert_chunk_params_close(params, ref_params)
    ratio = stats["zero_opt_bytes_per_replica"] / \
        stats["replicated_opt_bytes"]
    assert ratio <= 0.5 + 0.05, f"opt state not 1/N-sharded: {ratio}"
