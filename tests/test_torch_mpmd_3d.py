"""The port's composed 3D pipeline against the JAX package's: the
scenarios of ``tests/test_mpmd_3d.py`` (interleaved virtual stages, the
block-scaled int8 wire, the Llama splitter, stage gangs with ZeRO and
their rank-death replay).

The schedules are pure Python: the port's are held to the JAX package's
op for op.  The pipelines run MLP chunks (and Llama tiny chunks with the
JAX chunks' weights converted) on actors of one module cluster, on the
CPU, against the JAX composed reference (``jax.value_and_grad`` of the
same chunks with optax) at the JAX tests' tolerances: rtol 1e-4, atol
1e-5 on the fp32 wire, 0.05 (0.07 composed with gangs) of the reference
loss on the int8 wire, >= 3x fewer wire bytes, and the replay held to an
unkilled run at rtol 1e-5, atol 1e-6 (params 1e-6, 1e-7).  Where the JAX
gang tests form 2-process ``jax.distributed`` worlds, the port's gangs
are 2 gloo ranks.  Torch runs on one thread; chunk functions ship by
value."""
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


def _mlp_chunks(dims, seed=1):
    """len(dims)-1 chunks (tanh layers and an MSE tail) in both packages,
    with numpy weights (nested: shipped by value)."""
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
        assert sorted(g) == sorted(w), c
        for k in w:
            np.testing.assert_allclose(np.asarray(g[k]), np.asarray(w[k]),
                                       rtol=rtol, atol=atol,
                                       err_msg=f"chunk {c} {k}")


def _pipe(fns, params, tx, **kw):
    from ray_tpu_torch.parallel.mpmd_pipeline import MPMDPipeline

    kw.setdefault("drain_timeout", T)
    kw.setdefault("bootstrap_timeout", T)
    return MPMDPipeline(fns, params, optimizer=tx, device="cpu", **kw)


SGD = functools.partial(torch.optim.SGD, lr=0.05)


# ---------------------------------------------------------------------------
# Schedules (pure: no cluster)
# ---------------------------------------------------------------------------

def test_interleaved_schedule_grid_feasible():
    """Every (schedule, S, v, M) is deadlock-free, covers each (chunk,
    microbatch) op exactly once, and is the JAX package's op order and
    simulated bubble."""
    from ray_tpu.parallel import mpmd_pipeline as jmp
    from ray_tpu_torch.parallel.mpmd_pipeline import (simulate_schedule,
                                                      stage_schedule)

    for S in (2, 3, 4):
        for v in (1, 2, 3):
            for M in (S, 2 * S, 4 * S):
                for sched in ("1f1b", "gpipe"):
                    per_stage = [stage_schedule(sched, S, M, k, v)
                                 for k in range(S)]
                    assert per_stage == [jmp.stage_schedule(sched, S, M, k, v)
                                         for k in range(S)]
                    ops = [op for st in per_stage for op in st]
                    want = {(d, c, m) for d in ("F", "B")
                            for c in range(S * v) for m in range(M)}
                    assert set(ops) == want and len(ops) == len(want), \
                        (sched, S, v, M)
                    r = simulate_schedule(sched, S, M, v)
                    assert r == jmp.simulate_schedule(sched, S, M, v)
                    assert 0.0 <= r["bubble_fraction"] < 1.0, (S, v, M, r)


def test_interleaving_cuts_predicted_bubble():
    from ray_tpu_torch.parallel.mpmd_pipeline import simulate_schedule

    for S, M in ((2, 8), (4, 8), (2, 16)):
        b1 = simulate_schedule("1f1b", S, M, 1)["bubble_fraction"]
        b2 = simulate_schedule("1f1b", S, M, 2)["bubble_fraction"]
        assert b2 < b1, (S, M, b1, b2)
    b1 = simulate_schedule("1f1b", 2, 8, 1)["bubble_fraction"]
    assert abs(b1 - 1 / 9) < 0.02, b1


def test_interleaved_requires_divisible_microbatches():
    from ray_tpu_torch.parallel.mpmd_pipeline import stage_schedule

    with pytest.raises(ValueError, match="num_microbatches"):
        stage_schedule("1f1b", 2, 7, 0, 2)


# ---------------------------------------------------------------------------
# Interleaved + int8 wire on solo stages
# ---------------------------------------------------------------------------

def test_interleaved_v2_matches_reference(cluster):
    """2 stages x 2 virtual chunks: losses and params match the JAX
    full-batch reference on the fp32 wire, for 1F1B and GPipe."""
    fns, jfns, ps = _mlp_chunks([6, 16, 16, 16, 2])
    rng = np.random.default_rng(2)
    x = rng.normal(size=(32, 6)).astype(np.float32)
    t = rng.normal(size=(32, 2)).astype(np.float32)
    ref_losses, ref_params = _jax_reference(jfns, ps, x, t,
                                            optax.sgd(0.05), 3)
    for sched in ("1f1b", "gpipe"):
        pipe = _pipe(fns, ps, SGD, num_microbatches=4, virtual_per_rank=2,
                     schedule=sched)
        losses = [pipe.train_step(x, t) for _ in range(3)]
        params = pipe.get_params()
        pipe.stop()
        np.testing.assert_allclose(losses, ref_losses, rtol=1e-4,
                                   atol=1e-5, err_msg=sched)
        _assert_chunk_params_close(params, ref_params)


def test_int8_wire_bytes_and_envelope(cluster):
    """The int8 wire ships >= 3x fewer boundary bytes than the logical
    fp32 activations while the loss stays inside the quantization
    envelope; ``mpmd_wire_bytes`` lands on /metrics."""
    from ray_tpu_torch.util.metrics import prometheus_text

    fns, jfns, ps = _mlp_chunks([8, 64, 64, 64, 4], seed=3)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(32, 8)).astype(np.float32)
    t = rng.normal(size=(32, 4)).astype(np.float32)
    ref_losses, _ = _jax_reference(jfns, ps, x, t, optax.sgd(0.05), 3)

    pipe = _pipe(fns, ps, SGD, num_microbatches=4, virtual_per_rank=2,
                 wire_dtype="int8")
    losses = [pipe.train_step(x, t) for _ in range(3)]
    stats = pipe.stats()
    pipe._metrics["wire"].flush()  # Meter batches kv writes
    pipe.stop()
    assert stats["wire_reduction_vs_fp32"] >= 3.0, stats
    assert stats["wire_bytes"] > 0, stats
    for a, b in zip(losses, ref_losses):
        assert abs(a - b) < 0.05, (losses, ref_losses)
    assert "mpmd_wire_bytes" in prometheus_text()


def test_fp32_wire_byte_accounting(cluster):
    """The fp32 wire ships exactly its logical bytes (ratio 1.0)."""
    fns, _, ps = _mlp_chunks([8, 64, 64, 64, 4], seed=4)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(32, 8)).astype(np.float32)
    t = rng.normal(size=(32, 4)).astype(np.float32)
    pipe = _pipe(fns, ps, SGD, num_microbatches=4)
    pipe.train_step(x, t)
    stats = pipe.stats()
    pipe.stop()
    assert stats["wire_bytes"] == stats["activation_bytes"] > 0, stats
    assert stats["wire_reduction_vs_fp32"] == 1.0, stats


# ---------------------------------------------------------------------------
# Llama splitting (pure: no cluster)
# ---------------------------------------------------------------------------

def test_llama_split_cost_balance_gqa_swiglu():
    """The chunk cost balance uses llama block-equivalents (GQA + SwiGLU):
    the port's bounds are the JAX package's, the head-owning chunk gets
    fewer blocks, and the per-chunk cost spread stays within one block."""
    from ray_tpu.models.llama import LlamaConfig as JConfig
    from ray_tpu.models.llama import llama_head_cost as j_head_cost
    from ray_tpu.models.pipeline_split import balance_chunks as j_balance
    from ray_tpu_torch.models.llama import (LlamaConfig, llama_head_cost,
                                            split_stages)
    from ray_tpu_torch.models.pipeline_split import balance_chunks

    cfg = LlamaConfig.llama_1b()
    head = llama_head_cost(cfg)
    assert head == j_head_cost(JConfig.llama_1b())
    assert cfg.block_params != 12 * cfg.hidden_size ** 2
    assert 0.5 < head < cfg.vocab_size / cfg.hidden_size, head
    for n in (2, 4):
        bounds = balance_chunks(cfg.num_layers, n, embed_cost=0.3,
                                head_cost=head)
        assert bounds == j_balance(cfg.num_layers, n, embed_cost=0.3,
                                   head_cost=head)
        costs = [stop - start for start, stop in bounds]
        costs[0] += 0.3
        costs[-1] += head
        ideal = sum(costs) / n
        assert max(costs) - min(costs) <= 1.0 + 1e-9, (bounds, costs)
        assert bounds[-1][1] - bounds[-1][0] <= \
            bounds[0][1] - bounds[0][0], bounds
        assert abs(max(costs) - ideal) <= 1.0, (costs, ideal)
        fns, inits = split_stages(cfg, n)
        assert len(fns) == n and len(inits) == n
        assert [f.blocks for f in fns] == bounds


def test_llama_split_pinning_and_virtual_assignment():
    """Embed on chunk 0, head on the last chunk; the virtual chunks are
    contiguous and cover every block once; the chunk functions compose
    into the JAX chunks' loss on the same (converted) weights."""
    from ray_tpu.models.llama import LlamaConfig as JConfig
    from ray_tpu.models.llama import split_stages as j_split
    from ray_tpu_torch.models.convert import llama_params_from_jax
    from ray_tpu_torch.models.llama import LlamaConfig, split_stages

    S, v = 2, 2
    fns, inits = split_stages(LlamaConfig.tiny(dtype=torch.float32,
                                               num_layers=4), S,
                              virtual_per_rank=v)
    assert len(fns) == S * v
    params = [f() for f in inits]
    assert "embed" in params[0] and "lm_head.weight" not in params[0]
    for mid in params[1:-1]:
        assert "embed" not in mid and "lm_head.weight" not in mid
    assert "lm_head.weight" in params[-1] and "embed" not in params[-1]
    seen = []
    for p in params:
        layers = sorted({int(k.split(".")[1]) for k in p
                         if k.startswith("layers.")})
        assert layers == list(range(layers[0], layers[0] + len(layers))) \
            if layers else True
        seen += layers
    assert seen == list(range(4)), seen

    jfns, jinits = j_split(JConfig.tiny(dtype=jnp.float32, num_layers=4), S,
                           virtual_per_rank=v)
    jparams = [jax.tree_util.tree_map(np.asarray, f()) for f in jinits]
    ids = np.random.default_rng(0).integers(0, 256, (2, 8)).astype(np.int32)
    h, jh = torch.from_numpy(ids).long(), jnp.asarray(ids)
    for c in range(S * v - 1):
        h = fns[c](llama_params_from_jax(jparams[c]), h)
        jh = jfns[c](jparams[c], jh)
        np.testing.assert_allclose(h.detach().numpy(), np.asarray(jh),
                                   rtol=1e-5, atol=1e-5)
    loss = fns[-1](llama_params_from_jax(jparams[-1]), h,
                   torch.from_numpy(ids).long())
    jloss = jfns[-1](jparams[-1], jh, jnp.asarray(ids))
    assert np.isfinite(float(loss))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)


def test_llama_1b_config_scale():
    from ray_tpu_torch.models.llama import LlamaConfig

    cfg = LlamaConfig.llama_1b()
    assert 1.0e9 < cfg.n_params < 1.25e9, cfg.n_params
    assert cfg.num_kv_heads < cfg.num_heads
    assert cfg.mlp_dim == 5632


def test_llama_pipeline_parity(cluster):
    """A split tiny Llama (the JAX chunks' weights) trained through the
    port's interleaved 2-stage pipeline matches the JAX chunks composed
    in one process with optax.adamw."""
    from ray_tpu.models.llama import LlamaConfig as JConfig
    from ray_tpu.models.llama import split_stages as j_split
    from ray_tpu_torch.models.convert import llama_params_from_jax
    from ray_tpu_torch.models.llama import LlamaConfig, split_stages
    from ray_tpu_torch.train.torch import adamw

    jfns, jinits = j_split(JConfig.tiny(dtype=jnp.float32), 2,
                           virtual_per_rank=2)
    jparams = [jax.tree_util.tree_map(np.asarray, f()) for f in jinits]
    fns, _ = split_stages(LlamaConfig.tiny(dtype=torch.float32), 2,
                          virtual_per_rank=2)
    params = [llama_params_from_jax(p) for p in jparams]
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 256, size=(8, 16)).astype(np.int32)

    pipe = _pipe(fns, params, functools.partial(adamw, learning_rate=1e-3),
                 num_microbatches=2, virtual_per_rank=2)
    losses = [pipe.train_step(ids, ids) for _ in range(2)]
    pipe.stop()
    ref_losses, _ = _jax_reference(jfns, jparams, ids, ids,
                                   optax.adamw(1e-3), 2)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4, atol=1e-5)
