"""The port's quantized collectives against the JAX package's
(``ray_tpu_torch/ops/collectives.py`` vs ``ray_tpu/ops/collectives.py``).

The block-int8 format itself runs on the same seeded numpy inputs
through both packages: q and the scales bit for bit at round-to-nearest
(the same fp32 ops, half-to-even rounding in both).  The collectives run
where each package runs them: JAX's inside a ``shard_map`` over W of the
8 virtual CPU devices (``tests/conftest.py``), the port's in W gloo ranks
of one ``MeshGroup`` (one module cluster, torch on one thread a rank).
Every rank must hold the same bytes after ``quantized_pmean``; each
result is held to JAX's at the tolerance stated beside it."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from ray_tpu.ops import collectives as jc
from ray_tpu.rllib.utils import mesh as mesh_util
from ray_tpu_torch.ops import collectives as tc

T = 120  # seconds: the bound of every gang call


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
def gangs():
    """Gloo gangs of 2 and 4 CPU ranks on one port cluster."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.parallel import MeshGroup

    # Two CPUs past the gangs' six: a suite run under six workers once
    # waited 120 s for a gang's placement group with exactly six declared.
    rt.init(num_cpus=8, num_gpus=0, object_store_memory=256 * 1024**2)
    groups = {}
    try:
        # Shut down whatever formed, even when a gang's rendezvous fails:
        # a leaked cluster loads every test file that runs after this one.
        for w in (2, 4):
            groups[w] = MeshGroup(w, bootstrap_timeout=T)
        yield groups
    finally:
        for g in groups.values():
            g.shutdown()
        rt.shutdown()


def _inputs(seed, shape):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    x[..., :256] = 0.0  # an all-zero block: scale 0, q exactly 0
    return x


@pytest.mark.parametrize("shape", [(1000,), (3, 531), (2, 4, 256)])
def test_quantize_equals_jax_bitwise(shape):
    """q and the scales equal JAX's bit for bit; the dequantized values
    too; zeros survive exactly."""
    x = _inputs(0, shape)
    jq, js = jc.quantize_block_int8(jnp.asarray(x))
    tq, ts = tc.quantize_block_int8(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    n = shape[-1]
    np.testing.assert_array_equal(
        tc.dequantize_block_int8(tq, ts, n).numpy(),
        np.asarray(jc.dequantize_block_int8(jq, js, n)))
    assert (tc.dequantize_block_int8(tq, ts, n)[..., :256] == 0).all()


def test_numpy_twins_equal_torch_and_jax():
    x = _inputs(1, (3, 700))
    q, s = tc.quantize_block_int8_np(x)
    tq, ts = tc.quantize_block_int8(torch.from_numpy(x))
    jq, js = jc.quantize_block_int8_np(x)
    np.testing.assert_array_equal(q, tq.numpy())
    np.testing.assert_array_equal(s, ts.numpy())
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(
        tc.dequantize_block_int8_np(q, s, 700),
        jc.dequantize_block_int8_np(jq, js, 700))


def test_stochastic_rounding_unbiased_and_keeps_zeros():
    """E[dequant(quant(x, generator))] -> x within 2e-3 over 64 draws
    (JAX's test's bound), where round-to-nearest pins every draw to the
    same bucket; zero blocks stay exactly zero."""
    gen = torch.Generator().manual_seed(0)
    x = torch.full((512,), 0.3)
    draws = [tc.dequantize_block_int8(
        *tc.quantize_block_int8(x, generator=gen), 512) for _ in range(64)]
    assert abs(torch.stack(draws).mean().item() - 0.3) < 2e-3
    q, s = tc.quantize_block_int8(torch.zeros(300), generator=gen)
    assert (tc.dequantize_block_int8(q, s, 300) == 0).all()


@pytest.mark.parametrize("zero_sharding", ["off", "opt", "opt+grads"])
@pytest.mark.parametrize("quantized", ["off", "int8"])
def test_comm_bytes_accounting_equals_jax(zero_sharding, quantized):
    for n in (111, 124_439_808):
        for w in (1, 2, 3, 4, 8, 16):
            assert tc.comm_bytes_accounting(
                n, w, zero_sharding=zero_sharding, quantized=quantized) == \
                jc.comm_bytes_accounting(
                    n, w, zero_sharding=zero_sharding, quantized=quantized)
    assert tc.int8_wire_bytes(4096, 64) == jc.int8_wire_bytes(4096, 64)


def _rank_collectives(per_rank):
    """In each gang rank: quantized reduce-scatter of this rank's rows,
    quantized_pmean of a two-leaf tree, and the exact sum."""
    import torch

    from ray_tpu_torch.ops import collectives as c

    rank, world = c.rank_of(), c.world_of()
    x = torch.from_numpy(per_rank[rank])
    chunk = -(-x.numel() // world)
    rows = torch.cat([x, x.new_zeros(world * chunk - x.numel())]
                     ).reshape(world, chunk)
    rs = c.quantized_reduce_scatter_mean(rows)
    tree = {"a": x[:500].reshape(20, 25), "b": x[500:]}
    pm = c.quantized_pmean(tree)
    flat = torch.cat([pm["a"].reshape(-1), pm["b"]])
    return {"rs": rs.numpy(), "pmean": flat.numpy(),
            "sum": c.all_reduce_sum(x).numpy()}


def _jax_collectives(per_rank):
    w = per_rank.shape[0]
    mesh = mesh_util.data_mesh(w)
    chunk = -(-per_rank.shape[1] // w)

    def body(x):
        flat = x[0]
        rows = jnp.concatenate(
            [flat, jnp.zeros((w * chunk - flat.shape[0],))]).reshape(
                w, chunk)
        rs = jc.quantized_reduce_scatter_mean(rows, "data")
        t = {"a": flat[:500].reshape(20, 25), "b": flat[500:]}
        out = jc.quantized_pmean(t, "data", w)
        pm = jnp.concatenate([out["a"].reshape(-1), out["b"]])
        return rs[None], pm[None]

    rs, pm = jax.jit(mesh_util._shard_map(
        body, mesh=mesh, in_specs=(P("data"),),
        out_specs=(P("data"), P("data"))))(jnp.asarray(per_rank))
    return np.asarray(rs), np.asarray(pm)


@pytest.mark.parametrize("world", [2, 4])
def test_quantized_collectives_over_gloo_ranks_match_jax(gangs, world):
    """Over W gloo ranks: every rank's ``quantized_pmean`` is the same
    bytes; each rank's reduce-scatter chunk equals JAX's over W virtual
    devices to 1e-6 (the same dequantized values summed in another
    order); the pmean equals JAX's to one quantization step of the
    gathered chunk (a 1-ulp difference in the reduced chunk may round to
    the next int8 step) and the exact fp32 mean to 0.05 (JAX's test's
    bound); ``all_reduce_sum`` is the same bytes on every rank and the
    exact sum to 1e-5."""
    per_rank = np.random.default_rng(world).normal(
        size=(world, 531)).astype(np.float32)
    got = gangs[world].run(_rank_collectives, per_rank, timeout=T)
    for r in range(1, world):
        np.testing.assert_array_equal(got[r]["pmean"], got[0]["pmean"])
        np.testing.assert_array_equal(got[r]["sum"], got[0]["sum"])
    j_rs, j_pm = _jax_collectives(per_rank)
    for r in range(world):
        np.testing.assert_allclose(got[r]["rs"], j_rs[r], rtol=0,
                                   atol=1e-6)
    step = np.abs(per_rank.mean(0)).max() / 127.0
    assert np.abs(got[0]["pmean"] - j_pm[0]).max() <= step + 1e-6
    assert np.abs(got[0]["pmean"] - per_rank.mean(0)).max() < 0.05
    np.testing.assert_allclose(got[0]["sum"], per_rank.sum(0), atol=1e-5)
