"""The port's ZeRO update against the JAX package's
(``ray_tpu_torch/parallel/zero.py`` vs ``ray_tpu/parallel/zero.py``).

The JAX update runs inside a ``shard_map`` over W of the 8 virtual CPU
devices; the port's in W gloo ranks of a ``MeshGroup`` (one module
cluster; torch on one thread a rank), each rank on its slice of the same
seeded batch.  Held, each at the tolerance stated beside it: the flat
layout on GPT-2 tiny's flax tree (exact), the update at world 1, 2 and 4
in both wire modes against the replicated update and against JAX's (fp32
tolerance, and bit-identical parameters across ranks), the int8 wire's
envelope, the memory numbers (exact), and the optimizer state's
checkpoint: N -> M restores, and each package's fp32 ZeRO checkpoint
restored by the other."""
import shutil
import tempfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from ray_tpu.parallel import zero as jz
from ray_tpu.rllib.utils import mesh as mesh_util
from ray_tpu_torch.checkpoint.tree import flatten_with_paths
from ray_tpu_torch.parallel import zero as tz

T = 120  # seconds: the bound of every gang call
LR, CLIP, STEPS = 1e-2, 0.5, 3
# JAX's own test's tolerance for the sharded vs the replicated update
# (test_zero.py::test_zero_update_matches_replicated); the port's Adam
# and optax's differ in fp32 rounding only (measured <= 4e-7 here).
RTOL, ATOL = 2e-5, 2e-6


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


def _toy(seed=0):
    """test_zero.py's toy tree: 111 sharded elements (a remainder at
    2/4/8), a scalar and a ``should_shard``-rejected leaf; and 64
    targets."""
    rs = np.random.RandomState(seed)
    params = {
        "w1": rs.randn(7).astype(np.float32),
        "w2": rs.randn(13, 3).astype(np.float32),
        "b": rs.randn(5).astype(np.float32),
        "emb": rs.randn(12, 5).astype(np.float32),
        "scale": np.asarray(1.5, np.float32),
        "norm": rs.randn(4).astype(np.float32),
    }
    return params, rs.randn(64).astype(np.float32)


def _should_shard(path):
    return "norm" not in path


def _torch_loss(p, x):
    v = (p["w1"].sum() + (p["w2"] * 0.1).sum() + p["b"].sum()
         + (p["emb"] ** 2).sum() * 0.01 + p["scale"] * p["norm"].sum())
    return ((x - v) ** 2).mean()


def _jax_loss(p, x):
    v = (jnp.sum(p["w1"]) + jnp.sum(p["w2"] * 0.1) + jnp.sum(p["b"])
         + jnp.sum(p["emb"] ** 2) * 0.01 + p["scale"] * jnp.sum(p["norm"]))
    return jnp.mean((x - v) ** 2)


def _torch_tx():
    return tz.chain(tz.zero_clip_by_global_norm(CLIP),
                    lambda ps: torch.optim.Adam(ps, LR, eps=1e-8))


def _grads(p, x):
    names = sorted(p)
    g = torch.autograd.grad(_torch_loss(p, x), [p[k] for k in names])
    return dict(zip(names, g))


def _rank_zero_run(world, mode, quantized, steps, opt_global=None):
    """In a gang rank (or in-process at world 1): ``steps`` ZeRO updates
    of the toy tree on this rank's slice of the targets; the parameters
    and this rank's local opt tree, as numpy."""
    import torch

    from ray_tpu_torch.ops import collectives as c
    from ray_tpu_torch.parallel import zero as z

    params, x = _toy()
    rank = c.rank_of() if world > 1 else 0
    zu = z.build_zero_update(params, _torch_tx(), world, zero_sharding=mode,
                             quantized=quantized,
                             should_shard=_should_shard)
    p = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    opt = zu.init_opt(p, rank)
    if opt_global is not None:
        opt.load_global_tree(opt_global)
    per = x.shape[0] // world
    xr = torch.from_numpy(x[rank * per:(rank + 1) * per])
    for _ in range(steps):
        zu.update(_grads(p, xr), opt, p)
    return ({k: v.detach().numpy() for k, v in p.items()},
            z.tree_map_with_path(lambda kp, a: a.numpy(), opt.local_tree()))


def _run(gangs, world, mode, quantized="off", steps=STEPS):
    if world == 1:
        return [_rank_zero_run(1, mode, quantized, steps)]
    return gangs[world].run(_rank_zero_run, world, mode, quantized, steps,
                            timeout=T)


def _replicated(steps=STEPS):
    """The port's replicated update: clip, then Adam, on the whole tree."""
    params, x = _toy()
    p = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    names = sorted(p)
    opt = torch.optim.Adam([p[k] for k in names], LR, eps=1e-8)
    xt = torch.from_numpy(x)
    for _ in range(steps):
        g = _grads(p, xt)
        norm = torch.sqrt(sum(v.square().sum() for v in g.values()))
        for k in names:
            p[k].grad = g[k] if norm < CLIP else g[k] / norm * CLIP
        opt.step()
    return {k: v.detach().numpy() for k, v in p.items()}


def _jax_run(world, mode, quantized="off", steps=STEPS):
    params, x = _toy()
    params = {k: jnp.asarray(v) for k, v in params.items()}
    mesh = mesh_util.data_mesh(world)
    tx = optax.chain(jz.zero_clip_by_global_norm(CLIP), optax.adam(LR))
    zu = jz.build_zero_update(params, tx, world, zero_sharding=mode,
                              quantized=quantized,
                              should_shard=_should_shard)
    stepj = jax.jit(mesh_util._shard_map(
        lambda p, o, xl: zu.update(jax.grad(_jax_loss)(p, xl), o, p),
        mesh=mesh, in_specs=(P(), zu.opt_specs, P("data")),
        out_specs=(P(), zu.opt_specs)))
    sh = jax.tree_util.tree_map(lambda s: NamedSharding(mesh, s),
                                zu.opt_specs,
                                is_leaf=lambda s: isinstance(s, P))
    p, o = params, jax.device_put(zu.init_opt(params), sh)
    for _ in range(steps):
        p, o = stepj(p, o, jnp.asarray(x))
    return jax.device_get(p), jax.device_get(o), zu.sharder, tx


def _global(local_trees):
    """The GLOBAL opt tree of a run: the ranks' shard rows stacked."""
    first = local_trees[0]
    return tz.tree_map_with_path(
        lambda kp, x: np.concatenate([_at(t, kp) for t in local_trees])
        if ("shard" in kp and x.ndim >= 2) else x, first)


def _at(tree, kp):
    for k in kp:
        tree = tree[k]
    return tree


def _gpt2_tiny_tree():
    from ray_tpu.models import GPT2, GPT2Config

    model = GPT2(GPT2Config.tiny(dtype=jnp.float32))
    return jax.tree_util.tree_map(np.asarray, model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])


@pytest.mark.parametrize("world", [1, 2, 4, 8])
def test_sharder_layout_equals_jax_on_gpt2_tiny(world):
    """Leaf order, mask, total, chunk, offsets and the flat vector of
    GPT-2 tiny's flax tree equal JAX's, with and without a
    ``should_shard`` that keeps the LayerNorms replicated."""
    tree = _gpt2_tiny_tree()
    for ss in (None, lambda path: "ln" not in path):
        j = jz.ZeroSharder(tree, world, should_shard=ss)
        t = tz.ZeroSharder(tree, world, should_shard=ss)
        assert (t.total, t.chunk, t.padded, t._sharded_mask) == \
            (j.total, j.chunk, j.padded, j._sharded_mask)
        np.testing.assert_array_equal(t._offsets, j._offsets)
        jf, jr = j.split(jax.tree_util.tree_map(jnp.asarray, tree))
        tf, tr = t.split(tree)
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
        assert len(tr) == len(jr)
        back = t.merge(tf, tr)
        for (pa, a), (pb, b) in zip(flatten_with_paths(back),
                                    flatten_with_paths(tree)):
            assert pa == pb
            np.testing.assert_array_equal(np.asarray(a), b)


@pytest.mark.parametrize("world", [1, 2, 4])
@pytest.mark.parametrize("mode", ["opt", "opt+grads"])
def test_zero_update_matches_replicated_and_jax(gangs, world, mode):
    """3 clipped Adam updates on the toy tree: the ranks' parameters are
    the same bits, equal the port's replicated update and JAX's sharded
    update at (RTOL, ATOL); each rank's opt shard equals the matching
    rows of JAX's global opt state at the same tolerance."""
    got = _run(gangs, world, mode)
    for params, _ in got[1:]:
        for k in params:
            np.testing.assert_array_equal(params[k], got[0][0][k])
    ref = _replicated()
    jp, jo, _, _ = _jax_run(world, mode)
    for k in ref:
        np.testing.assert_allclose(got[0][0][k], ref[k], rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(got[0][0][k], np.asarray(jp[k]),
                                   rtol=RTOL, atol=ATOL)
    mine = flatten_with_paths(_global([o for _, o in got]))
    theirs = flatten_with_paths(jo)
    assert [p for p, _ in mine] == [p for p, _ in theirs]
    for (_, a), (_, b) in zip(mine, theirs):
        np.testing.assert_allclose(np.asarray(a, np.float64),
                                   np.asarray(b, np.float64),
                                   rtol=RTOL, atol=ATOL)


def test_int8_wire_close_to_fp32_and_replicas_identical(gangs):
    """ZeRO-2 with the int8 wire over 4 ranks: the ranks' parameters are
    the same bits, and they track the fp32 wire within JAX's test's Adam
    envelope (steps * lr * 1.5: Adam moves an element by ~lr a step
    whatever its gradient's error)."""
    q = _run(gangs, 4, "opt+grads", "int8", steps=2)
    f = _run(gangs, 4, "opt+grads", "off", steps=2)
    for params, _ in q[1:]:
        for k in params:
            np.testing.assert_array_equal(params[k], q[0][0][k])
    diff = max(np.abs(q[0][0][k] - f[0][0][k]).max() for k in q[0][0])
    assert diff < 2 * LR * 1.5


@pytest.mark.parametrize("world", [1, 2, 3, 4, 8])
def test_opt_bytes_equal_jax(world):
    """The memory envelope's numbers equal JAX's exactly: the toy tree
    (clip + Adam), and a large tree (Adam, AdamW) where the per-replica
    share is 1/N + 2%."""
    params, _ = _toy()
    jt = jz.ZeroSharder({k: jnp.asarray(v) for k, v in params.items()},
                        world, _should_shard)
    tt = tz.ZeroSharder(params, world, _should_shard)
    jtx = optax.chain(jz.zero_clip_by_global_norm(CLIP), optax.adam(LR))
    assert tt.opt_bytes_per_replica(_torch_tx()) == \
        jt.opt_bytes_per_replica(jtx)
    assert tt.replicated_opt_bytes(_torch_tx()) == \
        jt.replicated_opt_bytes(jtx)
    big = {"w": jax.ShapeDtypeStruct((1000, 257), jnp.float32),
           "b": jax.ShapeDtypeStruct((1003,), jnp.float32)}
    big_t = {"w": torch.empty((1000, 257), device="meta"),
             "b": torch.empty((1003,), device="meta")}
    for jtx, ttx in ((optax.adam(1e-3),
                      lambda ps: torch.optim.Adam(ps, 1e-3)),
                     (optax.adamw(1e-3),
                      lambda ps: torch.optim.AdamW(ps, 1e-3))):
        js, ts = jz.ZeroSharder(big, world), tz.ZeroSharder(big_t, world)
        per, full = ts.opt_bytes_per_replica(ttx), \
            ts.replicated_opt_bytes(ttx)
        assert (per, full) == (js.opt_bytes_per_replica(jtx),
                               js.replicated_opt_bytes(jtx))
        assert per <= full * (1.0 / world + 0.02)


def test_opt_state_restores_two_to_one_and_to_four(gangs):
    """2 steps on 2 ranks, the sharded opt state saved (one shard file a
    rank, ``[start, stop]`` against the ``(total,)`` globals), restored
    at world 1: 2 more steps land on the replicated 4-step trajectory at
    (RTOL, ATOL); restored at world 4, the rows reassemble the saved
    vectors bit for bit."""
    two = _run(gangs, 2, "opt+grads", steps=2)
    params, _ = _toy()
    s2 = tz.ZeroSharder(params, 2, _should_shard)
    root = tempfile.mkdtemp(prefix="rttp_zero_ckpt_")
    try:
        out = tz.save_opt_state(root, 1, s2, _global([o for _, o in two]))
        assert out["manifest"]["world_size"] == 2
        s1 = tz.ZeroSharder(params, 1, _should_shard)
        g1 = tz.restore_opt_state(root, s1, _torch_tx())
        zu = tz.build_zero_update(params, _torch_tx(), 1,
                                  should_shard=_should_shard)
        p = {k: torch.tensor(v, requires_grad=True)
             for k, v in two[0][0].items()}
        opt = zu.init_opt(p, 0)
        opt.load_global_tree(g1)
        x = torch.from_numpy(_toy()[1])
        for _ in range(2):
            zu.update(_grads(p, x), opt, p)
        ref = _replicated(steps=4)
        for k in ref:
            np.testing.assert_allclose(p[k].detach().numpy(), ref[k],
                                       rtol=RTOL, atol=ATOL)
        s4 = tz.ZeroSharder(params, 4, _should_shard)
        g4 = tz.restore_opt_state(root, s4, _torch_tx())
        saved = _global([o for _, o in two])
        for (pa, a), (_, b) in zip(flatten_with_paths(saved),
                                   flatten_with_paths(g4)):
            if '"shard"' in pa:
                assert tuple(b.shape) == (4, s4.chunk)
                np.testing.assert_array_equal(
                    np.asarray(b).reshape(-1)[:s4.total],
                    a.reshape(-1)[:s2.total])
    finally:
        shutil.rmtree(root, ignore_errors=True)


def test_each_package_restores_the_others_zero_checkpoint():
    """JAX's ``save_opt_state`` at world 2 restored by the port at world
    1, and the port's restored by JAX at world 1: the assembled globals
    equal the saver's, bit for bit."""
    params, _ = _toy()
    _, jo, jsh, jtx = _jax_run(2, "opt+grads", steps=2)
    root = tempfile.mkdtemp(prefix="rttp_zero_cross_")
    try:
        jz.save_opt_state(root, 3, jsh, jo)
        g1 = tz.restore_opt_state(root, tz.ZeroSharder(
            params, 1, _should_shard), _torch_tx())
        want = tz.tree_map_with_path(
            lambda kp, x: np.asarray(x).reshape(-1)[:jsh.total]
            if ("shard" in kp and np.ndim(x) >= 2) else np.asarray(x), jo)
        for (pa, a), (pb, b) in zip(flatten_with_paths(g1),
                                    flatten_with_paths(want)):
            assert pa == pb
            np.testing.assert_array_equal(np.asarray(a).reshape(-1)[
                :b.size] if '"shard"' in pa else np.asarray(a), b)
        # And back: the port saves that state at world 2, JAX restores it.
        t2 = tz.ZeroSharder(params, 2, _should_shard)
        tz.save_opt_state(root, 4, t2, tz.tree_map_with_path(
            lambda kp, x: np.asarray(x), jo))
        jsh1 = jz.ZeroSharder({k: jnp.asarray(v) for k, v in
                               params.items()}, 1, _should_shard)
        back = jz.restore_opt_state(root, jsh1, jtx, step=4)
        for (_, a), (_, b) in zip(flatten_with_paths(back),
                                  flatten_with_paths(want)):
            np.testing.assert_array_equal(np.asarray(a).reshape(-1)[
                :np.size(b)], np.asarray(b).reshape(-1))
    finally:
        shutil.rmtree(root, ignore_errors=True)
