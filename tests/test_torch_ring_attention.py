"""The port's sequence parallelism against the JAX package's
(``ray_tpu_torch/parallel/ring_attention.py`` vs
``ray_tpu/parallel/ring_attention.py``; ``blockwise_update`` of
``ops/attention.py``).

The same seeded numpy q, k, v go through JAX's ``ring_attention`` and
``ulysses_attention`` over a ``sequence`` mesh of W of the 8 virtual CPU
devices and through the port's over W gloo ranks of one ``MeshGroup``,
each rank holding its [B, L/W, H, D] shard.  Forward and the gradients of
sum(o^2) are held to JAX's and to full attention at
``tests/test_parallel.py``'s tolerances: 2e-5 forward, 5e-4 gradients
(atol and rtol)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.ops import attention as jattn
from ray_tpu.parallel import MeshSpec as JMeshSpec
from ray_tpu.parallel import make_mesh as j_make_mesh
from ray_tpu.parallel import ring_attention as j_ring
from ray_tpu.parallel import ulysses_attention as j_ulysses
from ray_tpu_torch.ops import attention as tattn

T = 120  # seconds: the bound of every gang call
FWD_TOL, GRAD_TOL = 2e-5, 5e-4


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

    rt.init(num_cpus=8, num_gpus=0, object_store_memory=256 * 1024**2)
    groups = {}
    try:
        for w in (2, 4):
            groups[w] = MeshGroup(w, bootstrap_timeout=T)
        yield groups
    finally:
        for g in groups.values():
            g.shutdown()
        rt.shutdown()


def _qkv(seed, b=2, l=256, h=4, d=16):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, l, h, d)).astype(np.float32)
            for _ in range(3)]


def _sp_rank(kind, q, k, v, causal):
    """In each gang rank: this rank's shard of the output and of the
    gradients of the sum over ranks of sum(o^2)."""
    import torch

    from ray_tpu_torch.parallel import MeshSpec, make_mesh, ring_attention
    from ray_tpu_torch.parallel import ulysses_attention

    torch.set_num_threads(1)
    mesh = make_mesh(MeshSpec({"sequence": -1}))
    n, r = mesh.world, mesh.rank
    ls = q.shape[1] // n
    shards = [torch.from_numpy(t[:, r * ls:(r + 1) * ls]).requires_grad_(
        True) for t in (q, k, v)]
    fn = ring_attention if kind == "ring" else ulysses_attention
    o = fn(*shards, mesh, causal=causal)
    (o ** 2).sum().backward()
    return {"o": o.detach().numpy(), "grads": [s.grad.numpy()
                                               for s in shards]}


def _jax_run(kind, q, k, v, causal, world):
    mesh = j_make_mesh(JMeshSpec({"sequence": world}))
    fn = j_ring if kind == "ring" else j_ulysses

    def loss(q, k, v):
        return jnp.sum(fn(q, k, v, mesh, causal=causal) ** 2)

    args = [jnp.asarray(t) for t in (q, k, v)]
    out = jax.jit(lambda *a: fn(*a, mesh, causal=causal))(*args)
    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*args)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _full(q, k, v, causal):
    ts = [torch.from_numpy(t).requires_grad_(True) for t in (q, k, v)]
    o = tattn.mha_attention(*ts, causal=causal, use_flash=False)
    (o ** 2).sum().backward()
    return o.detach().numpy(), [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("kind", ["ring", "ulysses"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("world", [2, 4])
def test_sequence_parallel_matches_jax_and_full_attention(gangs, kind,
                                                          causal, world):
    """Over W gloo ranks, the ranks' shards put together: the output at
    2e-5 and the gradients of q, k and v at 5e-4 against JAX's program
    over W devices and against full attention (Ulysses with 8 heads, as
    JAX's test)."""
    q, k, v = _qkv(world + 10 * causal, h=8 if kind == "ulysses" else 4)
    got = gangs[world].run(_sp_rank, kind, q, k, v, causal, timeout=T)
    o = np.concatenate([g["o"] for g in got], axis=1)
    grads = [np.concatenate([g["grads"][i] for g in got], axis=1)
             for i in range(3)]
    for want_o, want_g in (_jax_run(kind, q, k, v, causal, world),
                           _full(q, k, v, causal)):
        np.testing.assert_allclose(o, want_o, atol=FWD_TOL, rtol=FWD_TOL)
        for g, w in zip(grads, want_g):
            np.testing.assert_allclose(g, w, atol=GRAD_TOL, rtol=GRAD_TOL)


def _data_by_sequence_rank(kind, q, k, v, causal):
    """In each of 4 ranks of a data=2 x sequence=2 mesh: this rank's
    batch half and sequence half, over its ``sequence`` line's group."""
    import torch

    from ray_tpu_torch.parallel import MeshSpec, make_mesh, ring_attention
    from ray_tpu_torch.parallel import ulysses_attention

    torch.set_num_threads(1)
    mesh = make_mesh(MeshSpec({"data": 2, "sequence": 2}))
    b, l = q.shape[0] // 2, q.shape[1] // 2
    di, si = mesh.coords["data"], mesh.coords["sequence"]
    shards = [torch.from_numpy(t[di * b:(di + 1) * b, si * l:(si + 1) * l])
              for t in (q, k, v)]
    fn = ring_attention if kind == "ring" else ulysses_attention
    return di, si, fn(*shards, mesh, causal=causal).numpy()


@pytest.mark.parametrize("kind", ["ring", "ulysses"])
def test_sequence_axis_inside_a_data_by_sequence_mesh(gangs, kind):
    """JAX's test mesh shape, data x sequence: each rank's sequence group
    is its line along ``sequence`` (``Mesh.axis_group``), and the four
    shards put together equal full attention at 2e-5."""
    q, k, v = _qkv(5, b=4, l=64, h=4)
    out = np.zeros_like(q)
    for di, si, o in gangs[4].run(_data_by_sequence_rank, kind, q, k, v,
                                  True, timeout=T):
        out[di * 2:(di + 1) * 2, si * 32:(si + 1) * 32] = o
    want, _ = _full(q, k, v, True)
    np.testing.assert_allclose(out, want, atol=FWD_TOL, rtol=FWD_TOL)


def test_ulysses_refuses_heads_that_do_not_divide(gangs):
    def rank(q):
        import torch

        from ray_tpu_torch.parallel import MeshSpec, make_mesh
        from ray_tpu_torch.parallel import ulysses_attention

        mesh = make_mesh(MeshSpec({"sequence": -1}))
        t = torch.from_numpy(q)
        try:
            ulysses_attention(t, t, t, mesh)
        except ValueError as e:
            return str(e)
        return None

    q = _qkv(0, l=16, h=3)[0]
    assert all("not divisible" in (m or "")
               for m in gangs[2].run(rank, q, timeout=T))


@pytest.mark.parametrize("kind", ["ring", "ulysses"])
def test_no_sequence_axis_falls_back_to_mha_attention(kind):
    """A mesh without a ``sequence`` axis (one process, the ``data``
    axis) runs plain attention, as JAX's fallback does; JAX's fallback
    on the same inputs agrees."""
    from ray_tpu_torch.parallel import MeshSpec, make_mesh
    from ray_tpu_torch.parallel import ring_attention, ulysses_attention

    q, k, v = _qkv(3, l=64)
    fn = ring_attention if kind == "ring" else ulysses_attention
    got = fn(*(torch.from_numpy(t) for t in (q, k, v)),
             make_mesh(MeshSpec({"data": -1})), causal=True).numpy()
    want = tattn.mha_attention(*(torch.from_numpy(t) for t in (q, k, v)),
                               causal=True, use_flash=False).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)
    j_fn = j_ring if kind == "ring" else j_ulysses
    jw = j_fn(*(jnp.asarray(t) for t in (q, k, v)),
              j_make_mesh(JMeshSpec({"data": 8})), causal=True)
    np.testing.assert_allclose(got, np.asarray(jw), atol=2e-5)


def test_one_rank_sequence_axis_is_the_ring_alone():
    """A ``sequence`` axis of one rank (no process group) runs the ring's
    recurrence over the one block: equal to full attention, gradients
    included."""
    from ray_tpu_torch.parallel import MeshSpec, make_mesh, ring_attention

    mesh = make_mesh(MeshSpec({"sequence": 1}))
    q, k, v = _qkv(4, l=64)
    ts = [torch.from_numpy(t).requires_grad_(True) for t in (q, k, v)]
    o = ring_attention(*ts, mesh, causal=True)
    (o ** 2).sum().backward()
    want_o, want_g = _full(q, k, v, True)
    np.testing.assert_allclose(o.detach().numpy(), want_o, atol=FWD_TOL,
                               rtol=FWD_TOL)
    for t, w in zip(ts, want_g):
        np.testing.assert_allclose(t.grad.numpy(), w, atol=GRAD_TOL,
                                   rtol=GRAD_TOL)


def _blocks(seed):
    rng = np.random.default_rng(seed)
    q, kb, vb = (rng.normal(size=(2, 8, 3, 4)).astype(np.float32)
                 for _ in range(3))
    o = rng.normal(size=(2, 8, 3, 4)).astype(np.float32)
    l = np.abs(rng.normal(size=(2, 3, 8))).astype(np.float32)
    m = rng.normal(size=(2, 3, 8)).astype(np.float32)
    return q, kb, vb, o, l, m


@pytest.mark.parametrize("masked", ["none", "causal", "rows", "all"])
def test_blockwise_update_matches_jax(masked):
    """One step of the recurrence on the same accumulators, and the
    normalized result, against JAX's; a row masked throughout keeps m =
    NEG_INF, l = 0, o = 0 and finalizes to zeros."""
    q, kb, vb, o, l, m = _blocks(7)
    mask = {"none": None,
            "causal": np.tril(np.ones((8, 8), bool)),
            "rows": np.repeat(np.arange(8)[:, None] < 5, 8, axis=1),
            "all": np.zeros((8, 8), bool)}[masked]
    if masked in ("rows", "all"):  # rows that saw nothing before either
        o[:, 5:] = 0.0
        l[..., 5:] = 0.0
        m[..., 5:] = jattn.NEG_INF
        if masked == "all":
            o[:], l[:], m[:] = 0.0, 0.0, jattn.NEG_INF
    want = jattn.blockwise_update(
        *(jnp.asarray(a) for a in (q, kb, vb, o, l, m)),
        None if mask is None else jnp.asarray(mask))
    got = tattn.blockwise_update(
        *(torch.from_numpy(a) for a in (q, kb, vb, o, l, m)),
        None if mask is None else torch.from_numpy(mask))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)
    fin = tattn.finalize_blockwise(got[0], got[1]).numpy()
    np.testing.assert_allclose(fin, np.asarray(jattn.finalize_blockwise(
        want[0], want[1])), rtol=1e-5, atol=1e-6)
    if masked in ("rows", "all"):
        first_dead = 5 if masked == "rows" else 0
        assert (got[2][..., first_dead:] == jattn.NEG_INF).all()
        assert (got[1][..., first_dead:] == 0).all()
        assert (fin[:, first_dead:] == 0).all()
