"""The port's Mixture-of-Experts against the JAX package's
(``ray_tpu_torch/ops/moe.py`` vs ``ray_tpu/ops/moe.py``), the counterpart
of ``tests/test_moe.py``.

The same seeded numpy inputs go through both packages on the CPU in
fp32.  The routing (top-k, slot priority, capacity) is integer
bookkeeping on the same fp32 probabilities, so the dense masks are held
bit for bit; outputs and gradients differ only by summation order and
are held to 1e-5 relative to the output's scale.  The expert-parallel
MoE runs where each package runs it: JAX's ``shard_map`` over W of the 8
virtual CPU devices, the port's in W gloo ranks of one ``MeshGroup``."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.models import GPT2 as JGPT2
from ray_tpu.models import GPT2Config as JConfig
from ray_tpu.models.gpt2 import gpt2_loss_fn as j_loss_fn
from ray_tpu.ops import moe as jm
from ray_tpu.parallel.mesh import MeshSpec as JMeshSpec
from ray_tpu.parallel.mesh import make_mesh as j_make_mesh
from ray_tpu_torch.models import GPT2, GPT2Config, gpt2_loss_fn
from ray_tpu_torch.models.convert import gpt2_params_from_jax
from ray_tpu_torch.ops import moe as tm

T = 120  # seconds: the bound of every gang call
RTOL = 1e-5  # of the largest |value| of the reference

CONFIGS = [(4, 2, 1.0, 16), (8, 2, 1.25, 64), (4, 4, 4.0, 8),
           (8, 3, 0.5, 40), (8, 1, 1.0, 33)]  # (E, k, capacity factor, N)


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


def _close(got, want, rtol=RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rtol * max(np.abs(want).max(), 1e-30))


def _problem(e, n, d=16, f=32, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    w_router = (rng.normal(size=(d, e)) * 0.5).astype(np.float32)
    w_in = (rng.normal(size=(e, d, f)) * 0.2).astype(np.float32)
    w_out = (rng.normal(size=(e, f, d)) * 0.2).astype(np.float32)
    return x, w_router, w_in, w_out


def _cfgs(e, k, cf):
    return (jm.MoEConfig(e, k, cf, jnp.float32),
            tm.MoEConfig(e, k, cf, torch.float32))


@pytest.mark.parametrize("e,k,cf,n", CONFIGS)
def test_masks_capacity_and_gates_match_jax(e, k, cf, n):
    """The dispatch one-hot equals JAX's bit for bit (the same top-k,
    slot priority and drops); the combine weights within 1e-6; each token
    takes at most k slots, each slot at most one token, and a token's
    combine weights sum to at most 1 (JAX's test's properties)."""
    x, w_router, _, _ = _problem(e, n)
    jc, tc = _cfgs(e, k, cf)
    assert tc.capacity(n) == jc.capacity(n)
    cap = jc.capacity(n)
    jd, jcomb = jm.dispatch_combine_masks(
        jm.router_probs(jnp.asarray(x), jnp.asarray(w_router)), jc, cap)
    probs = tm.router_probs(torch.from_numpy(x), torch.from_numpy(w_router))
    td, tcomb = tm.dispatch_combine_masks(probs, tc, cap)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tcomb.numpy(), np.asarray(jcomb), atol=1e-6)
    assert (td.sum((1, 2)) <= k).all() and (td.sum(0) <= 1).all()
    sums = tcomb.sum((1, 2))
    assert ((sums >= 0) & (sums < 1 + 1e-5)).all()


def test_top_k_breaks_ties_toward_the_lower_index():
    """Equal probabilities choose the lower expert first, as
    ``lax.top_k`` does."""
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25],
                          [0.1, 0.3, 0.3, 0.3]])
    _, top_i = tm.top_k_gates(probs, 2)
    np.testing.assert_array_equal(top_i.numpy(), [[0, 1], [1, 2]])
    _, j_i = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    np.testing.assert_array_equal(top_i.numpy(), np.asarray(j_i))


def test_dense_k_equals_e_matches_full_mixture():
    """top_k == num_experts with ample capacity: the output is the
    softmax-weighted mixture of every expert MLP (nothing drops), and
    equals JAX's ``moe_apply``."""
    d, f = 16, 32
    cfg = tm.MoEConfig(num_experts=4, top_k=4, capacity_factor=4.0,
                       dtype=torch.float32)
    p = tm.init_moe_params(torch.Generator().manual_seed(0), d, f, cfg)
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(8, d)).astype(np.float32))
    got = tm.moe_apply(x, p["w_router"], p["w_in"], p["w_out"], cfg)
    probs = tm.router_probs(x, p["w_router"])
    ref = torch.zeros_like(x)
    for e in range(4):
        h = torch.nn.functional.gelu(x @ p["w_in"][e], approximate="tanh")
        ref = ref + probs[:, e:e + 1] * (h @ p["w_out"][e])
    _close(got.numpy(), ref.numpy(), 2e-5)
    want = jm.moe_apply(*(jnp.asarray(t.numpy()) for t in (
        x, p["w_router"], p["w_in"], p["w_out"])),
        jm.MoEConfig(4, 4, 4.0, jnp.float32))
    _close(got.numpy(), want)


@pytest.mark.parametrize("e,k,cf,n", CONFIGS)
def test_moe_apply_and_gradients_match_jax(e, k, cf, n):
    """Output and the gradients of sum(y^2) with respect to x and every
    weight (the router's through the gates) against JAX's autodiff, each
    gradient to 1e-5 of the largest gradient entry (at k = 1 the gate is
    p / p and the router's gradient is rounding noise)."""
    arrays = _problem(e, n, seed=e + n)
    jc, tc = _cfgs(e, k, cf)

    def j_loss(*a):
        return jnp.sum(jm.moe_apply(*a, jc) ** 2)

    want, jgrads = jax.value_and_grad(j_loss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in arrays))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    y = tm.moe_apply(*ts, tc)
    _close(y.detach().numpy(),
           np.asarray(jm.moe_apply(*(jnp.asarray(a) for a in arrays), jc)))
    (y ** 2).sum().backward()
    np.testing.assert_allclose((y ** 2).sum().item(), float(want),
                               rtol=1e-5)
    scale = max(float(jnp.abs(g).max()) for g in jgrads)
    for t, g in zip(ts, jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=0,
                                   atol=RTOL * scale)


def _ep_rank(x, w_router, w_in, w_out, e, k, cf, n_per):
    """In each gang rank: this rank's shard through
    ``make_expert_parallel_moe`` over the default group, and the
    gradients of the rank's sum(y^2)."""
    import torch

    from ray_tpu_torch.ops import moe
    from ray_tpu_torch.parallel.mesh import MeshSpec, make_mesh

    torch.set_num_threads(1)
    mesh = make_mesh(MeshSpec({"expert": -1}))
    r = mesh.rank
    fn = moe.make_expert_parallel_moe(
        mesh, moe.MoEConfig(e, k, cf, torch.float32), n_per)
    xs = torch.from_numpy(x[r * n_per:(r + 1) * n_per]).requires_grad_(True)
    ws = [torch.from_numpy(a).requires_grad_(True)
          for a in (w_router, w_in, w_out)]
    y = fn(xs, *ws)
    (y ** 2).sum().backward()
    return {"y": y.detach().numpy(), "dx": xs.grad.numpy(),
            "dw": [w.grad.numpy() for w in ws]}


@pytest.mark.parametrize("world", [2, 4])
def test_expert_parallel_over_gloo_ranks_matches_jax(gangs, world):
    """The port's all-to-all path over W gloo ranks equals JAX's
    ``make_expert_parallel_moe`` over W virtual devices and ``moe_apply``
    on each token shard (JAX's test's statement); the gradient of each
    shard's x, and the weights' gradients summed over the ranks (each
    rank holds its experts' slice), equal JAX's autodiff of the
    shard_map program."""
    e, k, cf, n_per = 8, 2, 2.0, 8
    x, w_router, w_in, w_out = _problem(e, world * n_per, seed=world)
    got = gangs[world].run(_ep_rank, x, w_router, w_in, w_out, e, k, cf,
                           n_per, timeout=T)
    jc = jm.MoEConfig(e, k, cf, jnp.float32)
    mesh = j_make_mesh(JMeshSpec({"expert": world}))
    ep_fn = jm.make_expert_parallel_moe(mesh, jc, n_per)
    args = [jnp.asarray(a) for a in (x, w_router, w_in, w_out)]

    def j_loss(*a):
        return jnp.sum(ep_fn(*a) ** 2)

    with mesh:
        want = ep_fn(*args)
        jgrads = jax.grad(j_loss, argnums=(0, 1, 2, 3))(*args)
    cap = jc.capacity(n_per)
    per_shard = np.concatenate([np.asarray(jm.moe_apply(
        args[0][i * n_per:(i + 1) * n_per], *args[1:], jc, capacity=cap))
        for i in range(world)])
    y = np.concatenate([g["y"] for g in got])
    _close(y, want)
    _close(y, per_shard)
    _close(np.concatenate([g["dx"] for g in got]), jgrads[0])
    for i in range(3):
        _close(sum(g["dw"][i] for g in got), jgrads[i + 1])


def _moe_pair(seed=0, **moe):
    jcfg = JConfig.moe_tiny(dtype=jnp.float32, **moe)
    jmodel = JGPT2(jcfg)
    params = jmodel.init(jax.random.PRNGKey(seed),
                         jnp.zeros((1, 8), jnp.int32))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    tmodel = GPT2(GPT2Config.moe_tiny(dtype=torch.float32, **moe))
    tmodel.load_state_dict(gpt2_params_from_jax(params), strict=True)
    return jmodel, params, tmodel


def test_moe_gpt2_tiny_logits_match_jax():
    """The MoE GPT-2 tiny on converted weights: logits equal JAX's
    (every block's MLP is the routed experts, nothing dense)."""
    jmodel, params, tmodel = _moe_pair(num_experts=4, top_k=2)
    assert {"moe_router", "moe_w_in", "moe_w_out"} <= set(params["h_0"])
    assert not any("mlp_fc" in k for k in tmodel.state_dict())
    ids = np.random.default_rng(1).integers(0, 512, (2, 24))
    want = np.asarray(jmodel.apply({"params": params},
                                   jnp.asarray(ids, jnp.int32)))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_moe_gpt2_trains_like_jax():
    """12 Adam(1e-3) steps on one batch (JAX's test_moe_gpt2_trains): the
    first loss equals JAX's, the last is below the first by more than
    0.2, as the JAX test requires of its own run."""
    import optax

    jmodel, params, tmodel = _moe_pair(num_experts=4, top_k=2)
    ids = np.random.default_rng(2).integers(0, 512, (4, 32))
    first_j = float(j_loss_fn(params, jmodel.apply,
                              {"input_ids": jnp.asarray(ids, jnp.int32)}))
    opt = torch.optim.Adam(tmodel.parameters(), lr=1e-3)
    losses = []
    for _ in range(12):
        opt.zero_grad()
        loss = gpt2_loss_fn(tmodel, {"input_ids": torch.from_numpy(ids)})
        loss.backward()
        opt.step()
        losses.append(loss.item())
    np.testing.assert_allclose(losses[0], first_j, rtol=1e-6)
    assert losses[-1] < losses[0] - 0.2, losses
    # The JAX model's own run on the same weights meets the same bound.
    tx = optax.adam(1e-3)
    p, state = params, tx.init(params)
    for _ in range(12):
        loss, g = jax.value_and_grad(j_loss_fn)(
            p, jmodel.apply, {"input_ids": jnp.asarray(ids, jnp.int32)})
        upd, state = tx.update(g, state, p)
        p = optax.apply_updates(p, upd)
    assert float(loss) < first_j - 0.2
    assert abs(float(loss) - losses[-1]) < 0.05
