"""The port's MPMD pipeline on split GPT-2 chunks against the JAX
package's: ``tests/test_mpmd_pipeline.py``'s GPT-2 scenarios.  The split
bounds equal the JAX package's at GPT-2 small and XL; a tiny GPT-2 split
in two (the JAX chunks' weights, converted) trains through the port's
pipeline, stages in actors of one module cluster on the CPU, and its
losses are held to the JAX chunks composed in one process with
``optax.adamw`` at the JAX test's tolerance (rtol 1e-4, atol 1e-5).
Torch runs on one thread; chunk functions ship by value."""
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


def _pipe(fns, params, tx, **kw):
    from ray_tpu_torch.parallel.mpmd_pipeline import MPMDPipeline

    kw.setdefault("drain_timeout", T)
    return MPMDPipeline(fns, params, optimizer=tx, device="cpu", **kw)


def test_mpmd_gpt2_split_pipeline_parity(cluster):
    """A split tiny GPT-2 (the JAX chunks' weights, converted) trained
    through the port's 2-stage pipeline matches the JAX chunks composed
    in one process with optax.adamw."""
    from ray_tpu.models.gpt2 import GPT2Config as JConfig
    from ray_tpu.models.gpt2 import split_stages as j_split
    from ray_tpu_torch.models import GPT2Config, split_stages
    from ray_tpu_torch.models.convert import gpt2_params_from_jax

    jfns, jinits = j_split(JConfig.tiny(dtype=jnp.float32), 2)
    jparams = [jax.tree_util.tree_map(np.asarray, f()) for f in jinits]
    fns, _ = split_stages(GPT2Config.tiny(dtype=torch.float32), 2)
    params = [gpt2_params_from_jax(p) for p in jparams]
    rng = np.random.default_rng(11)
    ids = rng.integers(0, 512, size=(8, 32)).astype(np.int32)
    tx, jtx = _opt("adamw", 1e-3)

    pipe = _pipe(fns, params, tx, num_microbatches=4)
    losses = [pipe.train_step(ids, ids) for _ in range(3)]
    pipe.stop()

    ref_losses, _ = _jax_reference(jfns, jparams, ids, ids, jtx, 3)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4, atol=1e-5)



def test_gpt2_split_stages_cost_balance():
    """No cluster: the split bounds are the JAX package's, cover every
    block once, and the head-owning last chunk gets fewer blocks."""
    from ray_tpu.models.gpt2 import GPT2Config as JConfig
    from ray_tpu.models.gpt2 import split_stages as j_split
    from ray_tpu_torch.models import GPT2Config, split_stages

    for cfg, jcfg, stages in (
            (GPT2Config.gpt2_small(), JConfig.gpt2_small(), (2, 3, 4)),
            (GPT2Config.gpt2_xl(), JConfig.gpt2_xl(), (4,))):
        for n in stages:
            fns, inits = split_stages(cfg, n)
            assert len(fns) == n and len(inits) == n
            jfns, _ = j_split(jcfg, n)
            bounds = [f.blocks for f in fns]
            assert bounds == [f.__defaults__[0].blocks for f in jfns]
            assert [b for s, e in bounds for b in range(s, e)] == \
                list(range(cfg.num_layers))
    xl = GPT2Config.gpt2_xl()
    assert xl.num_layers == 48 and xl.hidden_size == 1600
    bounds = [f.blocks for f in split_stages(xl, 4)[0]]
    assert bounds[-1][1] - bounds[-1][0] < bounds[0][1] - bounds[0][0]
