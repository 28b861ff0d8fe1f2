"""The layouts dryrun of the port (chip_smoke.py's ``[layouts]``) on the
CPU, against one rank and against the JAX package's layouts: the
counterpart of ``__graft_entry__.py::_dryrun_one_mesh``.

GPT-2 tiny with MoE (4 experts, top-2, fp32, 4 heads) at batch
max(4, world) x 128, weights from the flax init through
``gpt2_params_from_jax``, ids from a numpy seed.  The port runs each
layout in two gloo ranks of one ``MeshGroup`` with chip_smoke's own
functions (``layout_rank``: DDP; the MoE over the global tokens in the
``data`` and ``sequence`` layouts, ``make_expert_parallel_moe`` in the
``expert`` one, ``ring_attention`` in ``sequence``) and holds them with
``check_layouts`` to one rank's step: data and sequence to the plain
model, expert to ``moe_apply`` on each token shard, losses within 1e-5
and gradients within 1e-4 (relative norm).  JAX runs the same layouts as
``_dryrun_one_mesh`` builds them (GSPMD over 2 of the 8 virtual devices,
``ring_attention`` as ``attn_fn`` over ``sequence``): its data and
sequence losses equal the port's within 1e-5 (the same function), and
every loss of both packages lies within the dryrun's spread of 5e-2 (the
port's expert layout has the per-shard capacity of expert parallelism,
GSPMD's the global batch's)."""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke as cs
from ray_tpu.models import GPT2 as JGPT2
from ray_tpu.models import GPT2Config as JConfig
from ray_tpu.models.gpt2 import gpt2_loss_fn as j_loss_fn
from ray_tpu.models.gpt2 import param_logical_axes
from ray_tpu.ops.moe import MoEConfig as JMoEConfig
from ray_tpu.parallel import MeshSpec, make_mesh, ring_attention
from ray_tpu.parallel.sharding import (
    ShardingRules,
    batch_sharding,
    shard_params,
)
from ray_tpu_torch.models.convert import gpt2_params_from_jax

T = 180  # seconds: the bound of every gang call
WORLD = cs.LAYOUT_WORLD


@pytest.fixture(scope="module", autouse=True)
def one_thread_and_fns_by_value():
    import sys

    import cloudpickle

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    cloudpickle.register_pickle_by_value(sys.modules[__name__])
    cloudpickle.register_pickle_by_value(cs)
    yield
    cloudpickle.unregister_pickle_by_value(cs)
    cloudpickle.unregister_pickle_by_value(sys.modules[__name__])
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def gang():
    import ray_tpu_torch as rt
    from ray_tpu_torch.parallel import MeshGroup

    rt.init(num_cpus=4, num_gpus=0, object_store_memory=256 * 1024**2)
    group = None
    try:
        group = MeshGroup(WORLD, bootstrap_timeout=T)
        yield group
    finally:
        if group is not None:
            group.shutdown()
        rt.shutdown()


def _jax_config():
    return JConfig.tiny(dtype=jnp.float32, num_heads=4,
                        moe=JMoEConfig(num_experts=4, top_k=2,
                                       dtype=jnp.float32))


@pytest.fixture(scope="module")
def problem():
    """(flax params, the port's state dict, ids)."""
    ids = cs.layout_ids(WORLD)
    params = JGPT2(_jax_config()).init(
        jax.random.PRNGKey(0), jnp.asarray(ids, jnp.int32))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    return params, gpt2_params_from_jax(params), ids


def _jax_layout_loss(layout, params, ids):
    """``_dryrun_one_mesh``'s program on one layout of two devices: the
    loss of its first train step (taken before the update)."""
    mesh = make_mesh(MeshSpec({layout: WORLD}),
                     devices=jax.devices()[:WORLD])
    cfg = _jax_config()
    if layout == "sequence":
        attn = functools.partial(ring_attention, mesh=mesh, axis="sequence",
                                 causal=True)
        model = JGPT2(cfg, attn_fn=lambda q, k, v: attn(q, k, v))
    else:
        model = JGPT2(cfg)
    p = shard_params(params, mesh, ShardingRules(), param_logical_axes(
        params))
    x = jax.device_put(jnp.asarray(ids, jnp.int32), batch_sharding(mesh))
    with mesh:
        loss = jax.jit(lambda p, x: j_loss_fn(p, model.apply,
                                              {"input_ids": x}))(p, x)
    return float(loss)


def _one_thread(fn, *args):
    """``fn(*args)`` in a gang rank on one torch thread (``fn`` is one of
    chip_smoke's functions, shipped by value)."""
    import torch

    torch.set_num_threads(1)
    return fn(*args)


@pytest.fixture(scope="module")
def runs(gang, problem):
    _, state, ids = problem
    out = {}
    for layout in cs.LAYOUTS:
        got = gang.run(_one_thread, cs.layout_rank, layout, state, ids,
                       "cpu", timeout=T)
        # DDP leaves every rank the same averaged gradients.
        for k, g in got[0]["grads"].items():
            torch.testing.assert_close(got[1]["grads"][k], g, rtol=0,
                                       atol=0)
        assert got[0]["loss"] == got[1]["loss"]
        out[layout] = got[0]
    return out


@pytest.mark.parametrize("layout", cs.LAYOUTS)
def test_layout_matches_one_rank(runs, problem, layout):
    """chip_smoke's gate for one layout: the loss within 1e-5 and every
    gradient within 1e-4 of one rank's step (``layout_reference``)."""
    _, state, ids = problem
    ref = cs.layout_reference(state, ids, "cpu", WORLD)
    numbers = cs.check_layouts({layout: runs[layout]}, ref)
    assert numbers[f"{layout}_loss_gap"] <= cs.LAYOUT_LOSS_ATOL
    assert numbers[f"{layout}_grad_rel"] <= cs.LAYOUT_GRAD_REL


def test_layouts_against_jax_dryrun(runs, problem):
    """JAX's layouts on the same weights and ids: data and sequence equal
    the port's within 1e-5; all six losses within the dryrun's 5e-2; the
    port's expert layout is not JAX's (per-shard against global capacity)
    but within that spread, and equal to one rank's per-shard step."""
    params, state, ids = problem
    jax_losses = {k: _jax_layout_loss(k, params, ids) for k in cs.LAYOUTS}
    for layout in ("data", "sequence"):
        assert abs(runs[layout]["loss"] - jax_losses[layout]) <= \
            cs.LAYOUT_LOSS_ATOL, (layout, runs[layout]["loss"], jax_losses)
    losses = [r["loss"] for r in runs.values()] + list(jax_losses.values())
    assert max(losses) - min(losses) <= cs.LAYOUT_SPREAD, (runs, jax_losses)
    ref = cs.layout_reference(state, ids, "cpu", WORLD)
    assert abs(jax_losses["expert"] - ref["plain"]["loss"]) <= \
        cs.LAYOUT_LOSS_ATOL
    cs.check_layouts({k: runs[k] for k in cs.LAYOUTS}, ref)


def test_sequence_attention_checks_over_two_ranks(gang):
    """chip_smoke's ring and Ulysses checks (the JAX tests' shapes) over
    two gloo ranks: every excess within its tolerance on both ranks."""
    for checks in gang.run(_one_thread, cs.sequence_attention_checks,
                           "cpu", timeout=T):
        assert len(checks) == 8
        for key, excess in checks.items():
            assert excess <= cs.SEQ_ATTN_TOL[key.rsplit(" ", 1)[1]], key
