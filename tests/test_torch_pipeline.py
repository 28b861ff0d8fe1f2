"""The port's pipeline pieces against the JAX package's on the same
numpy-seeded inputs and converted weights: the GPipe schedule over a
``pipe`` axis (``parallel/pipeline.py``; ``tests/test_models_ops.py``'s
two pipeline scenarios, here over 2 gloo ranks of one ``MeshGroup``),
the cost-balanced split (``models/pipeline_split.py``), the stage chunks
``GPT2Stage``/``LlamaStage`` and every ``split_stages`` chunk's forward
and loss, the remat layer stack (``scan_layers_threshold``) on an
``h_scan`` tree through the converter against the JAX model, and
``AsyncMetrics``.

Tolerances: fp32 outputs, losses and gradients at 1e-5 (``atol`` and
``rtol``), the pipeline's output at ``test_models_ops.py``'s 1e-5.  Torch
runs on one thread; rank functions ship by value."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

T = 120  # seconds: the bound of every gang call
TOL = 1e-5


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
def gang():
    """A 2-rank gloo gang on one port cluster."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.parallel import MeshGroup

    rt.init(num_cpus=4, num_gpus=0, object_store_memory=256 * 1024**2)
    group = None
    try:
        group = MeshGroup(2, bootstrap_timeout=T)
        yield group
    finally:
        if group is not None:
            group.shutdown()
        rt.shutdown()


def _close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=what)


# ---------------------------------------------------------------------------
# the GPipe schedule over a pipe axis
# ---------------------------------------------------------------------------
def _jax_stages(n, d, bias=True, seed=0):
    key = jax.random.PRNGKey(seed)
    stages = []
    for _ in range(n):
        k1, k2, key = jax.random.split(key, 3)
        p = {"w": np.asarray(jax.random.normal(k1, (d, d)) * 0.5)}
        if bias:
            p["b"] = np.asarray(jax.random.normal(k2, (d,)) * 0.1)
        stages.append(p)
    return stages, np.asarray(jax.random.normal(key, (8, d)))


def _pipe_rank(stages, x, n_micro, with_bias, remat):
    """In each gang rank: the pipeline's output over the ``pipe`` axis and
    the gradient of sum(out^2) for this rank's stage."""
    import torch

    from ray_tpu_torch.parallel import MeshSpec, make_mesh
    from ray_tpu_torch.parallel.pipeline import (microbatch, pipeline_apply,
                                                 stack_stage_params)

    torch.set_num_threads(1)

    def stage_fn(params, h):
        out = h @ params["w"]
        return torch.tanh(out + params["b"] if with_bias else out)

    mesh = make_mesh(MeshSpec({"pipe": -1}))
    stacked = stack_stage_params([{k: torch.tensor(v) for k, v in s.items()}
                                  for s in stages])
    for v in stacked.values():
        v.requires_grad_(True)
    out = pipeline_apply(stage_fn, stacked, microbatch(torch.tensor(x),
                                                       n_micro),
                         mesh, remat=remat)
    (out ** 2).sum().backward()
    i = mesh.coords["pipe"]
    return {"out": out.detach().numpy(), "stage": i,
            "grads": {k: v.grad[i].numpy() for k, v in stacked.items()},
            "other": {k: float(v.grad[1 - i].abs().sum())
                      for k, v in stacked.items()}}


@pytest.mark.parametrize("remat", [True, False])
def test_pipeline_matches_sequential(gang, remat):
    """``test_models_ops.py::test_pipeline_matches_sequential`` at 2
    stages: the port's pipeline over 2 ranks equals JAX's
    ``pipeline_apply`` over a pipe=2 mesh and the stages applied in
    sequence; each rank's stage gradient equals JAX's sequential one."""
    from ray_tpu.parallel import MeshSpec, make_mesh
    from ray_tpu.parallel.pipeline import (microbatch, pipeline_apply,
                                           stack_stage_params)

    d = 16
    stages, x = _jax_stages(2, d)

    def stage_fn(params, h):
        return jnp.tanh(h @ params["w"] + params["b"])

    mesh = make_mesh(MeshSpec({"pipe": 2, "data": 4}))
    stacked = stack_stage_params([jax.tree_util.tree_map(jnp.asarray, s)
                                  for s in stages])
    want = np.asarray(jax.jit(lambda s, xm: pipeline_apply(
        stage_fn, s, xm, mesh))(stacked, microbatch(jnp.asarray(x), 4)))

    def seq_loss(ps):
        h = jnp.asarray(x)
        for p in ps:
            h = stage_fn(p, h)
        return jnp.sum(h ** 2), h

    (_, seq), grads = jax.value_and_grad(seq_loss, has_aux=True)(
        [jax.tree_util.tree_map(jnp.asarray, s) for s in stages])
    _close(want.reshape(8, d), seq, what="jax pipeline vs sequential")

    got = gang.run(_pipe_rank, stages, x, 4, True, remat, timeout=T)
    for r in got:
        _close(r["out"], want, what=f"rank {r['stage']} output")
        for k in ("w", "b"):
            _close(r["grads"][k], grads[r["stage"]][k],
                   what=f"rank {r['stage']} d{k}")
            assert r["other"][k] == 0.0  # a rank holds its stage's grad


def test_pipeline_grads_flow(gang):
    """``test_models_ops.py::test_pipeline_grads_flow`` at 2 stages:
    gradients through the shifts are finite and nonzero on every rank."""
    d = 8
    stages = [{"w": np.eye(d, dtype=np.float32) * 0.9} for _ in range(2)]
    x = np.ones((4, d), np.float32)
    got = gang.run(_pipe_rank, stages, x, 2, False, True, timeout=T)
    for r in got:
        g = r["grads"]["w"]
        assert np.all(np.isfinite(g)) and float(np.abs(g).sum()) > 0


def test_pipeline_without_pipe_axis_runs_stages_in_sequence():
    """No ``pipe`` axis: the stages run one after another on each
    microbatch, as JAX's fallback (``vmap`` over the microbatches)."""
    from ray_tpu.parallel.pipeline import pipeline_apply as j_apply
    from ray_tpu.parallel.pipeline import stack_stage_params as j_stack
    from ray_tpu_torch.parallel.pipeline import (microbatch, pipeline_apply,
                                                 stack_stage_params)

    stages, x = _jax_stages(3, 8, seed=1)

    class NoPipe:
        axis_names = ("data",)
        shape = {"data": 1}

    want = j_apply(lambda p, h: jnp.tanh(h @ p["w"] + p["b"]),
                   j_stack([jax.tree_util.tree_map(jnp.asarray, s)
                            for s in stages]),
                   jnp.asarray(x).reshape(2, 4, 8), NoPipe())
    got = pipeline_apply(lambda p, h: torch.tanh(h @ p["w"] + p["b"]),
                         stack_stage_params([{k: torch.tensor(v) for k, v in
                                              s.items()} for s in stages]),
                         microbatch(torch.tensor(x), 2))
    _close(got, want)
    with pytest.raises(ValueError, match="divisible"):
        microbatch(torch.zeros(5, 2), 2)


# ---------------------------------------------------------------------------
# the split and the stage chunks
# ---------------------------------------------------------------------------
def test_balance_chunks_equal_the_jax_package():
    from ray_tpu.models.pipeline_split import balance_chunks as j_balance
    from ray_tpu.models.pipeline_split import chunk_flags as j_flags
    from ray_tpu_torch.models.pipeline_split import (balance_chunks,
                                                     chunk_flags)

    for blocks in (1, 2, 4, 12, 22, 48):
        for n in range(1, blocks + 3):
            for embed, head in ((0.3, 0.0), (0.3, 5.45), (0.0, 2.0),
                                (0.3, 1.43)):
                assert balance_chunks(blocks, n, embed_cost=embed,
                                      head_cost=head) == \
                    j_balance(blocks, n, embed_cost=embed, head_cost=head)
            assert chunk_flags(n) == j_flags(n)
    for bad in ((2, 0), (2, 5)):
        with pytest.raises(ValueError):
            balance_chunks(*bad, embed_cost=0.3, head_cost=1.0)


def _chunks_against_jax(kind, S, v, ids):
    """Every chunk of the port's split on the JAX chunks' converted
    weights against the JAX chunk: hidden states, then the loss."""
    import ray_tpu.models.gpt2 as jg
    import ray_tpu.models.llama as jl
    from ray_tpu_torch.models import convert, gpt2, llama

    if kind == "gpt2":
        jcfg = jg.GPT2Config.tiny(dtype=jnp.float32, num_layers=3)
        cfg = gpt2.GPT2Config.tiny(dtype=torch.float32, num_layers=3)
        jmod, mod, conv = jg, gpt2, convert.gpt2_params_from_jax
    else:
        jcfg = jl.LlamaConfig.tiny(dtype=jnp.float32, num_layers=3)
        cfg = llama.LlamaConfig.tiny(dtype=torch.float32, num_layers=3)
        jmod, mod, conv = jl, llama, convert.llama_params_from_jax
    jfns, jinits = jmod.split_stages(jcfg, S, virtual_per_rank=v, seed=3)
    fns, inits = mod.split_stages(cfg, S, virtual_per_rank=v, seed=3)
    jparams = [jax.tree_util.tree_map(np.asarray, f()) for f in jinits]
    h, jh = torch.from_numpy(ids).long(), jnp.asarray(ids)
    for c in range(S * v):
        params = conv(jparams[c])
        own = inits[c]()
        assert sorted(own) == sorted(params), c   # the same names
        for k in own:
            assert own[k].shape == params[k].shape, (c, k)
        if c < S * v - 1:
            h, jh = fns[c](params, h), jfns[c](jparams[c], jh)
            assert h.dtype == torch.float32
            _close(h.detach(), jh, what=f"{kind} chunk {c}")
        else:
            loss = fns[c](params, h, torch.from_numpy(ids).long())
            jloss = jfns[c](jparams[c], jh, jnp.asarray(ids))
            _close(float(loss), float(jloss), what=f"{kind} loss")


@pytest.mark.parametrize("kind", ["gpt2", "llama"])
@pytest.mark.parametrize("S,v", [(1, 1), (2, 1), (3, 1), (2, 2)])
def test_split_stage_chunks_match_jax(kind, S, v):
    ids = np.random.default_rng(S * 10 + v).integers(
        0, 256, (2, 16)).astype(np.int32)
    _chunks_against_jax(kind, S, v, ids)


def test_gpt2_stage_module_matches_jax_stage():
    """``GPT2Stage`` with the whole model in one chunk (embedding, every
    block, the untied head) against the JAX module's logits."""
    from ray_tpu.models.gpt2 import GPT2Config as JConfig
    from ray_tpu.models.gpt2 import GPT2Stage as JStage
    from ray_tpu_torch.models import GPT2Config, GPT2Stage
    from ray_tpu_torch.models.convert import gpt2_params_from_jax

    jm = JStage(JConfig.tiny(dtype=jnp.float32), first=True, last=True,
                blocks=(0, 2))
    ids = np.random.default_rng(0).integers(0, 512, (2, 12))
    jp = jm.init(jax.random.PRNGKey(0), jnp.asarray(ids))["params"]
    m = GPT2Stage(GPT2Config.tiny(dtype=torch.float32), True, True, (0, 2))
    m.load_state_dict(gpt2_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp)))
    _close(m(torch.from_numpy(ids)).detach(),
           jm.apply({"params": jp}, jnp.asarray(ids)))


def test_llama_stage_module_matches_jax_stage():
    from ray_tpu.models.llama import LlamaConfig as JConfig
    from ray_tpu.models.llama import LlamaStage as JStage
    from ray_tpu_torch.models import LlamaConfig, LlamaStage
    from ray_tpu_torch.models.convert import llama_params_from_jax

    jm = JStage(JConfig.tiny(dtype=jnp.float32), first=False, last=True,
                blocks=(1, 2))
    x = np.random.default_rng(1).normal(size=(2, 12, 64)).astype(np.float32)
    jp = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    m = LlamaStage(LlamaConfig.tiny(dtype=torch.float32), False, True,
                   (1, 2))
    m.load_state_dict(llama_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp)))
    _close(m(torch.from_numpy(x)).detach(),
           jm.apply({"params": jp}, jnp.asarray(x)))


def test_boundary_dtype_and_init_seeds():
    """Activations cross a boundary as ``boundary_dtype``; each chunk's
    init draws from its own generator (``seed + c``), so two calls agree
    and two chunks differ."""
    from ray_tpu_torch.models import GPT2Config, split_stages

    cfg = GPT2Config.tiny(dtype=torch.float32)
    fns, inits = split_stages(cfg, 2, boundary_dtype=torch.bfloat16, seed=5)
    ids = torch.zeros(1, 8, dtype=torch.long)
    a, b = inits[0](), inits[0]()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert fns[0](a, ids).dtype == torch.bfloat16
    other = split_stages(cfg, 2, seed=6)[1][0]()
    assert not torch.equal(other["wte"], a["wte"])


# ---------------------------------------------------------------------------
# the remat layer stack
# ---------------------------------------------------------------------------
def _stack_layers(tree, n, prefix="h_"):
    """The per-layer trees ``h_{i}`` stacked into flax's ``nn.scan``
    layout (``variable_axes={"params": 0}``): ``h_scan``, every leaf with
    a leading layer axis."""
    layers = [tree[f"{prefix}{i}"] for i in range(n)]
    out = {k: v for k, v in tree.items() if not k.startswith(prefix)}
    out["h_scan"] = jax.tree_util.tree_map(lambda *xs: np.stack(xs), *layers)
    return out


def _remat_pair():
    """A 2-layer JAX GPT-2 (unrolled) and the port's at
    ``scan_layers_threshold=2`` on the same weights, given to the port as
    the ``h_scan`` tree a JAX model of that depth holds.  The JAX
    package's own scan stack cannot run its forward (its ``nn.scan`` body
    returns one value where the scan wants a (carry, output) pair), so
    its unrolled model is the reference: ``nn.remat`` changes no math."""
    from ray_tpu.models.gpt2 import GPT2 as JGPT2
    from ray_tpu.models.gpt2 import GPT2Config as JConfig
    from ray_tpu_torch.models import GPT2, GPT2Config
    from ray_tpu_torch.models.convert import gpt2_params_from_jax

    ids = np.random.default_rng(4).integers(0, 512, (2, 16)).astype(np.int32)
    jm = JGPT2(JConfig.tiny(dtype=jnp.float32))
    jp = jm.init(jax.random.PRNGKey(4), jnp.asarray(ids))["params"]
    scan_tree = _stack_layers(jax.tree_util.tree_map(np.asarray, jp), 2)
    assert scan_tree["h_scan"]["attn_qkv"]["kernel"].shape == (2, 64, 192)
    model = GPT2(GPT2Config.tiny(dtype=torch.float32,
                                 scan_layers_threshold=2))
    model.load_state_dict(gpt2_params_from_jax(scan_tree))
    return jm, jp, scan_tree, model, ids


def test_remat_stack_forward_and_gradients_match_jax():
    """At ``scan_layers_threshold=2`` a 2-layer GPT-2 checkpoints every
    block; on the ``h_scan`` weights (unstacked by the converter) its
    logits, loss and gradients equal the JAX model's."""
    from ray_tpu.models.gpt2 import gpt2_loss_fn as j_loss
    from ray_tpu_torch.models import gpt2_loss_fn
    from ray_tpu_torch.models.convert import gpt2_params_from_jax

    jm, jp, _, model, ids = _remat_pair()
    _close(model(torch.from_numpy(ids)).detach(),
           jm.apply({"params": jp}, jnp.asarray(ids)), what="logits")
    jloss, jgrads = jax.value_and_grad(j_loss)(
        jp, jm.apply, {"input_ids": jnp.asarray(ids)})
    loss = gpt2_loss_fn(model, {"input_ids": torch.from_numpy(ids)})
    loss.backward()
    _close(float(loss), float(jloss), what="loss")
    want = gpt2_params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))
    got = dict(model.named_parameters())
    assert sorted(want) == sorted(got)
    for k, g in want.items():
        _close(got[k].grad, g, what=k)


def test_remat_checkpoints_each_block_and_keeps_the_module_list():
    """From the threshold the forward runs each block under
    ``torch.utils.checkpoint`` (the backward runs each block's forward
    again); below it, it does not.  The layers stay ``h.{i}``."""
    from ray_tpu_torch.models import GPT2, GPT2Config, gpt2_loss_fn

    calls = []
    for threshold in (2, 3):
        torch.manual_seed(0)
        model = GPT2(GPT2Config.tiny(dtype=torch.float32,
                                     scan_layers_threshold=threshold))
        with torch.no_grad():
            for p in model.parameters():
                p.normal_(0.0, 0.02)
        n = [0]
        for block in model.h:
            block.register_forward_pre_hook(
                lambda *_: n.__setitem__(0, n[0] + 1))
        ids = torch.randint(0, 512, (2, 8))
        gpt2_loss_fn(model, {"input_ids": ids}).backward()
        calls.append(n[0])
        assert isinstance(model.h, torch.nn.ModuleList)
    assert calls == [4, 2]


def test_decode_at_the_threshold_raises_as_in_jax():
    """Incremental decode on the remat stack raises, with the JAX
    package's message."""
    from ray_tpu_torch.models import GPT2, GPT2Config

    from ray_tpu.models.gpt2 import GPT2 as JGPT2
    from ray_tpu.models.gpt2 import GPT2Config as JConfig

    _, _, scan_tree, _, _ = _remat_pair()
    jm = JGPT2(JConfig.tiny(dtype=jnp.float32, scan_layers_threshold=2))
    jp = jax.tree_util.tree_map(jnp.asarray, scan_tree)
    jcaches = [(jnp.zeros((1, 8, 2, 32)), jnp.zeros((1, 8, 2, 32)))] * 2
    with pytest.raises(NotImplementedError) as jerr:
        jm.apply({"params": jp}, jnp.zeros((1, 1), jnp.int32),
                 positions=jnp.zeros((1, 1), jnp.int32), kv_caches=jcaches,
                 kv_lengths=jnp.zeros((1,), jnp.int32))
    model = GPT2(GPT2Config.tiny(dtype=torch.float32,
                                 scan_layers_threshold=2))
    caches = [(torch.zeros(1, 8, 2, 32), torch.zeros(1, 8, 2, 32))] * 2
    with pytest.raises(NotImplementedError) as err:
        model(torch.zeros(1, 1, dtype=torch.long),
              positions=torch.zeros(1, 1, dtype=torch.long),
              kv_caches=caches, kv_lengths=torch.zeros(1, dtype=torch.long))
    assert str(err.value) == str(jerr.value)


# ---------------------------------------------------------------------------
# AsyncMetrics and the optimizer factory
# ---------------------------------------------------------------------------
def test_async_metrics_matches_the_reference():
    """Over a run of pushes the port's ``AsyncMetrics`` returns, holds
    (``last``, ``last_step``) and flushes what the JAX package's does."""
    from ray_tpu.train.jax import AsyncMetrics as JMetrics
    from ray_tpu_torch.train.torch import AsyncMetrics

    rng = np.random.default_rng(0)
    jm, m = JMetrics(interval=3), AsyncMetrics(interval=3)
    assert m.flush() is None and jm.flush() is None
    for step in range(1, 11):
        vals = rng.normal(size=2).astype(np.float32)
        got = m.push(step, {"loss": torch.tensor(vals[0]),
                            "lr": torch.tensor(vals[1]), "step": step})
        want = jm.push(step, {"loss": jnp.asarray(vals[0]),
                              "lr": jnp.asarray(vals[1]), "step": step})
        assert got == want, step
        assert (m.last, m.last_step) == (jm.last, jm.last_step), step
    assert m.flush() == jm.flush()
    assert m.last_step == jm.last_step == 10
    assert m.flush() == jm.flush()  # nothing pending: the last copy


def test_optimizer_must_be_a_factory():
    """The optimizer is a factory over a chunk's tensors; an optax
    transformation (an object, not a factory) is refused."""
    import optax

    from ray_tpu_torch.parallel.mpmd_pipeline import StageCore

    def last(params, x, t):
        return ((x @ params["w"] - t) ** 2).mean()

    core = StageCore([last], [{"w": np.ones((3, 2), np.float32)}],
                     lambda ps: torch.optim.SGD(ps, lr=0.1), device="cpu")
    assert isinstance(core.opt_state[0], torch.optim.SGD)
    with pytest.raises(TypeError, match="factory"):
        StageCore([last], [{"w": np.ones((3, 2), np.float32)}],
                  optax.sgd(0.1), device="cpu")
