"""The port's Llama against the JAX package's, on converted weights.

The flax model is initialised from a seed, its params are converted with
``llama_params_from_jax`` (numpy in, state_dict out), and the same token
ids (numpy, from a seed) go through ``ray_tpu.models.llama`` and the
port's ``Llama`` on the CPU: the config, rope, RMSNorm, full-context
and decode logits, the loss and its gradients, and AdamW steps against
``optax.adamw``."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from ray_tpu.models import llama as jllama
from ray_tpu_torch.models import Llama, LlamaConfig, llama_loss_fn
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models.convert import llama_params_from_jax
from ray_tpu_torch.ops import attention as tattn
from ray_tpu_torch.train import adamw, make_train_step

# fp32: the same math in other summation orders.  The tiny model's
# logits reach ~3.4 (an untied head over an RMS-normalised state), and a
# logit's rounding error scales with the terms of its sums, not with its
# own size: 1e-5 relative, plus 1e-6 of the largest |logit| (measured
# apart by <= 7e-7 of it).
RTOL, ATOL_OF_SCALE = 1e-5, 1e-6
# One bf16 ulp of a value in [2^k, 2^(k+1)) is 2^(k-7) <= 2^-7 of it.
BF16_ULP = 2.0 ** -7
# bf16 logits against JAX's: the port rounds at the reference's points
# (attention and the norms come out bitwise equal), but XLA's bf16
# logistic differs from torch.sigmoid by an ulp in about a third of its
# elements, and those flips pass through the MLP, the residual and the
# head's 64-term sums: measured <= 1.3% of the logit scale over three
# seeds.  The bound is tests/test_torch_gpt2.py's, 2% of the scale.
BF16_LOGITS_REL = 0.02
# Five AdamW steps: the bounds of tests/test_torch_train.py (an element
# whose gradient is rounding noise moves by up to ~lr a step in either
# package; every other element takes the same update to fp32 rounding).
LR, STEPS = 3e-4, 5
PARAM_ATOL = 2 * 1.02 * LR * STEPS
PARAM_CLOSE_ATOL, PARAM_CLOSE_FRACTION = 1e-6, 0.99


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: under the suite's parallel workers extra
    threads only contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(dtype_j=jnp.float32, dtype_t=torch.float32, seed=0, **kw):
    jmodel = jllama.Llama(jllama.LlamaConfig.tiny(dtype=dtype_j, **kw))
    params = jmodel.init(jax.random.PRNGKey(seed),
                         jnp.zeros((1, 8), jnp.int32))["params"]
    tmodel = Llama(LlamaConfig.tiny(dtype=dtype_t, **kw))
    tmodel.load_state_dict(llama_params_from_jax(_numpy(params)),
                           strict=True)
    return jmodel, params, tmodel.eval()


@pytest.fixture(scope="module")
def fp32_pair():
    return _pair()


def _ids(seed, b, length, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (b, length))


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if f.name != "dtype"}


@pytest.mark.parametrize("make", ["tiny", "llama_1b", "draft_of",
                                  "draft_of_1b"])
def test_config_fields_and_properties_equal_jax(make):
    """Every field (the dtype aside: jnp in one, torch in the other) and
    every derived size, llama_head_cost included."""
    build = {
        "tiny": lambda m: m.LlamaConfig.tiny(),
        "llama_1b": lambda m: m.LlamaConfig.llama_1b(),
        "draft_of": lambda m: m.LlamaConfig.draft_of(m.LlamaConfig.tiny()),
        "draft_of_1b": lambda m: m.LlamaConfig.draft_of(
            m.LlamaConfig.llama_1b(), num_layers=2),
    }[make]
    got, want = build(tllama), build(jllama)
    assert _fields(got) == _fields(want)
    for prop in ("block_params", "n_params", "head_dim", "mlp_dim"):
        assert getattr(got, prop) == getattr(want, prop), prop
    assert tllama.llama_head_cost(got) == jllama.llama_head_cost(want)
    assert got.dtype == torch.bfloat16


def test_llama_1b_is_the_tinyllama_shape():
    cfg = LlamaConfig.llama_1b()
    assert (cfg.num_layers, cfg.hidden_size, cfg.num_heads,
            cfg.num_kv_heads, cfg.mlp_dim, cfg.vocab_size,
            cfg.max_position_embeddings, cfg.head_dim) == (
        22, 2048, 32, 4, 5632, 32000, 2048, 64)
    assert cfg.n_params == 1_100_048_384
    # The default SwiGLU width rounds 8/3 * h up to a multiple of 32.
    assert LlamaConfig(hidden_size=100).mlp_dim == 288


@pytest.mark.parametrize("length,head_dim,theta", [(64, 16, 1e4),
                                                   (2048, 64, 1e4),
                                                   (32, 8, 5e5)])
def test_rope_tables_match_jax(length, head_dim, theta):
    want = jllama.rope_tables(length, head_dim, theta)
    got = tllama.rope_tables(length, head_dim, theta)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6 if length <= 64 else 2e-4)


@pytest.mark.parametrize("form", ["full_context", "decode"])
def test_apply_rope_matches_jax_and_rotates_halves(form):
    """Both table forms: [L, D/2] from position 0 and [B, L, D/2] at each
    token's absolute position; the rotation pairs channel j with j + D/2
    (rotate-half), not 2j with 2j + 1."""
    rng = np.random.default_rng(1)
    b, length, h, d = 2, 5, 3, 16
    x = rng.standard_normal((b, length, h, d)).astype(np.float32)
    cos, sin = (np.array(t) for t in jllama.rope_tables(64, d, 1e4))
    if form == "decode":
        pos = rng.integers(0, 64, (b, length))
        cos, sin = cos[pos], sin[pos]
    else:
        cos, sin = cos[:length], sin[:length]
    want = np.asarray(jllama.apply_rope(jnp.asarray(x), jnp.asarray(cos),
                                        jnp.asarray(sin)))
    got = tllama.apply_rope(torch.from_numpy(x), torch.from_numpy(cos),
                            torch.from_numpy(sin)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # Rotate-half by hand, for the first pair of channels.
    c, s = (cos[None, :, 0] if form == "full_context" else cos[:, :, 0],
            sin[None, :, 0] if form == "full_context" else sin[:, :, 0])
    x1, x2 = x[..., 0], x[..., d // 2]
    np.testing.assert_allclose(got[..., 0], x1 * c[..., None]
                               - x2 * s[..., None], atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_jax_with_its_rounding_points(dtype):
    """fp32 to 1e-6.  In bf16 the variance is fp32, the rsqrt is cast to
    bf16 before the multiply, the scale is cast to bf16: the port rounds
    at those points, so all but rounding-boundary cases are bitwise
    equal, and a norm computed in fp32 throughout is not."""
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((4, 7, 256)) * 3).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(256)).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    want = np.asarray(jllama.RMSNorm(1e-5, jdt).apply(
        {"params": {"scale": jnp.asarray(scale)}}, jnp.asarray(x, jdt)),
        np.float32)
    norm = tllama.RMSNorm(256, 1e-5)
    norm.weight.data = torch.from_numpy(scale)
    xt = torch.from_numpy(x).to(tdt)
    with torch.no_grad():
        got = norm(xt)
    assert got.dtype == tdt
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        return
    assert (got == want).mean() >= 0.99
    np.testing.assert_allclose(got, want, rtol=BF16_ULP, atol=0)
    x32 = xt.float()
    with torch.no_grad():
        fp32_norm = (x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True)
                                       + 1e-5) * norm.weight).to(tdt)
    assert (fp32_norm.float().numpy() == want).mean() < 0.9


def test_full_context_logits_match_with_gqa(fp32_pair):
    """4 query heads over 2 K/V heads (the tiny preset)."""
    jmodel, params, tmodel = fp32_pair
    assert tmodel.config.num_heads == 2 * tmodel.config.num_kv_heads
    ids = _ids(1, 2, 24)
    want = np.asarray(jmodel.apply({"params": params},
                                   jnp.asarray(ids, jnp.int32)))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(ids)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape == (2, 24,
                                                                   256)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL_OF_SCALE * np.abs(want).max())


@pytest.mark.parametrize("expand", ["interleaved", "tiled"])
def test_gqa_expand_order(fp32_pair, monkeypatch, expand):
    """Query head i reads K/V head i // rep (jnp.repeat on the head axis).
    A tiled expand (head i reading i % num_kv_heads) gives the same shapes
    and logits that the JAX package's do not match: the ``tiled`` case
    swaps it in and shows the test above would fail on it."""
    jmodel, params, tmodel = fp32_pair
    if expand == "tiled":
        def tiled(self, rep, dim):
            reps = [1] * self.dim()
            reps[dim] = rep
            return self.repeat(*reps)

        monkeypatch.setattr(torch.Tensor, "repeat_interleave", tiled)
    ids = _ids(2, 2, 16)
    want = np.asarray(jmodel.apply({"params": params},
                                   jnp.asarray(ids, jnp.int32)))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(ids)).numpy()
    close = np.allclose(got, want, rtol=RTOL,
                               atol=ATOL_OF_SCALE * np.abs(want).max())
    assert close == (expand == "interleaved")


@pytest.mark.parametrize("use_flash", [True, False])
def test_use_flash_keeps_the_logits(use_flash, monkeypatch):
    """``use_flash`` has the JAX package's meaning: True sends attention
    to ``flash_attention`` (its plain version on CPU tensors), False to
    the plain path; both give JAX's logits."""
    jmodel, params, tmodel = _pair(use_flash=use_flash)
    calls = []
    real = tattn.flash_attention
    monkeypatch.setattr(tattn, "flash_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    ids = _ids(3, 1, 64)
    want = np.asarray(jmodel.apply({"params": params},
                                   jnp.asarray(ids, jnp.int32)))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL_OF_SCALE * np.abs(want).max())
    assert len(calls) == (tmodel.config.num_layers if use_flash else 0)


def test_bf16_logits_within_one_ulp_of_the_logit_scale():
    """bf16 compute over fp32 params in both: the logits agree to
    BF16_LOGITS_REL of their scale (about two bf16 ulps of it)."""
    jmodel, params, tmodel = _pair(jnp.bfloat16, torch.bfloat16)
    ids = _ids(4, 2, 16)
    want = np.asarray(jmodel.apply({"params": params},
                                   jnp.asarray(ids, jnp.int32)))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(ids)).numpy()
    assert got.dtype == np.float32
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= BF16_LOGITS_REL * scale


def test_decode_path_logits_and_new_kv_match(fp32_pair):
    """The kv_caches path: padded per-layer caches at num_kv_heads,
    per-row valid lengths, rope at absolute positions; the logits and
    this step's post-rope (k, v) at num_kv_heads match."""
    jmodel, params, tmodel = fp32_pair
    c = tmodel.config
    b, t, s = 2, 3, 10
    rng = np.random.default_rng(5)
    ids = _ids(6, b, t)
    lengths = np.array([4, 10], np.int32)
    positions = lengths[:, None] + np.arange(t)[None]
    caches = [tuple(rng.standard_normal((b, s, c.num_kv_heads, c.head_dim))
                    .astype(np.float32) for _ in range(2))
              for _ in range(c.num_layers)]
    want, want_kv = jmodel.apply(
        {"params": params}, jnp.asarray(ids, jnp.int32),
        jnp.asarray(positions), [tuple(map(jnp.asarray, kv)) for kv in caches],
        jnp.asarray(lengths))
    with torch.no_grad():
        got, got_kv = tmodel(
            torch.from_numpy(ids), torch.from_numpy(positions).long(),
            [tuple(map(torch.from_numpy, kv)) for kv in caches],
            torch.from_numpy(lengths).long())
    for g, w in [(got, want)] + [pair for kvs in zip(got_kv, want_kv)
                                 for pair in zip(*kvs)]:
        w = np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL,
                                   atol=ATOL_OF_SCALE * np.abs(w).max())
    assert got_kv[0][0].shape == (b, t, c.num_kv_heads, c.head_dim)


def test_loss_and_every_gradient_match_jax(fp32_pair):
    """llama_loss_fn == JAX's, and every parameter's gradient == jax.grad
    of JAX's (converted by llama_params_from_jax): the K/V projections'
    gradients sum over each group of query heads through the expand."""
    jmodel, params, _ = fp32_pair
    _, _, tmodel = _pair()
    ids = _ids(7, 4, 32)
    loss_j, grads_j = jax.value_and_grad(jllama.llama_loss_fn)(
        params, jmodel.apply, {"input_ids": jnp.asarray(ids)})
    loss_t = llama_loss_fn(tmodel, {"input_ids": torch.from_numpy(ids)})
    assert loss_t.dim() == 0
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-5)
    loss_t.backward()
    want = llama_params_from_jax(_numpy(grads_j))
    got = dict(tmodel.named_parameters())
    assert set(got) == set(want)
    for name, p in got.items():
        scale = want[name].abs().max().item()
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=1e-5, atol=1e-5 * scale,
                                   err_msg=name)


def test_five_adamw_steps_match_optax():
    """make_train_step(adamw(3e-4)) against optax.adamw(3e-4) driven by
    jax.value_and_grad on the same ids every step: the losses, and the
    final parameters within tests/test_torch_train.py's bounds."""
    jmodel, params, tmodel = _pair()
    ids = _ids(8, 4, 32)
    tx = optax.adamw(LR)
    opt_state = tx.init(params)

    @jax.jit
    def jax_step(params, opt_state, ids):
        loss, grads = jax.value_and_grad(jllama.llama_loss_fn)(
            params, jmodel.apply, {"input_ids": ids})
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    step = make_train_step(tmodel, adamw(tmodel.parameters(), LR),
                           llama_loss_fn)
    batch = {"input_ids": torch.from_numpy(ids)}
    losses_j, losses_t = [], []
    for _ in range(STEPS):
        params, opt_state, loss = jax_step(params, opt_state,
                                           jnp.asarray(ids))
        losses_j.append(float(loss))
        losses_t.append(step(batch).item())
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-5)
    assert losses_t[-1] < losses_t[0]
    want = llama_params_from_jax(_numpy(params))
    diffs = []
    for name, p in tmodel.named_parameters():
        diff = (p.detach() - want[name]).abs()
        assert diff.max().item() <= PARAM_ATOL, name
        diffs.append(diff.flatten())
    close = (torch.cat(diffs) <= PARAM_CLOSE_ATOL).float().mean().item()
    assert close >= PARAM_CLOSE_FRACTION, close


def test_converter_covers_every_parameter_and_refuses_unknown_names(
        fp32_pair):
    """Every flax leaf becomes exactly one port parameter (the strict load
    above), Dense kernels transposed; an unknown name raises KeyError."""
    _, params, tmodel = fp32_pair
    flat = {"/".join(str(getattr(p, "key", p)) for p in path): np.asarray(x)
            for path, x in jax.tree_util.tree_flatten_with_path(params)[0]}
    sd = tmodel.state_dict()
    assert len(flat) == len(sd)
    for name, value in flat.items():
        parts = name.split("/")
        if parts[0].startswith("layer_"):
            parts = ["layers", parts[0][6:], *parts[1:]]
        if parts[-1] == "embedding":
            key, want = "embed", value
        else:
            key = ".".join(parts[:-1] + ["weight"])
            want = value.T if parts[-1] == "kernel" else value
        assert torch.equal(sd[key], torch.from_numpy(np.array(want))), name
    tree = _numpy(params)
    for bad in ({"wte": np.zeros((2, 2))},
                {"layer_0": {"attn": {"qkv_proj": {"kernel":
                                                   np.zeros((2, 2))}}}},
                {"layer_0": {"attn": {"q_proj": {"kernel": np.zeros((2, 2)),
                                                 "bias": np.zeros(2)}}}},
                {"layer_0": {"ln_1": {"scale": np.zeros(2)}}},
                {"final_norm": {"scale": np.zeros(2), "bias": np.zeros(2)}},
                {**tree, "lm_head": {"bias": np.zeros(2)}}):
        with pytest.raises(KeyError):
            llama_params_from_jax(bad)


def test_rope_makes_the_same_token_read_differently_by_position(fp32_pair):
    """test_models_ops.py:138's rope check on the port: one token at two
    positions of a zero sequence gives different logits."""
    _, _, tmodel = fp32_pair
    seq = torch.zeros((1, 8), dtype=torch.long)
    seq[0, 4] = 7
    with torch.no_grad():
        out = tmodel(seq)
    assert not torch.allclose(out[0, 3], out[0, 5], atol=1e-5)
