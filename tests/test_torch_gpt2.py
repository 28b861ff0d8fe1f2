"""The port's GPT-2 against the JAX package's, on converted weights.

The flax model is initialised from a seed, its params are converted with
``gpt2_params_from_jax`` (numpy in, state_dict out), and the same token
ids go through ``ray_tpu.models.GPT2.apply`` and the port's ``GPT2`` on
the CPU."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.models import GPT2 as JGPT2
from ray_tpu.models import GPT2Config as JConfig
from ray_tpu.ops import layers as jlayers
from ray_tpu_torch.models import GPT2, GPT2Config
from ray_tpu_torch.models.convert import gpt2_params_from_jax
from ray_tpu_torch.ops import layers as tlayers

# fp32: two implementations of the same fp32 math differ in summation
# order only; logits are O(0.1-1), so 1e-5 relative (+1e-6 absolute for
# logits near 0) holds with margin.
RTOL, ATOL = 1e-5, 1e-6


def _pair(dtype_j, dtype_t, seed=0):
    cfg = JConfig.tiny(dtype=dtype_j)
    jmodel = JGPT2(cfg)
    params = jmodel.init(jax.random.PRNGKey(seed),
                         jnp.zeros((1, 8), jnp.int32))["params"]
    tmodel = GPT2(GPT2Config.tiny(dtype=dtype_t))
    tmodel.load_state_dict(gpt2_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)), strict=True)
    return jmodel, params, tmodel.eval()


@pytest.fixture(scope="module")
def fp32_pair():
    return _pair(jnp.float32, torch.float32)


def _ids(seed, b, l, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (b, l))


def test_layers_match_jax():
    """gelu is the tanh approximation; layer_norm computes in fp32 and
    casts back to the input dtype (exact cast for fp32 in, one bf16
    rounding of the same fp32 value for bf16 in)."""
    rng = np.random.default_rng(5)
    x, scale, bias = (rng.standard_normal(s).astype(np.float32)
                      for s in ((4, 32), (32,), (32,)))
    np.testing.assert_allclose(
        tlayers.gelu(torch.from_numpy(x)).numpy(),
        np.asarray(jlayers.gelu(jnp.asarray(x))), rtol=RTOL, atol=ATOL)
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        want = jlayers.layer_norm(jnp.asarray(x, jdt), jnp.asarray(scale),
                                  jnp.asarray(bias))
        got = tlayers.layer_norm(torch.from_numpy(x).to(tdt),
                                 torch.from_numpy(scale),
                                 torch.from_numpy(bias))
        assert got.dtype == tdt
        np.testing.assert_allclose(
            got.float().numpy(), np.asarray(want, np.float32),
            rtol=RTOL if tdt == torch.float32 else 2 ** -8, atol=ATOL)


def test_full_context_logits_match(fp32_pair):
    jmodel, params, tmodel = fp32_pair
    ids = _ids(1, 2, 24)
    want = np.asarray(jmodel.apply({"params": params},
                                   jnp.asarray(ids, jnp.int32)))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(ids)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_decode_path_logits_and_new_kv_match(fp32_pair):
    """The kv_caches path: padded per-layer caches, per-row valid
    lengths, absolute positions into wpe; logits and this step's (k, v)
    projections match."""
    jmodel, params, tmodel = fp32_pair
    c = tmodel.config
    b, t, s = 2, 3, 10
    rng = np.random.default_rng(2)
    ids = _ids(3, b, t)
    lengths = np.array([4, 10], np.int32)
    positions = lengths[:, None] + np.arange(t)[None]
    caches = [tuple(rng.standard_normal((b, s, c.num_heads, c.head_dim))
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
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    for (gk, gv), (wk, wv) in zip(got_kv, want_kv):
        np.testing.assert_allclose(gk.numpy(), np.asarray(wk), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(gv.numpy(), np.asarray(wv), rtol=RTOL,
                                   atol=ATOL)


def test_bf16_logits_match_within_bf16_rounding():
    """bf16 compute over fp32 params in both: the frameworks round to
    bf16 at different points (bias adds, GELU), so logits agree to a few
    bf16 ulps (2^-8 relative) of their O(1) scale, not bitwise."""
    jmodel, params, tmodel = _pair(jnp.bfloat16, torch.bfloat16)
    ids = _ids(4, 2, 16)
    want = np.asarray(jmodel.apply({"params": params},
                                   jnp.asarray(ids, jnp.int32)))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(ids)).numpy()
    assert got.dtype == np.float32
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 0.02 * scale


def test_converter_covers_every_parameter(fp32_pair):
    """Round trip of names: every flax leaf becomes exactly one port
    parameter (strict load above), Dense kernels transposed, and an
    unknown name is refused."""
    jmodel, params, tmodel = fp32_pair
    flat = {"/".join(str(getattr(p, "key", p)) for p in path): np.asarray(x)
            for path, x in jax.tree_util.tree_flatten_with_path(params)[0]}
    sd = tmodel.state_dict()
    assert len(flat) == len(sd)
    for name, value in flat.items():
        parts = name.split("/")
        if parts[0].startswith("h_"):
            parts = ["h", parts[0][2:], *parts[1:]]
        leaf = {"scale": "weight", "kernel": "weight"}.get(parts[-1],
                                                           parts[-1])
        key = ".".join(parts[:-1] + [leaf]) if len(parts) > 1 else parts[0]
        want = value.T if parts[-1] == "kernel" else value
        assert torch.equal(sd[key], torch.from_numpy(np.array(
            want))), name
    with pytest.raises(KeyError):
        gpt2_params_from_jax({"lm_head": {"kernel": np.zeros((2, 2))}})
