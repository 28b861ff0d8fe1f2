"""The port's serving engine on the Llama family against the JAX
package's, on converted fp32 weights of the tiny Llama (4 query heads over
2 K/V heads).

Greedy decode is held by token identity with the JAX ``LLMEngine`` and
``NaiveLM`` (test_serving.py:84's contract: rope at absolute positions
and pages kept at ``num_kv_heads`` must not perturb greedy decode);
sampled decode by the port's own plain stream.  Speculative decoding
with a ``draft_of`` draft, the prefix cache, ``swap_weights``,
``build_model("llama")``, ``cache_namespace_for`` and ``LLMServer`` are
held as their GPT-2 tests hold them."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.models import llama as jllama
from ray_tpu.serve import llm_engine as jengine
from ray_tpu_torch.models import Llama, LlamaConfig
from ray_tpu_torch.models.convert import llama_params_from_jax
from ray_tpu_torch.serve import (
    LLMEngine,
    LLMServer,
    NaiveLM,
    SamplingParams,
    build_model,
    cache_namespace_for,
)

SP = SamplingParams(temperature=0.8, top_p=0.9, seed=7)
VOCAB = 256
ENGINE = dict(max_slots=4, page_size=8, max_ctx=64)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: under the suite's parallel workers extra
    threads only contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _state(params):
    return llama_params_from_jax(jax.tree_util.tree_map(np.asarray, params))


def _port(cfg, params):
    m = Llama(cfg)
    m.load_state_dict(_state(params))
    return m.eval()


def _init(jmodel, seed):
    return jmodel.init(jax.random.PRNGKey(seed),
                       jnp.zeros((1, 8), jnp.int32))["params"]


@pytest.fixture(scope="module")
def models():
    """(JAX model, params, port model): the same tiny fp32 weights."""
    jmodel = jllama.Llama(jllama.LlamaConfig.tiny(dtype=jnp.float32))
    params = _init(jmodel, 0)
    return jmodel, params, _port(LlamaConfig.tiny(dtype=torch.float32),
                                 params)


@pytest.fixture(scope="module")
def draft(models):
    """The draft_of draft (1 layer, half width, 2 query heads over 1 K/V
    head) with its own init, in both packages."""
    jdcfg = jllama.LlamaConfig.draft_of(
        jllama.LlamaConfig.tiny(dtype=jnp.float32))
    jdraft = jllama.Llama(jdcfg)
    dparams = _init(jdraft, 1)
    dcfg = LlamaConfig.draft_of(LlamaConfig.tiny(dtype=torch.float32))
    assert (dcfg.num_layers, dcfg.num_heads, dcfg.num_kv_heads,
            dcfg.hidden_size) == (jdcfg.num_layers, jdcfg.num_heads,
                                  jdcfg.num_kv_heads, jdcfg.hidden_size)
    return jdraft, dparams, _port(dcfg, dparams)


def _prompts(sizes, seed=0):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(0, VOCAB, size=n))) for n in sizes]


def test_pages_hold_num_kv_heads(models):
    """The page arrays are [L, pages, page, num_kv_heads, D]: the GQA
    memory saving carries into the cache."""
    _, _, tmodel = models
    eng = LLMEngine(tmodel, device="cpu", start=False, **ENGINE)
    c = tmodel.config
    assert eng.kv_heads == c.num_kv_heads == 2
    assert eng._k_pages.shape[2:] == (8, c.num_kv_heads, c.head_dim)
    assert eng._v_pages.shape == eng._k_pages.shape


def test_greedy_tokens_identical_to_jax_engine_and_naive(models):
    """test_serving.py:84 on the port, with mixed prompt lengths."""
    jmodel, params, tmodel = models
    prompts = _prompts((6, 17, 25, 40), seed=3)
    eng = LLMEngine(tmodel, device="cpu", **ENGINE)
    jeng = jengine.LLMEngine(jmodel, params, **ENGINE)
    try:
        outs = [eng.result(eng.submit(p, max_new_tokens=8), timeout=120)
                for p in prompts]
        jouts = [jeng.result(jeng.submit(p, max_new_tokens=8), timeout=120)
                 for p in prompts]
        st = eng.stats()
    finally:
        eng.close()
        jeng.close()
    jnaive = jengine.NaiveLM(jmodel, params, width=64)
    assert outs == jouts
    assert outs == [jnaive.generate(p, 8) for p in prompts]
    assert st["completed"] == 4 and st["pages_in_use"] == 0


def test_mid_flight_admission_identical_to_jax(models):
    """A request submitted while another is mid-decode joins at a token
    boundary without perturbing either request's tokens."""
    jmodel, params, tmodel = models
    a, b = _prompts((7, 13), seed=7)
    eng = LLMEngine(tmodel, device="cpu", chunk_tokens=2, **ENGINE)
    try:
        rid_a = eng.submit(a, max_new_tokens=24)
        stream = eng.stream(rid_a, timeout=60)
        next(stream)  # a is provably mid-decode now
        out_b = eng.result(eng.submit(b, max_new_tokens=8), timeout=120)
        out_a = eng.result(rid_a, timeout=120)
        st = eng.stats()
    finally:
        eng.close()
    jnaive = jengine.NaiveLM(jmodel, params, width=64)
    assert out_a == jnaive.generate(a, 24)
    assert out_b == jnaive.generate(b, 8)
    assert st["admitted_mid_batch"] >= 1, st


def test_sampled_engine_equals_port_naive(models):
    """Seeded sampling is position-seeded: the batched, cached engine draws
    exactly the tokens of the port's full-context NaiveLM."""
    _, _, tmodel = models
    prompts = _prompts((5, 12, 20), seed=23)
    eng = LLMEngine(tmodel, device="cpu", **ENGINE)
    try:
        outs = [eng.result(eng.submit(p, 16, sampling=SP), timeout=120)
                for p in prompts]
    finally:
        eng.close()
    naive = NaiveLM(tmodel, width=64, device="cpu")
    assert outs == [naive.generate(p, 16, sampling=SP) for p in prompts]


def test_draft_of_spec_sampled_equals_plain_and_greedy_equals_jax(models,
                                                                  draft):
    """Speculative decoding with the draft_of draft, whose pages (1 K/V
    head) sit under the target's table: the sampled stream is the plain
    stream, greedy decode is the JAX engine's and NaiveLM's."""
    jmodel, params, tmodel = models
    jdraft, dparams, tdraft = draft
    prompts = _prompts((7, 19), seed=13)
    eng = LLMEngine(tmodel, device="cpu", draft_model=tdraft, spec_tokens=3,
                    **ENGINE)
    plain = LLMEngine(tmodel, device="cpu", **ENGINE)
    jeng = jengine.LLMEngine(jmodel, params, draft_model=jdraft,
                             draft_params=dparams, spec_tokens=3, **ENGINE)
    try:
        sampled = [eng.result(eng.submit(p, 12, sampling=SP), timeout=120)
                   for p in prompts]
        want = [plain.result(plain.submit(p, 12, sampling=SP), timeout=120)
                for p in prompts]
        greedy = [eng.result(eng.submit(p, 12), timeout=120)
                  for p in prompts]
        jgreedy = [jeng.result(jeng.submit(p, 12), timeout=120)
                   for p in prompts]
        st = eng.stats()
    finally:
        eng.close()
        plain.close()
        jeng.close()
    assert eng._dk_pages.shape[3] == tdraft.config.num_kv_heads == 1
    assert sampled == want
    assert greedy == jgreedy
    jnaive = jengine.NaiveLM(jmodel, params, width=64)
    assert greedy == [jnaive.generate(p, 12) for p in prompts]
    assert st["spec_proposed"] > 0 and st["pages_in_use"] == 0, st


def test_prefix_hit_equals_miss_identical_to_jax(models):
    """Two requests over a 24-token prefix: the second adopts three cached
    pages (K/V at num_kv_heads) and prefills only its tail; its tokens are
    the cache-off tokens and JAX's, and the cache's entries, bytes and hit
    counts are the JAX engine's."""
    jmodel, params, tmodel = models
    rng = np.random.default_rng(29)
    shared = list(map(int, rng.integers(0, VOCAB, size=24)))
    p1, p2 = shared + [3, 1], shared + [5, 9, 2]
    kw = dict(ENGINE, prefix_cache=True)
    eng = LLMEngine(tmodel, device="cpu", **kw)
    off = LLMEngine(tmodel, device="cpu", **ENGINE)
    jeng = jengine.LLMEngine(jmodel, params, **kw)
    try:
        outs = [eng.result(eng.submit(p, 6), timeout=120) for p in (p1, p2)]
        want = [off.result(off.submit(p, 6), timeout=120) for p in (p1, p2)]
        jouts = [jeng.result(jeng.submit(p, 6), timeout=120)
                 for p in (p1, p2)]
        st, jst = eng.stats(), jeng.stats()
        c = tmodel.config
        page = eng._prefix.get(next(iter(eng._prefix._entries)))
    finally:
        eng.close()
        off.close()
        jeng.close()
    assert outs == want == jouts
    assert st["prefix_hit_pages"] == jst["prefix_hit_pages"] == 3
    for key in ("prefill_tokens_saved", "prefix_published_pages",
                "prefill_tokens"):
        assert st[key] == jst[key], (key, st[key], jst[key])
    assert st["prefix_cache"]["entries"] == jst["prefix_cache"]["entries"]
    assert st["prefix_cache"]["bytes"] == jst["prefix_cache"]["bytes"]
    assert page[0].shape == (c.num_layers, 8, c.num_kv_heads, c.head_dim)


def test_swap_weights_with_a_llama_state_dict(models):
    """An in-flight request across a swap to another init: the tokens
    before the swap are JAX greedy under the first weights, those after
    it JAX greedy under the second from the same context, and the stamps
    split there."""
    jmodel, params, tmodel = models
    params2 = _init(jmodel, 5)
    prompt = _prompts((6,), seed=31)[0]
    n = 40
    eng = LLMEngine(_port(tmodel.config, params), device="cpu",
                    chunk_tokens=2, **ENGINE)
    try:
        rid = eng.submit(prompt, max_new_tokens=n)
        next(eng.stream(rid, timeout=60))  # provably mid-flight
        assert eng.swap_weights(_state(params2), 1, timeout=30) == 1
        roll = eng.rollout(rid, timeout=60)
        st = eng.stats()
    finally:
        eng.close()
    k = roll["versions"].index(1)
    assert roll["versions"] == [0] * k + [1] * (n - k)
    ref = jengine.NaiveLM(jmodel, params, width=64).generate(prompt, n)
    assert roll["tokens"][:k] == ref[:k]
    fresh = jengine.NaiveLM(jmodel, params2, width=64).generate(
        prompt + roll["tokens"][:k], n - k)
    assert roll["tokens"][k:] == fresh
    assert st["swaps"] == 1 and st["pages_in_use"] == 0


@pytest.mark.parametrize("config_kw", [None, {"num_layers": 1},
                                       {"tiny": False, "num_layers": 1,
                                        "hidden_size": 64, "num_heads": 4,
                                        "num_kv_heads": 1,
                                        "vocab_size": 128}])
def test_build_model_and_namespace_equal_the_reference(config_kw):
    """build_model("llama") makes the JAX package's config (tiny preset
    unless tiny=False) with flax's initializers' distributions
    (embedding normal(1/sqrt(h)), lecun-normal kernels, unit norm
    scales), and cache_namespace_for gives the JAX package's string."""
    jcfg = jengine.build_model("llama", config_kw, seed=0)[0].config
    model = build_model("llama", config_kw, seed=0, device="cpu")
    cfg = model.config
    assert isinstance(model, Llama)
    assert {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if f.name != "dtype"} == {
        f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)
        if f.name != "dtype"}
    h = cfg.hidden_size
    with torch.no_grad():
        assert abs(model.embed.std().item() * h ** 0.5 - 1) < 0.05
        q = model.layers[0].attn.q_proj.weight
        assert q.abs().max().item() <= 2 * h ** -0.5 / 0.8796256 + 1e-6
        assert abs(q.std().item() * h ** 0.5 - 1) < 0.1
        assert torch.equal(model.final_norm.weight, torch.ones(h))
    again = build_model("llama", config_kw, seed=0, device="cpu")
    for (name, a), b in zip(model.state_dict().items(),
                            again.state_dict().values()):
        assert torch.equal(a, b), name
    for version in (None, 2):
        assert cache_namespace_for("llama", config_kw, 0, 8, version) == \
            jengine.cache_namespace_for("llama", config_kw, 0, 8, version)


def test_llm_server_serves_llama_with_a_draft():
    """LLMServer(model_kind="llama", draft_config_kw=...) builds a Llama
    target and a Llama draft from the seed, answers a JSON request with
    the target's own greedy tokens, and folds its cache namespace from
    cache_namespace_for."""
    kw = {"dtype": torch.float32}
    dkw = {"dtype": torch.float32, "num_layers": 1, "hidden_size": 32,
           "num_heads": 2, "num_kv_heads": 1}
    server = LLMServer("llama", kw, seed=0, draft_config_kw=dkw,
                       spec_tokens=3, device="cpu", max_slots=2,
                       max_ctx=64, page_size=8)
    try:
        out = server({"tokens": [5, 6, 7, 8], "max_new_tokens": 6})
        eng = server.engine
        st = server.stats()
    finally:
        server.drain()
    assert isinstance(eng._model, Llama)
    assert isinstance(eng._draft_model, Llama)
    assert eng._draft_model.config.num_kv_heads == 1
    naive = NaiveLM(build_model("llama", kw, 0, device="cpu"), width=64,
                    device="cpu")
    assert out["tokens"] == naive.generate([5, 6, 7, 8], 6)
    assert st["spec_proposed"] > 0
    assert eng._base_namespace == cache_namespace_for("llama", kw, 0, 8)
