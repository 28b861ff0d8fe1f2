"""The port's prefix cache against the JAX package's, on converted fp32
weights (tiny GPT-2).

The keys are pure-Python hashes and must be equal string for string; the
host LRU must evict in the same order at the same byte counts (bf16 pages
count two bytes an element in both); the tail prefill must write the K/V,
sample the token and give the logits of the JAX tail prefill (1e-5); and an
engine with the cache must skip the same prefill work as the JAX engine,
with the same tokens."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.models import GPT2 as JGPT2
from ray_tpu.models import GPT2Config as JConfig
from ray_tpu.serve import llm_engine as jengine
from ray_tpu.serve import prefix_cache as jpc
from ray_tpu_torch.models import GPT2, GPT2Config
from ray_tpu_torch.models.convert import gpt2_params_from_jax
from ray_tpu_torch.serve import LLMEngine, NaiveLM, SamplingParams
from ray_tpu_torch.serve import prefix_cache as tpc

TOL = 1e-5
SP = SamplingParams(temperature=0.8, top_p=0.9, seed=7)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def models():
    jcfg = JConfig.tiny(dtype=jnp.float32)
    jmodel = JGPT2(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0),
                         jnp.zeros((1, 8), jnp.int32))["params"]
    tmodel = GPT2(GPT2Config.tiny(dtype=torch.float32))
    tmodel.load_state_dict(gpt2_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    return jmodel, params, tmodel.eval()


def _tokens(n, seed=0):
    return list(map(int, np.random.default_rng(seed).integers(0, 50257,
                                                              size=n)))


KEY_CASES = {
    "versioned_namespace": lambda m: m.versioned_namespace("gpt2|ps16", 7),
    "page_key": lambda m: m.page_key("ns|wv0", _tokens(48)),
    "page_key_numpy": lambda m: m.page_key(
        "ns|wv3", np.asarray(_tokens(33, 1), np.int64)),
    "prefix_page_keys": lambda m: m.prefix_page_keys("ns", _tokens(70), 16),
    "prefix_page_keys_capped": lambda m: m.prefix_page_keys(
        "ns", _tokens(70), 16, max_pages=(70 - 1) // 16),
    "affinity_key": lambda m: m.affinity_key(_tokens(40)),
    "affinity_key_short": lambda m: m.affinity_key(_tokens(5)),
    "rendezvous_pick": lambda m: [m.rendezvous_pick(
        m.affinity_key(_tokens(20, s)), ["r0", "r1", "r2", "r3"])
        for s in range(16)],
}


@pytest.mark.parametrize("case", sorted(KEY_CASES))
def test_keys_equal_jax_string_for_string(case):
    got, want = KEY_CASES[case](tpc), KEY_CASES[case](jpc)
    assert got == want
    assert got  # not an empty list or string


def test_local_cache_evicts_as_jax_at_bf16_byte_counts():
    """The same puts and gets on both LRUs under one byte budget: the
    same entries survive in the same order, with the same byte and
    eviction counts.  The port's pages are bf16 CPU tensors, the JAX
    package's bf16 numpy arrays (two bytes an element in both)."""
    shape = (2, 8, 2, 32)  # [L, ps, Hkv, D]: 2 KiB a bf16 tensor
    page = 2 * int(np.prod(shape)) * 2  # k + v
    budget = 5 * page + page // 2
    t = tpc.PrefixCacheLocal(budget)
    j = jpc.PrefixCacheLocal(budget)
    rng = np.random.default_rng(0)
    ops = [("put", f"p{i}") for i in range(4)] + [("get", "p0")] + \
        [("put", f"p{i}") for i in range(4, 9)] + [("get", "p0"),
                                                   ("get", "p5")] + \
        [("put", "p2"), ("put", "p9")]
    for op, key in ops:
        if op == "put":
            x = rng.standard_normal(shape).astype(np.float32)
            t.put(key, torch.from_numpy(x).bfloat16(),
                  torch.from_numpy(x).bfloat16())
            jx = x.astype(jnp.bfloat16)
            j.put(key, jx, jx.copy())
        else:
            assert (t.get(key) is None) == (j.get(key) is None)
    assert list(t._entries) == list(j._entries)
    assert t.stats() == j.stats()
    assert t.stats()["evictions"] > 0 and t.stats()["bytes"] <= budget


def _random_pages(rng, cfg, num_pages, ps):
    shape = (cfg.num_layers, num_pages, ps, cfg.num_heads,
             cfg.hidden_size // cfg.num_heads)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(2)]


@pytest.mark.parametrize("start,p", [(16, 27), (8, 9), (24, 40)])
def test_tail_prefill_matches_jax(models, start, p):
    """The tail of a context whose first ``start`` positions are in the
    slot's pages: the K/V written for the tail, the greedy token at p and
    its logprob equal the JAX tail prefill's, and the logits row equals
    the JAX model's over the gathered cache (1e-5)."""
    jmodel, params, tmodel = models
    kw = dict(max_slots=2, page_size=8, max_ctx=64, start=False)
    jeng = jengine.LLMEngine(jmodel, params, **kw)
    eng = LLMEngine(tmodel, device="cpu", **kw)
    rng = np.random.default_rng(start + p)
    cfg = jmodel.config
    kp, vp = _random_pages(rng, cfg, 2 * 8 + 1, 8)
    row = (1 + rng.permutation(16)[:8]).astype(np.int32)
    ctx = list(map(int, rng.integers(0, 512, size=p)))
    tail_len = p - start
    bucket = jeng._bucket_for(tail_len)
    toks = np.zeros((bucket,), np.int32)
    toks[:tail_len] = ctx[start:]
    jk, jv, jtok, jlogp = jeng._tail_prefill_fn(bucket)(
        params, jnp.asarray(kp), jnp.asarray(vp), row, toks, np.int32(start),
        np.int32(p), np.float32(0.0), np.float32(1.0), np.int32(0))
    eng._k_pages = torch.from_numpy(kp.copy())
    eng._v_pages = torch.from_numpy(vp.copy())
    with torch.inference_mode():
        logits = eng._tail_prefill(row.astype(np.int64), ctx, start)
    tok = int(logits.argmax())
    assert tok == int(jtok)
    np.testing.assert_allclose(float(torch.log_softmax(logits, -1)[tok]),
                               float(jlogp), atol=TOL)
    # Page 0 takes the padding's writes.
    np.testing.assert_allclose(eng._k_pages.numpy()[:, 1:],
                               np.asarray(jk)[:, 1:], atol=TOL)
    np.testing.assert_allclose(eng._v_pages.numpy()[:, 1:],
                               np.asarray(jv)[:, 1:], atol=TOL)
    view = [(jnp.asarray(kp[i][row].reshape(1, 64, *kp.shape[-2:])),
             jnp.asarray(vp[i][row].reshape(1, 64, *vp.shape[-2:])))
            for i in range(cfg.num_layers)]
    jlogits, _ = jmodel.apply({"params": params}, toks[None],
                              (start + np.arange(bucket))[None], view,
                              np.array([start], np.int32))
    np.testing.assert_allclose(logits.numpy(),
                               np.asarray(jlogits)[0, tail_len - 1],
                               atol=TOL)


def test_prefix_hit_skips_prefill_identical_to_jax(models):
    """The second request sharing a 24-token prefix adopts three cached
    pages and prefills only its tail; the tokens are the cache-off tokens
    (greedy: JAX's; sampled: the port's plain stream), and the hit, saved,
    published and prefilled counts are the JAX engine's
    (test_serving_tier.py:207)."""
    jmodel, params, tmodel = models
    rng = np.random.default_rng(23)
    shared = list(map(int, rng.integers(0, 512, size=24)))
    p1, p2, p3 = shared + [3, 1], shared + [5], shared + [7, 7, 7]
    kw = dict(max_slots=2, page_size=8, max_ctx=64, prefix_cache=True)
    eng = LLMEngine(tmodel, device="cpu", **kw)
    jeng = jengine.LLMEngine(jmodel, params, **kw)
    try:
        o1 = eng.result(eng.submit(p1, 6), timeout=120)
        t1 = eng.stats()["prefill_tokens"]
        o2 = eng.result(eng.submit(p2, 6, sampling=SP), timeout=120)
        o3 = eng.result(eng.submit(p3, 6), timeout=120)
        jouts = [jeng.result(jeng.submit(p, 6), timeout=120)
                 for p in (p1, p2, p3)]
        st, jst = eng.stats(), jeng.stats()
    finally:
        eng.close()
        jeng.close()
    jnaive = jengine.NaiveLM(jmodel, params, width=64)
    assert [o1, o3] == [jnaive.generate(p1, 6), jnaive.generate(p3, 6)]
    assert [o1, o3] == [jouts[0], jouts[2]]
    assert o2 == NaiveLM(tmodel, width=64, device="cpu").generate(
        p2, 6, sampling=SP)
    assert st["prefill_tokens"] - t1 == len(p2) - 24 + len(p3) - 24, st
    for key in ("prefix_hit_pages", "prefill_tokens_saved",
                "prefix_published_pages", "prefill_tokens"):
        assert st[key] == jst[key], (key, st[key], jst[key])
    assert st["prefix_hit_pages"] >= 6 and st["prefill_tokens_saved"] >= 48
    assert st["prefix_cache"]["entries"] == jst["prefix_cache"]["entries"]
    assert st["pages_in_use"] == 0


def test_adoption_puts_back_the_snapshotted_bf16_bits(models):
    """At bf16 a snapshotted page goes back to the device bit for bit: a
    second request over the same prefix finds, in its adopted pages, the
    bytes of the first request's pages, and decodes the cache-off
    tokens."""
    _, _, tmodel = models
    m16 = GPT2(GPT2Config.tiny(dtype=torch.bfloat16))
    m16.load_state_dict(tmodel.state_dict())
    m16.eval()
    shared = list(map(int, np.random.default_rng(5).integers(0, 512,
                                                             size=32)))
    off = LLMEngine(m16, device="cpu", max_slots=2, page_size=8, max_ctx=64)
    eng = LLMEngine(m16, device="cpu", max_slots=2, page_size=8, max_ctx=64,
                    prefix_cache=True, start=False)
    try:
        want = [off.result(off.submit(shared + t, 5), timeout=120)
                for t in ([1, 2], [3])]
        eng.submit(shared + [1, 2], 5)
        with torch.inference_mode():
            eng._admit()
        first = eng._slot_pages[0][:4]
        snap = eng._k_pages[:, first].clone()
        cached = [eng._prefix.get(key)[0] for key in tpc.prefix_page_keys(
            eng._namespace, shared, 8)]
        assert all(c.dtype == torch.bfloat16 for c in cached)
        torch.testing.assert_close(torch.stack(cached, 1), snap, rtol=0,
                                   atol=0)
        eng.submit(shared + [3], 5)
        with torch.inference_mode():
            eng._admit()
        second = eng._slot_pages[1][:4]
        torch.testing.assert_close(eng._k_pages[:, second], snap, rtol=0,
                                   atol=0)
        assert eng.stats()["prefix_hit_pages"] == 4
    finally:
        off.close()
    eng2 = LLMEngine(m16, device="cpu", max_slots=2, page_size=8, max_ctx=64,
                     prefix_cache=eng._prefix)
    try:
        got = [eng2.result(eng2.submit(shared + t, 5), timeout=120)
               for t in ([1, 2], [3])]
        st = eng2.stats()
    finally:
        eng2.close()
    assert got == want
    assert st["prefix_hit_pages"] == 8 and st["pages_in_use"] == 0


def test_prefix_directory_raises_naming_the_runtime(models):
    _, _, tmodel = models
    with pytest.raises(NotImplementedError, match="Queue 1 item 1a"):
        LLMEngine(tmodel, device="cpu", start=False, max_ctx=64,
                  prefix_directory=object())
    with pytest.raises(NotImplementedError, match="Queue 1 item 1a"):
        tpc.create_directory()
