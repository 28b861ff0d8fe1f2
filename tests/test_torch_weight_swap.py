"""Hot weight swaps and version-stamped rollouts of the port's LLMEngine
against the JAX package's (after tests/test_rlhf.py), on converted fp32
weights of a tiny GPT-2 (vocab 64).

A swap installs at a token boundary: tokens before it are the no-swap
run's, tokens after it are a fresh engine's under the new weights (greedy:
JAX's), and the version stamps split exactly there.  The captured
behavior logprobs equal the JAX engine's and a full-context forward's.
Stale versions and mismatched trees are refused; a swap makes pre-swap
prefix pages unaddressable."""
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.models import GPT2 as JGPT2
from ray_tpu.models import GPT2Config as JConfig
from ray_tpu.serve import llm_engine as jengine
from ray_tpu_torch.exceptions import EngineClosedError
from ray_tpu_torch.models import GPT2, GPT2Config
from ray_tpu_torch.models import LlamaConfig
from ray_tpu_torch.models.convert import gpt2_params_from_jax
from ray_tpu_torch.models.llama import split_stages as llama_split_stages
from ray_tpu_torch.serve import (
    LLMEngine,
    LLMServer,
    build_model,
    cache_namespace_for,
    generate_many,
)
from ray_tpu_torch.serve.prefix_cache import (
    PrefixCacheLocal,
    versioned_namespace,
)

VOCAB = 64
SHAPE = dict(vocab_size=VOCAB, num_layers=2, hidden_size=32, num_heads=2,
             max_position_embeddings=64)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _state(params):
    return gpt2_params_from_jax(jax.tree_util.tree_map(np.asarray, params))


@pytest.fixture(scope="module")
def lm():
    """(JAX model, p1, p2, and the port state_dicts of p1 and p2)."""
    jmodel = JGPT2(JConfig.tiny(dtype=jnp.float32, **SHAPE))
    ids = jnp.zeros((1, 8), jnp.int32)
    p1 = jmodel.init(jax.random.PRNGKey(0), ids)["params"]
    p2 = jmodel.init(jax.random.PRNGKey(1), ids)["params"]
    return jmodel, p1, p2, _state(p1), _state(p2)


def _port(state):
    m = GPT2(GPT2Config.tiny(dtype=torch.float32, **SHAPE))
    m.load_state_dict(state)
    return m.eval()


def _engine(state, **kw):
    kw.setdefault("max_slots", 4)
    kw.setdefault("page_size", 8)
    kw.setdefault("max_ctx", 64)
    return LLMEngine(_port(state), device="cpu", **kw)


def _prompt(rng, n=6):
    return list(map(int, rng.integers(0, VOCAB, size=n)))


def test_swap_boundary_exactness(lm):
    """test_rlhf.py:56: an in-flight request across a swap.  Pre-swap
    tokens equal the no-swap run's (and JAX greedy under p1), post-swap
    tokens equal JAX greedy under p2 from the same context, and the
    stamps partition exactly at the boundary."""
    jmodel, p1, p2, s1, s2 = lm
    prompt = _prompt(np.random.default_rng(0))
    n = 48  # the swap lands within the 46 tokens after the first chunk
    eng = _engine(s1, chunk_tokens=2)
    try:
        rid = eng.submit(prompt, max_new_tokens=n)
        stream = eng.stream(rid, timeout=60)
        next(stream)  # provably mid-flight
        assert eng.swap_weights(s2, 1, timeout=30) == 1
        roll = eng.rollout(rid, timeout=60)
        st = eng.stats()
    finally:
        eng.close()
    assert len(roll["tokens"]) == n
    assert 0 in roll["versions"] and 1 in roll["versions"]
    k = roll["versions"].index(1)
    assert roll["versions"] == [0] * k + [1] * (n - k)
    ref = jengine.NaiveLM(jmodel, p1, width=64).generate(prompt, n)
    assert roll["tokens"][:k] == ref[:k]
    fresh = jengine.NaiveLM(jmodel, p2, width=64).generate(
        prompt + roll["tokens"][:k], n - k)
    assert roll["tokens"][k:] == fresh
    assert st["swaps"] == 1 and st["swap_reprefills"] >= 1
    assert st["weight_version"] == 1 and st["pages_in_use"] == 0


def test_swap_chaos_zero_drops(lm):
    """test_rlhf.py:100: a swap fired around every decode boundary while
    six requests are in flight: none dropped or failed, monotone stamps,
    no leaked pages."""
    _, _, _, s1, s2 = lm
    rng = np.random.default_rng(1)
    eng = _engine(s1)
    versions = [s1, s2]
    try:
        prompts = [_prompt(rng, n) for n in (3, 5, 6, 8, 4, 7)]
        rids = [eng.submit(p, max_new_tokens=12) for p in prompts]
        stop = threading.Event()
        swapped = []

        def swapper():
            v = 0
            while not stop.is_set():
                v += 1
                eng.swap_weights(versions[v % 2], v, timeout=30)
                swapped.append(v)
                time.sleep(0.01)

        t = threading.Thread(target=swapper, daemon=True)
        t.start()
        rolls = [eng.rollout(r, timeout=120) for r in rids]
        stop.set()
        t.join(timeout=30)
        assert not t.is_alive()
        st = eng.stats()
    finally:
        eng.close()
    assert len(swapped) >= 2
    for roll in rolls:
        assert len(roll["tokens"]) == 12
        vs = roll["versions"]
        assert all(b >= a for a, b in zip(vs, vs[1:]))
    assert st["swaps"] == len(swapped)
    assert st["pages_in_use"] == 0 and st["completed"] == len(rolls)


def test_captured_logprobs_match_jax(lm):
    """test_rlhf.py:144: greedy and sampled rollouts' logprobs equal the
    full-context forward's log-softmax at the emitted tokens (rtol 1e-4,
    atol 1e-5, the reference's bounds), and greedy ones equal the JAX
    engine's captured logprobs (1e-5), all stamped version 0."""
    jmodel, p1, _, s1, _ = lm
    prompt = _prompt(np.random.default_rng(2))
    eng = _engine(s1)
    jeng = jengine.LLMEngine(jmodel, p1, max_slots=4, page_size=8,
                             max_ctx=64)
    try:
        g = eng.submit(prompt, max_new_tokens=10)
        s = eng.submit(prompt, max_new_tokens=10, temperature=1.0, seed=3)
        rolls = [eng.rollout(g, timeout=60), eng.rollout(s, timeout=60)]
        jroll = jeng.rollout(jeng.submit(prompt, max_new_tokens=10),
                             timeout=60)
    finally:
        eng.close()
        jeng.close()
    assert rolls[0]["tokens"] == jroll["tokens"]
    np.testing.assert_allclose(rolls[0]["logprobs"], jroll["logprobs"],
                               atol=1e-5)
    for roll in rolls:
        assert roll["versions"] == [0] * 10
        seq = roll["prompt"] + roll["tokens"]
        logits = jmodel.apply({"params": p1}, jnp.asarray([seq], jnp.int32))
        lp = jax.nn.log_softmax(logits[0], axis=-1)
        p = len(roll["prompt"])
        ref = [float(lp[p - 1 + i, t]) for i, t in enumerate(roll["tokens"])]
        np.testing.assert_allclose(roll["logprobs"], ref, rtol=1e-4,
                                   atol=1e-5)


def test_swap_rejects_stale_version_and_bad_tree(lm):
    """test_rlhf.py:169: a version not strictly newer raises ValueError;
    a mismatched tree stops the engine, and the blocked swapper wakes at
    once with EngineClosedError."""
    _, _, _, s1, s2 = lm
    eng = _engine(s1)
    try:
        eng.swap_weights(s2, 1, timeout=30)
        with pytest.raises(ValueError):
            eng.swap_weights(s1, 1)
        with pytest.raises(ValueError):
            eng.swap_weights(s1, 0)
        bad = {"wrong": torch.zeros(2, 2)}
        t0 = time.monotonic()
        with pytest.raises(EngineClosedError):
            eng.swap_weights(bad, 7, timeout=30)
        assert time.monotonic() - t0 < 10
    finally:
        eng.close()


@pytest.mark.parametrize("bad", ["shape", "dtype"])
def test_swap_rejects_a_leaf_of_another_shape_or_dtype(lm, bad):
    _, _, _, s1, _ = lm
    eng = _engine(s1)
    tree = dict(s1)
    tree["wte"] = (tree["wte"][:-1] if bad == "shape"
                   else tree["wte"].double())
    try:
        with pytest.raises(EngineClosedError):
            eng.swap_weights(tree, 1, timeout=30)
        rid = None
        with pytest.raises(EngineClosedError):
            rid = eng.submit([1, 2, 3], 2)
        assert rid is None
    finally:
        eng.close()


def test_swap_invalidates_prefix_namespace(lm):
    """test_rlhf.py:194: after a swap the namespace carries the new
    version, pages published under the old weights miss, and the whole
    prompt prefills again under the new weights."""
    _, _, _, s1, s2 = lm
    prompt = _prompt(np.random.default_rng(3), 17)
    eng = _engine(s1, prefix_cache=PrefixCacheLocal(64 * 1024 * 1024))
    try:
        ns0 = eng._namespace
        eng.result(eng.submit(prompt, max_new_tokens=2), timeout=60)
        assert eng.stats()["prefix_published_pages"] >= 2
        eng.result(eng.submit(prompt, max_new_tokens=2), timeout=60)
        hits_before = eng.stats()["prefix_hit_pages"]
        assert hits_before >= 2
        eng.swap_weights(s2, 1, timeout=30)
        assert eng._namespace != ns0
        assert eng._namespace == versioned_namespace(eng._base_namespace, 1)
        pre_tokens = eng.stats()["prefill_tokens"]
        eng.result(eng.submit(prompt, max_new_tokens=2), timeout=60)
        st = eng.stats()
    finally:
        eng.close()
    assert st["prefix_hit_pages"] == hits_before
    assert st["prefill_tokens"] >= pre_tokens + len(prompt)


@pytest.mark.parametrize("config_kw,version", [
    ({"tiny": True}, None), ({"tiny": True}, 3), ({"tiny": True}, 4),
    (None, 0), ({"num_layers": 1, "tiny": True}, None)])
def test_cache_namespace_for_equals_jax(config_kw, version):
    """test_rlhf.py:229: the unversioned base carries no version, and
    every form is the JAX package's string."""
    got = cache_namespace_for("gpt2", config_kw, 0, 8, weight_version=version)
    assert got == jengine.cache_namespace_for("gpt2", config_kw, 0, 8,
                                              weight_version=version)
    if version is None:
        assert "wv" not in got
    else:
        assert got == versioned_namespace(
            cache_namespace_for("gpt2", config_kw, 0, 8), version)


def test_llm_server_swaps_and_returns_rollouts():
    """LLMServer's RLHF surface in-process: generate_rollouts before and
    after swap_weights, request_stats; the server's engine folds its
    cache namespace from cache_namespace_for."""
    kw = {"dtype": torch.float32}
    server = LLMServer("gpt2", kw, seed=0, device="cpu", max_slots=2,
                       max_ctx=64, page_size=8, prefix_cache=True)
    try:
        prompts = [[1, 2, 3, 4, 5], [9, 8, 7]]
        before = server.generate_rollouts(prompts, max_new_tokens=4)
        new = build_model("gpt2", kw, seed=1, device="cpu").state_dict()
        assert server.swap_weights(new, 1) == 1
        after = server.generate_rollouts(prompts, max_new_tokens=4)
        rid = server.submit_stream([4, 4, 4], max_new_tokens=3)
        while server.next_chunk(rid, timeout=60) is not None:
            pass
        rs = server.request_stats(rid)
        base = server.engine._base_namespace
    finally:
        server.drain()
    assert all(r["versions"] == [0] * 4 for r in before)
    assert all(r["versions"] == [1] * 4 for r in after)
    assert all(len(r["logprobs"]) == 4 for r in before + after)
    assert rs["tokens"] == 3 and rs["spec_proposed"] == 0
    assert base == cache_namespace_for("gpt2", kw, 0, 8)


def _one_request(server):
    return [server({"tokens": [1, 2], "max_new_tokens": 2})["tokens"]]


# The Serve entry points are ported: in-process, generate_batch answers
# (token lists with as_refs=False), autoscale_metric reads an idle engine
# as 0, and generate_many, the object-plane client, needs the runtime.
# Llama's pipeline split is ported: two stages give two chunks, the
# blocks split by cost.
@pytest.mark.parametrize("call,want", [
    (lambda s: s.generate_batch([[1, 2]], 2, as_refs=False), _one_request),
    (lambda s: s.autoscale_metric(), lambda s: 0.0),
    (lambda s: generate_many(None, [[1, 2]]),
     (RuntimeError, r"init\(\) has not been called")),
    (lambda s: [f.blocks for f in
                llama_split_stages(LlamaConfig.tiny(), 2)[0]],
     lambda s: [(0, 1), (1, 2)]),
], ids=["generate_batch", "autoscale_metric", "generate_many", "llama"])
def test_left_out_entry_points_raise_naming_their_item(call, want):
    server = LLMServer("gpt2", {"dtype": torch.float32}, seed=0,
                       device="cpu", max_slots=2, max_ctx=64)
    try:
        if isinstance(want, tuple):
            with pytest.raises(want[0], match=want[1]):
                call(server)
        else:
            assert call(server) == want(server)
        assert server.stats()["weight_version"] == 0
    finally:
        server.drain()


def test_swap_weights_refuses_what_is_neither_a_state_dict_nor_a_ref(lm):
    _, _, _, s1, _ = lm
    eng = _engine(s1)
    try:
        with pytest.raises(TypeError, match="state_dict or an ObjectRef"):
            eng.swap_weights(object(), 1)
        assert eng.weight_version == 0
    finally:
        eng.close()


def test_swap_weights_takes_an_object_ref_put_by_another_process(lm):
    """The one-put weight broadcast: a task puts the new state_dict in its
    own process and hands back the ref; the engine's loop resolves it at
    the token boundary.  Tokens after the swap equal JAX greedy under the
    new weights, and the version stamps say so."""
    import ray_tpu_torch

    jmodel, _, p2, s1, s2 = lm
    prompt = _prompt(np.random.default_rng(3))
    ray_tpu_torch.init(num_cpus=1, num_gpus=0,
                       object_store_memory=128 * 1024**2)
    try:
        @ray_tpu_torch.remote
        def publish(state):
            return [ray_tpu_torch.put(state)]

        (ref,) = ray_tpu_torch.get(publish.remote(s2), timeout=60)
        assert isinstance(ref, ray_tpu_torch.ObjectRef)
        eng = _engine(s1)
        try:
            assert eng.swap_weights(ref, 1, timeout=60) == 1
            roll = eng.rollout(eng.submit(prompt, max_new_tokens=8),
                               timeout=60)
            st = eng.stats()
        finally:
            eng.close()
    finally:
        ray_tpu_torch.shutdown()
    assert roll["versions"] == [1] * 8 and st["swaps"] == 1
    assert roll["tokens"] == jengine.NaiveLM(jmodel, p2, width=64).generate(
        prompt, 8)
