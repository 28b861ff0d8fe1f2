"""The port's serving path against the JAX package's, on converted weights.

Greedy decode is held by token identity: the port's LLMEngine must emit
exactly the tokens of the JAX NaiveLM and LLMEngine on the same fp32
weights, across mixed prompt lengths, a mid-flight admission and a
preemption.  Seeded sampling cannot reproduce JAX's threefry bits, so it
is held by distribution against the softmax, and bitwise between the
port's own engine and NaiveLM."""
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.models import GPT2 as JGPT2
from ray_tpu.models import GPT2Config as JConfig
from ray_tpu.serve import llm_engine as jengine
from ray_tpu.serve import sampling as jsampling
from ray_tpu_torch.exceptions import KVPoolExhaustedError
from ray_tpu_torch.models import GPT2, GPT2Config
from ray_tpu_torch.models.convert import gpt2_params_from_jax
from ray_tpu_torch.serve import LLMEngine, LLMServer, NaiveLM, SamplingParams
from ray_tpu_torch.serve import sampling as tsampling


@pytest.fixture(scope="module")
def models():
    """(JAX model, params, port model) with the same fp32 tiny weights."""
    cfg = JConfig.tiny(dtype=jnp.float32)
    jmodel = JGPT2(cfg)
    params = jmodel.init(jax.random.PRNGKey(0),
                         jnp.zeros((1, 8), jnp.int32))["params"]
    tmodel = GPT2(GPT2Config.tiny(dtype=torch.float32))
    tmodel.load_state_dict(gpt2_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    return jmodel, params, tmodel.eval()


def _prompts(sizes, seed=0, vocab=512):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(0, vocab, size=n))) for n in sizes]


def _port_engine(tmodel, **kw):
    return LLMEngine(tmodel, device="cpu", **kw)


def test_greedy_tokens_identical_to_jax_naive_and_engine(models):
    """Mixed prompt lengths (as test_serving.py's paged-decode test)."""
    jmodel, params, tmodel = models
    prompts = _prompts((5, 11, 19, 30))
    eng = _port_engine(tmodel, max_slots=4, page_size=8, max_ctx=64)
    jeng = jengine.LLMEngine(jmodel, params, max_slots=4, page_size=8,
                             max_ctx=64)
    try:
        outs = [eng.result(eng.submit(p, max_new_tokens=10), timeout=120)
                for p in prompts]
        jouts = [jeng.result(jeng.submit(p, max_new_tokens=10), timeout=120)
                 for p in prompts]
    finally:
        eng.close()
        jeng.close()
    jnaive = jengine.NaiveLM(jmodel, params, width=64)
    assert outs == [jnaive.generate(p, 10) for p in prompts]
    assert outs == jouts
    assert eng.stats()["completed"] == 4


def test_mid_flight_admission_identical_to_jax(models):
    """A request submitted while another is mid-decode joins the batch at
    a token boundary without perturbing either request's tokens."""
    jmodel, params, tmodel = models
    a, b = _prompts((7, 13), seed=7)
    eng = _port_engine(tmodel, max_slots=4, page_size=8, max_ctx=64,
                       chunk_tokens=2)
    try:
        rid_a = eng.submit(a, max_new_tokens=24)
        stream = eng.stream(rid_a, timeout=60)
        next(stream)  # a is provably mid-decode now
        rid_b = eng.submit(b, max_new_tokens=8)
        out_b = eng.result(rid_b, timeout=120)
        out_a = eng.result(rid_a, timeout=120)
        st = eng.stats()
    finally:
        eng.close()
    jnaive = jengine.NaiveLM(jmodel, params, width=64)
    assert out_a == jnaive.generate(a, 24)
    assert out_b == jnaive.generate(b, 8)
    assert st["admitted_mid_batch"] >= 1, st


def _preempting_engine(tmodel):
    # 9 usable pages of 4 tokens; each request grows to 24 tokens = 6
    # pages, so two in flight must collide and preempt.
    return _port_engine(tmodel, max_slots=2, page_size=4, max_ctx=32,
                        num_pages=10)


def test_preemption_identical_to_jax(models):
    jmodel, params, tmodel = models
    prompts = _prompts((8, 8), seed=17)
    eng = _preempting_engine(tmodel)
    try:
        rids = [eng.submit(p, max_new_tokens=16) for p in prompts]
        outs = [eng.result(r, timeout=120) for r in rids]
        st = eng.stats()
    finally:
        eng.close()
    jnaive = jengine.NaiveLM(jmodel, params, width=32)
    assert outs == [jnaive.generate(p, 16) for p in prompts]
    assert st["preemptions"] >= 1, st
    assert st["pages_in_use"] == 0, st  # everything recycled


@pytest.mark.parametrize("preempt", [False, True])
def test_sampled_engine_equals_port_naive(models, preempt):
    """Temperature/top-p sampling is position-seeded, so the engine
    (batched, cached, possibly preempted and re-prefilled) draws exactly
    the tokens of the port's full-context NaiveLM."""
    _, _, tmodel = models
    prompts = _prompts((8, 8) if preempt else (5, 12, 20), seed=23)
    params = [SamplingParams(temperature=0.8, top_p=0.9, seed=100 + i)
              for i in range(len(prompts))]
    eng = _preempting_engine(tmodel) if preempt else _port_engine(
        tmodel, max_slots=4, page_size=8, max_ctx=64)
    try:
        rids = [eng.submit(p, max_new_tokens=16, sampling=s)
                for p, s in zip(prompts, params)]
        outs = [eng.result(r, timeout=120) for r in rids]
        st = eng.stats()
    finally:
        eng.close()
    naive = NaiveLM(tmodel, width=64, device="cpu")
    assert outs == [naive.generate(p, 16, sampling=s)
                    for p, s in zip(prompts, params)]
    if preempt:
        assert st["preemptions"] >= 1, st
    # Different seeds give different streams (sampling is live).
    assert len({tuple(o) for o in outs}) == len(outs)


def _top_p_masks(top_p):
    logits = np.random.default_rng(3).standard_normal((6, 97)).astype(
        np.float32) * 3
    logits[0, :4] = 1.0  # ties, broken by the stable sort in both
    tp = np.full((6,), top_p, np.float32)
    want = np.asarray(jsampling.top_p_mask(jnp.asarray(logits),
                                           jnp.asarray(tp)))
    got = tsampling.top_p_mask(torch.from_numpy(logits),
                               torch.from_numpy(tp)).numpy()
    assert got.dtype == np.bool_
    return logits, got, want


@pytest.mark.parametrize("top_p", [0.1, 0.5, 0.9])
def test_top_p_mask_identical_to_jax(top_p):
    _, got, want = _top_p_masks(top_p)
    np.testing.assert_array_equal(got, want)


def test_top_p_mask_at_one_differs_only_in_the_fp32_tail():
    """At top_p = 1.0 both packages drop the tail tokens whose preceding
    mass already rounds to >= 1 in fp32.  XLA's and PyTorch's softmax
    differ by an ulp, so which of those tokens go differs; every token
    with probability above 1e-6 is kept alike (ROADMAP, Queue 3)."""
    logits, got, want = _top_p_masks(1.0)
    probs = torch.softmax(torch.from_numpy(logits).double(), -1).numpy()
    differ = got != want
    assert (probs[differ] < 1e-6).all()
    assert got[probs >= 1e-6].all() and want[probs >= 1e-6].all()


def test_greedy_tokens_and_logprobs_match_jax():
    """Greedy rows pick the same token; its raw log-softmax matches to
    1e-5 (fp32 log-sum-exp over 97 entries, summation order only)."""
    logits = np.random.default_rng(4).standard_normal((5, 97)).astype(
        np.float32) * 2
    n = logits.shape[0]
    args = (np.arange(n, dtype=np.int32), np.zeros(n, np.float32),
            np.ones(n, np.float32), np.arange(n, dtype=np.int32))
    jt, jl = jsampling.sample_tokens_with_logprobs(
        jnp.asarray(logits), *map(jnp.asarray, args))
    tt, tl = tsampling.sample_tokens_with_logprobs(
        torch.from_numpy(logits), *map(torch.from_numpy, args))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5)


@pytest.mark.parametrize("temperature,top_p", [(1.0, 1.0), (0.7, 1.0),
                                               (1.0, 0.8)])
def test_sampled_frequencies_follow_the_softmax(temperature, top_p):
    """4000 draws (positions 0..3999, one seed) from fixed logits over 8
    tokens: Pearson's chi-square against softmax(logits / T), renormalised
    over the nucleus, stays below the 0.1% critical value for its degrees
    of freedom, and tokens outside the nucleus are never drawn."""
    logits = torch.tensor([2.0, 1.5, 1.0, 0.5, 0.0, -0.5, -1.0, -3.0])
    draws = 4000
    rows = logits.expand(draws, -1)
    tokens = tsampling.sample_tokens(
        rows, torch.arange(draws), torch.full((draws,), temperature),
        torch.full((draws,), top_p), torch.full((draws,), 11))
    probs = torch.softmax(logits / temperature, -1)
    keep = tsampling.top_p_mask((logits / temperature)[None],
                                torch.tensor([top_p]))[0]
    probs = torch.where(keep, probs, 0.0)
    probs = probs / probs.sum()
    counts = torch.bincount(tokens, minlength=8).double()
    assert counts[~keep].sum() == 0
    expected = probs[keep].double() * draws
    chi2 = (((counts[keep] - expected) ** 2) / expected).sum().item()
    # 0.1% critical values of chi-square for 1..7 degrees of freedom.
    critical = [10.83, 13.82, 16.27, 18.47, 20.52, 22.46, 24.32]
    assert chi2 < critical[int(keep.sum()) - 2], chi2


def test_llm_server_answers_json_request():
    server = LLMServer("gpt2", {"dtype": torch.float32}, seed=0,
                       device="cpu", max_slots=2, max_ctx=64)
    try:
        request = json.loads(json.dumps({"tokens": [1, 2, 3, 4, 5],
                                         "max_new_tokens": 6}))
        reply = server(request)
        assert json.loads(json.dumps(reply)) == reply
        naive = NaiveLM(server.engine._model, width=64, device="cpu")
        assert reply["tokens"] == naive.generate([1, 2, 3, 4, 5], 6)
        rid = server.submit_stream([9, 8, 7], max_new_tokens=5)
        chunks = []
        while (chunk := server.next_chunk(rid, timeout=60)) is not None:
            chunks.append(chunk)
        assert [t for c in chunks for t in c] == naive.generate([9, 8, 7], 5)
        assert server.stats()["completed"] == 2
    finally:
        server.drain()


def test_prompt_that_can_never_fit_fails_typed(models):
    _, _, tmodel = models
    eng = _port_engine(tmodel, max_slots=2, page_size=4, max_ctx=64,
                       num_pages=4)
    try:
        rid = eng.submit(list(range(1, 30)), max_new_tokens=4)
        with pytest.raises(KVPoolExhaustedError):
            eng.result(rid, timeout=60)
        # The engine keeps serving requests that fit.
        assert len(eng.result(eng.submit([1, 2, 3], max_new_tokens=3),
                              timeout=60)) == 3
    finally:
        eng.close()
