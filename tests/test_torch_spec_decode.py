"""Speculative decoding of the port's LLMEngine against the JAX engine's,
on converted fp32 weights (tiny GPT-2).

Greedy decode is held by token identity with the JAX package; sampled
decode by the port's own plain stream (the port's sampler draws other bits
than threefry).  The draft and verify steps are held to the JAX steps on
the same pages, table and tokens: the K/V they write, the token and
logprob they sample, and their logits against the JAX model's on the same
attention view, all to 1e-5."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.models import GPT2 as JGPT2
from ray_tpu.models import GPT2Config as JConfig
from ray_tpu.serve import llm_engine as jengine
from ray_tpu_torch.models import GPT2, GPT2Config
from ray_tpu_torch.models.convert import gpt2_params_from_jax, layerskip_draft
from ray_tpu_torch.serve import LLMEngine, NaiveLM, SamplingParams

TOL = 1e-5
SP = SamplingParams(temperature=0.8, top_p=0.9, seed=7)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: under the suite's parallel workers extra
    threads only contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port(jcfg, params, cfg):
    m = GPT2(cfg)
    m.load_state_dict(gpt2_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    return m.eval()


@pytest.fixture(scope="module")
def models():
    """(JAX model, params, port model): the same tiny fp32 weights."""
    jcfg = JConfig.tiny(dtype=jnp.float32)
    jmodel = JGPT2(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0),
                         jnp.zeros((1, 8), jnp.int32))["params"]
    return jmodel, params, _port(jcfg, params,
                                 GPT2Config.tiny(dtype=torch.float32))


@pytest.fixture(scope="module")
def drafts(models):
    """The draft_of draft (1 layer, half width, its own init) in both
    packages."""
    jmodel, _, _ = models
    jdcfg = JConfig.draft_of(jmodel.config)
    jdraft = JGPT2(jdcfg)
    dparams = jdraft.init(jax.random.PRNGKey(1),
                          jnp.zeros((1, 8), jnp.int32))["params"]
    dcfg = GPT2Config.draft_of(GPT2Config.tiny(dtype=torch.float32))
    assert (dcfg.num_layers, dcfg.num_heads, dcfg.hidden_size) == (
        jdcfg.num_layers, jdcfg.num_heads, jdcfg.hidden_size)
    return jdraft, dparams, _port(jdcfg, dparams, dcfg)


def _prompts(sizes, seed=0, vocab=512):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(0, vocab, size=n))) for n in sizes]


def test_self_draft_greedy_full_acceptance_identical_to_jax(models):
    """Draft == target: every proposal verifies (acceptance 1.0), and the
    greedy tokens are the JAX engine's and NaiveLM's
    (test_serving_tier.py:144)."""
    jmodel, params, tmodel = models
    prompts = _prompts((6, 12), seed=5)
    eng = LLMEngine(tmodel, device="cpu", max_slots=2, page_size=8,
                    max_ctx=64, draft_model=tmodel, spec_tokens=4)
    jeng = jengine.LLMEngine(jmodel, params, max_slots=2, page_size=8,
                             max_ctx=64, draft_model=jmodel,
                             draft_params=params, spec_tokens=4)
    try:
        outs = [eng.result(eng.submit(p, 12), timeout=120) for p in prompts]
        sampled = [eng.result(eng.submit(p, 12, sampling=SP), timeout=120)
                   for p in prompts]
        jouts = [jeng.result(jeng.submit(p, 12), timeout=120)
                 for p in prompts]
        st, jst = eng.stats(), jeng.stats()
    finally:
        eng.close()
        jeng.close()
    jnaive = jengine.NaiveLM(jmodel, params, width=64)
    assert outs == jouts == [jnaive.generate(p, 12) for p in prompts]
    naive = NaiveLM(tmodel, width=64, device="cpu")
    assert sampled == [naive.generate(p, 12, sampling=SP) for p in prompts]
    assert st["spec_acceptance_rate"] == jst["spec_acceptance_rate"] == 1.0
    assert st["spec_steps"] >= 1 and st["pages_in_use"] == 0, st


def test_tiny_draft_sampled_equals_plain_and_greedy_equals_jax(models,
                                                               drafts):
    """A draft_of draft with its own weights: acceptance is partial, the
    sampled stream is still the port's plain stream at the same seed, and
    greedy decode is JAX's (test_serving_tier.py:167)."""
    jmodel, params, tmodel = models
    _, _, tdraft = drafts
    prompts = _prompts((7, 10), seed=13)
    eng = LLMEngine(tmodel, device="cpu", max_slots=2, page_size=8,
                    max_ctx=64, draft_model=tdraft, spec_tokens=3)
    plain = LLMEngine(tmodel, device="cpu", max_slots=2, page_size=8,
                      max_ctx=64)
    try:
        rids = [eng.submit(p, 12, sampling=SP) for p in prompts]
        outs = [eng.result(r, timeout=120) for r in rids]
        want = [plain.result(plain.submit(p, 12, sampling=SP), timeout=120)
                for p in prompts]
        g = eng.result(eng.submit(prompts[0], 12), timeout=120)
        st, rs = eng.stats(), eng.request_stats(rids[0])
    finally:
        eng.close()
        plain.close()
    assert outs == want
    assert g == jengine.NaiveLM(jmodel, params, width=64).generate(
        prompts[0], 12)
    assert st["spec_proposed"] > 0 and 0.0 < st["spec_acceptance_rate"] < 1
    assert rs["spec_proposed"] > 0
    assert 0.0 <= rs["spec_acceptance_rate"] <= 1.0
    assert st["pages_in_use"] == 0, st


def test_windowed_draft_sampled_equals_plain_on_long_context(models):
    """The LayerSkip draft with a 16-token window over contexts of 40-60
    tokens: the window drops most of the context, and the emitted stream
    is still the plain one."""
    _, _, tmodel = models
    prompts = _prompts((40, 52), seed=3)
    eng = LLMEngine(tmodel, device="cpu", max_slots=2, page_size=8,
                    max_ctx=64, draft_model=layerskip_draft(tmodel),
                    spec_tokens=4, draft_window=16)
    try:
        outs = [eng.result(eng.submit(p, 10, sampling=SP), timeout=120)
                for p in prompts]
        st = eng.stats()
    finally:
        eng.close()
    naive = NaiveLM(tmodel, width=64, device="cpu")
    assert outs == [naive.generate(p, 10, sampling=SP) for p in prompts]
    assert eng._draft_window_pages == 2 and st["pages_in_use"] == 0


def _random_pages(rng, cfg, num_pages, page_size):
    shape = (cfg.num_layers, num_pages, page_size, cfg.num_heads,
             cfg.hidden_size // cfg.num_heads)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(2)]


def _step_inputs(rng, n, pp, num_pages):
    """A page table of distinct pages per slot (page 0 stays scratch)."""
    perm = rng.permutation(np.arange(1, num_pages))[:n * pp]
    return perm.reshape(n, pp).astype(np.int32)


def _jax_view(pages, table, cfg, start=None, wp=None, ps=8):
    """The attention view, gathered in numpy: the full table, or the wp
    pages from ``start`` (per slot)."""
    if wp is not None:
        table = np.stack([table[s, start[s]:start[s] + wp]
                          for s in range(table.shape[0])])
    g = pages[:, table]
    return g.reshape(g.shape[0], g.shape[1], -1, *g.shape[-2:])


def _greedy(logits):
    logits = torch.as_tensor(logits)
    tok = logits.argmax(-1)
    return tok.numpy(), torch.log_softmax(logits, -1).gather(
        -1, tok[..., None])[..., 0].numpy()


@pytest.mark.parametrize("window", [None, 16])
def test_draft_decode_step_matches_jax(models, drafts, window):
    """One draft decode step on a context longer than the window (lengths
    35-61, page 8): the K/V written, the greedy token and its logprob
    equal JAX's ``_make_decode_step(window_pages=...)``, and the logits
    equal the JAX model's on the windowed view (1e-5)."""
    jmodel, params, tmodel = models
    jdraft, dparams, tdraft = drafts
    kw = dict(max_slots=4, page_size=8, max_ctx=64, start=False,
              draft_window=window)
    jeng = jengine.LLMEngine(jmodel, params, draft_model=jdraft,
                             draft_params=dparams, spec_tokens=3, **kw)
    eng = LLMEngine(tmodel, device="cpu", draft_model=tdraft, spec_tokens=3,
                    **kw)
    rng = np.random.default_rng(11)
    cfg = jdraft.config
    num_pages = 4 * 8 + 1
    kp, vp = _random_pages(rng, cfg, num_pages, 8)
    table = _step_inputs(rng, 4, 8, num_pages)
    lengths = np.array([35, 48, 61, 40], np.int32)
    tokens = rng.integers(0, 512, size=4).astype(np.int32)
    active = np.array([True, True, True, False])
    zeros, ones = np.zeros(4, np.float32), np.ones(4, np.float32)
    step = jax.jit(jeng._make_decode_step(
        jdraft, window_pages=jeng._draft_window_pages))
    jk, jv, jtok, jlogp = step(dparams, jnp.asarray(kp), jnp.asarray(vp),
                               table, lengths, tokens, active, zeros, ones,
                               np.zeros(4, np.int32))
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    with torch.inference_mode():
        logits = eng._draft_decode(tk, tv, table.astype(np.int64),
                                   lengths.astype(np.int64),
                                   tokens.astype(np.int64), active)
    tok, logp = _greedy(logits)
    np.testing.assert_array_equal(tok, np.asarray(jtok))
    np.testing.assert_allclose(logp, np.asarray(jlogp), atol=TOL)
    # Page 0 is the scratch page (the inactive lane's write lands there).
    np.testing.assert_allclose(tk.numpy()[:, 1:], np.asarray(jk)[:, 1:],
                               atol=TOL)
    np.testing.assert_allclose(tv.numpy()[:, 1:], np.asarray(jv)[:, 1:],
                               atol=TOL)
    # The logits against the JAX model on the same (windowed) view.
    if window is None:
        start, wp, view_len = None, None, lengths
    else:
        wp = eng._draft_window_pages
        start = np.maximum((np.maximum(lengths - 1, 0) // 8) - (wp - 1), 0)
        view_len = lengths - start * 8
    kv = [(jnp.asarray(_jax_view(kp, table, cfg, start, wp)[i]),
           jnp.asarray(_jax_view(vp, table, cfg, start, wp)[i]))
          for i in range(cfg.num_layers)]
    jlogits, _ = jdraft.apply({"params": dparams}, tokens[:, None],
                              lengths[:, None], kv, view_len)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits)[:, -1],
                               atol=TOL)


def test_verify_step_matches_jax(models, drafts):
    """The target's verify step over a [slots, 4] window: K/V written at
    all four positions, the greedy token and logprob at each, and the
    logits against the JAX model's on the gathered view (1e-5)."""
    jmodel, params, tmodel = models
    jdraft, dparams, tdraft = drafts
    k = 4
    kw = dict(max_slots=3, page_size=8, max_ctx=64, start=False)
    jeng = jengine.LLMEngine(jmodel, params, draft_model=jdraft,
                             draft_params=dparams, spec_tokens=k, **kw)
    eng = LLMEngine(tmodel, device="cpu", draft_model=tdraft, spec_tokens=k,
                    **kw)
    rng = np.random.default_rng(12)
    cfg = jmodel.config
    num_pages = 3 * 8 + 1
    kp, vp = _random_pages(rng, cfg, num_pages, 8)
    table = _step_inputs(rng, 3, 8, num_pages)
    lengths = np.array([9, 30, 55], np.int32)
    window = rng.integers(0, 512, size=(3, k)).astype(np.int32)
    active = np.ones(3, bool)
    zeros, ones = np.zeros(3, np.float32), np.ones(3, np.float32)
    verify = jax.jit(jeng._make_verify_step(jmodel))
    jk, jv, jtok, jlogp = verify(params, jnp.asarray(kp), jnp.asarray(vp),
                                 table, lengths, window, active, zeros, ones,
                                 np.zeros(3, np.int32))
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    with torch.inference_mode():
        logits = eng._verify(tk, tv, table.astype(np.int64),
                             lengths.astype(np.int64),
                             window.astype(np.int64), active)
    tok, logp = _greedy(logits)
    np.testing.assert_array_equal(tok, np.asarray(jtok))
    np.testing.assert_allclose(logp, np.asarray(jlogp), atol=TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=TOL)
    kv = [(jnp.asarray(_jax_view(kp, table, cfg)[i]),
           jnp.asarray(_jax_view(vp, table, cfg)[i]))
          for i in range(cfg.num_layers)]
    positions = lengths[:, None] + np.arange(k)[None]
    jlogits, _ = jmodel.apply({"params": params}, window, positions, kv,
                              lengths)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=TOL)


def test_layerskip_draft_equals_the_jax_bench_draft(models):
    """``layerskip_draft`` is bench_serving_spec's draft: a one-layer
    GPT-2 over the target's wte, wpe, h_0 and ln_f (bench.py:768-774)."""
    jmodel, params, tmodel = models
    jdcfg = JConfig.tiny(dtype=jnp.float32, num_layers=1)
    jd = JGPT2(jdcfg)
    dparams = {n: params[n] for n in ("wte", "wpe", "h_0", "ln_f")}
    draft = layerskip_draft(tmodel)
    ids = np.random.default_rng(2).integers(0, 512, size=(2, 24))
    want = np.asarray(jd.apply({"params": dparams}, jnp.asarray(ids)))
    with torch.no_grad():
        got = draft(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL)
    assert draft.config.num_layers == 1


def test_draft_keeps_its_weights_when_the_target_swaps(models):
    """The draft copies the target's tensors: a swap of the target leaves
    the draft's weights as they were (as the JAX engine's draft_params
    stay), so the swap changes the acceptance rate, not the draft."""
    _, _, tmodel = models
    target = GPT2(tmodel.config)
    target.load_state_dict(tmodel.state_dict())
    draft = layerskip_draft(target)
    before = {n: t.clone() for n, t in draft.state_dict().items()}
    shared = {n: p.data_ptr() for n, p in target.named_parameters()}
    assert not {p.data_ptr() for p in draft.parameters()} & set(
        shared.values())
    eng = LLMEngine(target, device="cpu", max_slots=2, page_size=8,
                    max_ctx=64, draft_model=draft, spec_tokens=3)
    new = {n: t + 0.01 for n, t in target.state_dict().items()}
    try:
        eng.swap_weights(new, 1, timeout=30)
        out = eng.result(eng.submit([1, 2, 3, 4, 5], 6), timeout=60)
    finally:
        eng.close()
    assert len(out) == 6
    for n, t in draft.state_dict().items():
        torch.testing.assert_close(t, before[n], rtol=0, atol=0)
    torch.testing.assert_close(target.wte.detach(), new["wte"], rtol=0,
                               atol=0)


def _refusal_cases():
    big = JConfig.tiny(dtype=jnp.float32, vocab_size=600)
    short = JConfig.tiny(dtype=jnp.float32, max_position_embeddings=32)
    return {
        "spec_tokens_1": (None, {"spec_tokens": 1}),
        "draft_vocab": (big, {}),
        "draft_positions": (short, {}),
        "window_without_draft": ("none", {"draft_window": 16}),
    }


@pytest.mark.parametrize("case", sorted(_refusal_cases()))
def test_constructor_refusals_match_jax(models, case):
    """The constructor refuses what the JAX engine refuses, with the same
    exception type (ValueError)."""
    jmodel, params, tmodel = models
    jdcfg, kw = _refusal_cases()[case]
    if jdcfg == "none":
        jdraft = jdparams = tdraft = None
    else:
        jdcfg = jdcfg or jmodel.config
        jdraft = JGPT2(jdcfg)
        jdparams = jdraft.init(jax.random.PRNGKey(1),
                               jnp.zeros((1, 8), jnp.int32))["params"]
        tcfg = GPT2Config.tiny(
            dtype=torch.float32, vocab_size=jdcfg.vocab_size,
            max_position_embeddings=jdcfg.max_position_embeddings)
        tdraft = _port(jdcfg, jdparams, tcfg)
    with pytest.raises(ValueError) as jerr:
        jengine.LLMEngine(jmodel, params, max_slots=2, page_size=8,
                          max_ctx=64, start=False, draft_model=jdraft,
                          draft_params=jdparams, **kw)
    with pytest.raises(type(jerr.value)):
        LLMEngine(tmodel, device="cpu", max_slots=2, page_size=8,
                  max_ctx=64, start=False, draft_model=tdraft, **kw)



def test_window_past_max_ctx_keeps_the_plain_stream(models, drafts):
    """Requests that end at max_ctx: the last verify windows reach past
    the context, and their rows go to the scratch page (the JAX engine's
    clamped page column would wrap them onto the slot's last page, over
    K/V that a later step of the same request still reads).  Greedy spec
    decoding stays the plain greedy stream to the last token."""
    _, _, tmodel = models
    _, _, tdraft = drafts
    prompts = _prompts(range(9, 21), seed=21)
    eng = LLMEngine(tmodel, device="cpu", max_slots=4, page_size=8,
                    max_ctx=32, draft_model=tdraft, spec_tokens=4)
    try:
        outs = [eng.result(eng.submit(p, 32 - len(p)), timeout=120)
                for p in prompts]
        st = eng.stats()
    finally:
        eng.close()
    naive = NaiveLM(tmodel, width=32, device="cpu")
    assert outs == [naive.generate(p, 32 - len(p)) for p in prompts]
    assert st["spec_acceptance_rate"] < 1.0 and st["pages_in_use"] == 0
