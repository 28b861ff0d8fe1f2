"""The port's RLHF stack against the JAX package's, on the CPU in fp32
(after tests/test_rlhf.py), on a tiny GPT-2 (vocab 64, 2 layers, width
32).

- ``GPT2WithValue``: logits and values on converted parameters, and
  ``init_from_lm``;
- ``sequence_logprobs`` and ``sequence_ppo_loss`` (value, aux metrics
  and every gradient);
- ``SequenceBatch.from_rollouts`` and ``split_fresh``, bit for bit;
- ``RewardScorer`` batching concurrent calls through ``@serve.batch``;
- one ``SeqPPOLearner.update`` with JAX's minibatch permutations;
- ``RLHFLoop``: the version flow with an in-process engine, the
  staleness gate's drops, the drain-then-train baseline, and the toy
  preference reward improving.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.models import GPT2WithValue as JGPT2WithValue
from ray_tpu.models import GPT2Config as JConfig
from ray_tpu.rllib.algorithms.rlhf import ppo_seq as jppo_seq
from ray_tpu.rllib.algorithms.rlhf import reward as jreward
from ray_tpu.rllib.evaluation import sequence_batch as jsb
from ray_tpu_torch.models import GPT2Config, GPT2WithValue
from ray_tpu_torch.models.convert import gpt2_params_from_jax
from ray_tpu_torch.rllib.algorithms import rlhf
from ray_tpu_torch.rllib.algorithms.rlhf import ppo_seq as tppo_seq
from ray_tpu_torch.rllib.evaluation import sequence_batch as tsb
from ray_tpu_torch.serve import LLMEngine

VOCAB = 64
SHAPE = dict(vocab_size=VOCAB, num_layers=2, hidden_size=32, num_heads=2,
             max_position_embeddings=64)
JCFG = JConfig.tiny(dtype=jnp.float32, **SHAPE)
CFG = GPT2Config.tiny(dtype=torch.float32, **SHAPE)
COEFFS = dict(clip_param=0.2, vf_coeff=0.5, entropy_coeff=0.01)
# The same fp32 forward in two frameworks: sums in other orders, a few
# ulp apart on logits and values of size ~1.
FWD_ATOL = 1e-5
# The loss and its aux metrics are masked means of such terms: 1e-5
# relative.  A gradient is a sum over the B*L positions (and, for wte,
# over the tied head's logits) in other orders; held to 1e-5 relative
# to its parameter's largest gradient.
LOSS_RTOL = 1e-5
GRAD_REL = 1e-5
# One update: 2 epochs x 2 minibatches = 4 clip + Adam steps of lr 1e-3.
# Adam moves each element by ~lr whatever its gradient's size, so an
# element whose gradient is small beside the fp32 rounding of its sum
# carries that rounding (1e-7 relative to the sum's terms) up to a share
# of lr; and optax's fp32 bias correction differs from torch's by 6.4e-6
# relative to lr (ROADMAP Queue 3, "Optimizer rounding").  Measured: max
# |dp| 8.5e-6 (a wte element), most parameters below 1e-6.  Held to
# 2e-5, 2% of one step.  The K third of each fused QKV bias is left out:
# softmax is invariant to a shift of every key by one vector, so its
# exact gradient is 0 and Adam scales the rounding noise that stands in
# for it to as much as lr (measured 1.0e-4).
UPDATE_ATOL = 2e-5
# The step's metrics are epoch means of the losses as the parameters
# move; the total is a sum of terms of size up to ~4 (the entropy) that
# cancel to ~0.05, so its rounding is absolute (measured 6.5e-7).
METRIC_ATOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def acm():
    """(JAX GPT2WithValue, its params, the port module loaded with them)."""
    jmodel = JGPT2WithValue(JCFG)
    params = jmodel.init(jax.random.PRNGKey(0),
                         jnp.zeros((1, 8), jnp.int32))["params"]
    return jmodel, params, _port_module(params)


def _port_module(params):
    module = GPT2WithValue(CFG)
    module.load_state_dict(gpt2_params_from_jax(_np_tree(params)),
                           strict=True)
    return module


def _tokens(rng, b=3, length=24):
    return rng.integers(0, VOCAB, size=(b, length)).astype(np.int32)


def test_gpt2_with_value_matches_jax(acm):
    jmodel, params, module = acm
    ids = _tokens(np.random.default_rng(0))
    jlogits, jvalues = jmodel.apply({"params": params}, jnp.asarray(ids))
    with torch.no_grad():
        logits, values = module(torch.from_numpy(ids).long())
    assert logits.dtype == values.dtype == torch.float32
    assert values.shape == ids.shape
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=0,
                               atol=FWD_ATOL)
    np.testing.assert_allclose(values.numpy(), np.asarray(jvalues), rtol=0,
                               atol=FWD_ATOL)


def test_init_from_lm_keeps_the_lm_and_draws_a_value_head(acm):
    """JAX's ``init_from_lm`` replaces the ``lm`` subtree and initializes
    the head afresh; the port's loads the lm state dict bit for bit and
    draws the head from ``normal(0.01)`` on the given generator."""
    jmodel, params, _ = acm
    lm = jax.tree_util.tree_map(lambda x: x + 1.0, params["lm"])
    jparams = jmodel.init_from_lm(jax.random.PRNGKey(3), lm)
    want = gpt2_params_from_jax(_np_tree(jparams))
    lm_state = {k[3:]: v for k, v in want.items() if k.startswith("lm.")}
    a = GPT2WithValue(CFG).init_from_lm(lm_state,
                                        torch.Generator().manual_seed(5))
    b = GPT2WithValue(CFG).init_from_lm(lm_state,
                                        torch.Generator().manual_seed(5))
    c = GPT2WithValue(CFG).init_from_lm(lm_state,
                                        torch.Generator().manual_seed(6))
    for name, t in a.lm.state_dict().items():
        assert torch.equal(t, lm_state[name]), name
    w = a.value_head.weight
    assert w.shape == (1, SHAPE["hidden_size"])
    assert torch.equal(w, b.value_head.weight)
    assert not torch.equal(w, c.value_head.weight)
    assert torch.equal(a.value_head.bias, torch.zeros(1))
    assert 0.003 < float(w.detach().std()) < 0.03  # normal(0.01), 32 draws
    # The head's shape and init scale are the JAX module's.
    jw = np.asarray(jparams["value_head"]["kernel"])
    assert jw.shape == (SHAPE["hidden_size"], 1)
    assert 0.003 < float(jw.std()) < 0.03


def test_sequence_logprobs_match_jax():
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(3, 16, VOCAB)).astype(np.float32) * 3
    tokens = _tokens(rng, 3, 16)
    want = jppo_seq.sequence_logprobs(jnp.asarray(logits),
                                      jnp.asarray(tokens))
    got = tppo_seq.sequence_logprobs(torch.from_numpy(logits),
                                     torch.from_numpy(tokens))
    assert got.shape == (3, 15)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def _loss_batch(rng, jmodel, params, b=4, length=32, lo=8, hi=20):
    """A PPO minibatch: behavior logprobs near the model's own (its
    logprobs plus noise), on response positions [lo, hi)."""
    tokens = _tokens(rng, b, length)
    mask = np.zeros((b, length), np.float32)
    mask[:, lo:hi] = 1.0
    logits, _ = jmodel.apply({"params": params}, jnp.asarray(tokens))
    lp = np.asarray(jppo_seq.sequence_logprobs(logits, jnp.asarray(tokens)))
    behavior = np.zeros((b, length), np.float32)
    behavior[:, 1:] = lp + 0.1 * rng.normal(size=lp.shape)
    return {"tokens": tokens, "response_mask": mask,
            "behavior_logp": (behavior * mask).astype(np.float32),
            "advantages": (rng.normal(size=(b, length)) * mask
                           ).astype(np.float32),
            "value_targets": (rng.random((b, length)) * mask
                              ).astype(np.float32),
            "rewards": rng.random(b).astype(np.float32)}


def test_sequence_ppo_loss_and_gradients_match_jax(acm):
    jmodel, params, _ = acm
    module = _port_module(params)
    batch = _loss_batch(np.random.default_rng(2), jmodel, params)
    keys = ("tokens", "response_mask", "behavior_logp", "advantages",
            "value_targets")
    (jloss, jaux), jgrads = jax.value_and_grad(
        jppo_seq.sequence_ppo_loss, has_aux=True)(
            params, jmodel, {k: jnp.asarray(batch[k]) for k in keys},
            **COEFFS)
    loss, aux = tppo_seq.sequence_ppo_loss(
        module, {k: torch.from_numpy(batch[k]) for k in keys}, **COEFFS)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=LOSS_RTOL)
    assert set(aux) == set(jaux)
    for k in aux:
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]),
                                   rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
    want = gpt2_params_from_jax(_np_tree(jgrads))
    for name, p in module.named_parameters():
        ref = want[name].numpy()
        err = np.abs(p.grad.numpy() - ref).max()
        assert err <= GRAD_REL * np.abs(ref).max(), (name, err)


def _rollouts(rng, n=5):
    out = []
    for i in range(n):
        p, t = int(rng.integers(1, 6)), int(rng.integers(1, 8))
        versions = np.sort(rng.integers(0, 6, size=t)).tolist()
        out.append(dict(prompt=rng.integers(0, VOCAB, size=p).tolist(),
                        tokens=rng.integers(0, VOCAB, size=t).tolist(),
                        logprobs=(-rng.random(t)).astype(np.float32)
                        .tolist(),
                        versions=versions,
                        reward=None if i == 0 else float(rng.random())))
    return out


def test_sequence_batch_and_split_fresh_match_jax_bit_for_bit():
    recs = _rollouts(np.random.default_rng(3))
    mine = [tsb.SequenceRollout(**r) for r in recs]
    theirs = [jsb.SequenceRollout(**r) for r in recs]
    for cur, stale in ((5, 0), (5, 2), (7, 3), (4, 10)):
        a, b = tsb.split_fresh(mine, cur, stale)
        c, d = jsb.split_fresh(theirs, cur, stale)
        assert [mine.index(r) for r in a] == [theirs.index(r) for r in c]
        assert [mine.index(r) for r in b] == [theirs.index(r) for r in d]
    got = tsb.SequenceBatch.from_rollouts(mine, pad_to=16).as_dict()
    want = jsb.SequenceBatch.from_rollouts(theirs, pad_to=16).as_dict()
    assert set(got) == set(want)
    for k in got:
        assert got[k].dtype == want[k].dtype and \
            got[k].tobytes() == want[k].tobytes(), k
    assert tsb.SequenceBatch.from_rollouts(mine, 16).num_response_tokens \
        == jsb.SequenceBatch.from_rollouts(theirs, 16).num_response_tokens
    with pytest.raises(ValueError):
        tsb.SequenceBatch.from_rollouts(mine, pad_to=4)


def test_reward_scorer_batches_concurrent_calls():
    scorer = rlhf.RewardScorer(rlhf.target_token_reward(7),
                               score_parallelism=8)
    try:
        rolls = [tsb.SequenceRollout(prompt=[1],
                                     tokens=[7] * i + [0] * (4 - i),
                                     logprobs=[0.0] * 4, versions=[0] * 4)
                 for i in range(5)]
        rewards = scorer.score_rollouts(rolls)
        want = [jreward.target_token_reward(7)(r.prompt, r.tokens)
                for r in rolls]
        assert rewards == want == [i / 4 for i in range(5)]
        assert [r.reward for r in rolls] == rewards
        assert max(scorer.observed_batch_sizes) >= 2  # batching happened
    finally:
        scorer.close()
    resp = [1, 2, 3, 4]
    assert rlhf.token_set_reward([1, 2])([0], resp) == \
        jreward.token_set_reward([1, 2])([0], resp) == 0.5


def test_seq_ppo_learner_update_matches_jax(acm):
    """One update (advantage pass + 2 epochs x 2 minibatches) on the same
    batch, the port fed the permutations of JAX's key schedule."""
    jmodel, params, _ = acm
    batch = _loss_batch(np.random.default_rng(4), jmodel, params)
    kw = dict(batch_size=4, pad_to=32, lr=1e-3, num_sgd_iter=2,
              minibatch_size=2, seed=0, **COEFFS)
    jlearner = jppo_seq.SeqPPOLearner(jmodel, params, **kw)
    jmetrics = jlearner.update(batch)
    rng, perms = jax.random.PRNGKey(0), []
    for _ in range(2):  # run_ppo_sgd's key schedule
        rng, k = jax.random.split(rng)
        perms.append(torch.from_numpy(
            np.asarray(jax.random.permutation(k, 4)).astype(np.int64)))
    learner = tppo_seq.SeqPPOLearner(_port_module(params), device="cpu",
                                     **kw)
    it = iter(perms)
    learner._permute = lambda n: next(it)
    metrics = learner.update(batch)
    assert set(metrics) == set(jmetrics)
    for k in metrics:
        np.testing.assert_allclose(metrics[k], jmetrics[k], rtol=LOSS_RTOL,
                                   atol=METRIC_ATOL, err_msg=k)
    want = gpt2_params_from_jax(_np_tree(jlearner.params))
    start = gpt2_params_from_jax(_np_tree(params))
    d = SHAPE["hidden_size"]
    for name, p in learner.model.state_dict().items():
        got, ref = p.numpy(), want[name].numpy()
        if name.endswith("attn_qkv.bias"):  # drop the K third (see above)
            got = np.concatenate([got[:d], got[2 * d:]])
            ref = np.concatenate([ref[:d], ref[2 * d:]])
        np.testing.assert_allclose(got, ref, rtol=0, atol=UPDATE_ATOL,
                                   err_msg=name)
        assert (p - start[name]).abs().max() > 100 * UPDATE_ATOL, name
    lm = learner.lm_state_dict()
    assert set(lm) == {k[3:] for k in want if k.startswith("lm.")}


def test_seq_ppo_learner_refuses_what_waits_for_data_parallelism(acm):
    module = acm[2]
    for kw in ({"num_devices": 2}, {"zero_sharding": "opt"},
               {"quantized_collectives": "int8"}):
        with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
            tppo_seq.SeqPPOLearner(module, batch_size=4, pad_to=32,
                                   device="cpu", **kw)
    with pytest.raises(ValueError, match="batch shape"):
        tppo_seq.SeqPPOLearner(module, batch_size=4, pad_to=32,
                               device="cpu").update(
            {"tokens": np.zeros((2, 32), np.int32)})


# ---------------------------------------------------------------------------
# the loop
# ---------------------------------------------------------------------------
def _build_loop(overlap=True, **cfg_kw):
    """tests/test_rlhf.py's loop: an engine on the actor-critic's ``lm``
    at version 0, 4 prompts of 4 tokens, the target-token reward."""
    module = GPT2WithValue(CFG)
    from ray_tpu_torch.serve import build_model

    lm = build_model("gpt2", {"tiny": True, "dtype": torch.float32,
                              **SHAPE}, seed=0, device="cpu")
    module.init_from_lm(lm.state_dict())
    eng = LLMEngine(lm, max_slots=16, page_size=8, max_ctx=64,
                    device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, VOCAB, size=4).tolist() for _ in range(4)]
    cfg_kw.setdefault("rollouts_per_step", 16)
    cfg_kw.setdefault("max_new_tokens", 12)
    cfg_kw.setdefault("lr", 1e-2)
    cfg_kw.setdefault("num_sgd_iter", 4)
    cfg_kw.setdefault("entropy_coeff", 0.001)
    cfg = rlhf.RLHFConfig(overlap=overlap, seed=0, device="cpu", **cfg_kw)
    return eng, rlhf.RLHFLoop(eng, module, prompts,
                              rlhf.target_token_reward(7), cfg)


def test_rlhf_loop_version_flow():
    """Versions advance one a step, the engine applies each swap, every
    batch is full and its loss finite, the scorer rode the batcher, and
    the engine's pages drain once its requests retire."""
    eng, loop = _build_loop(num_sgd_iter=1)
    try:
        hist = loop.run(3)
        st = eng.stats()
        assert [m["weight_version"] for m in hist] == [1, 2, 3]
        assert st["swaps"] == 3 and eng.weight_version == 3
        for m in hist:
            assert m["swap_seconds"] >= 0.0
            assert m["response_tokens"] == 16 * 12
            assert np.isfinite(m["total_loss"])
            assert m["gen_busy_frac_during_sgd"] >= 0.0
        assert loop.scorer.observed_batch_sizes
        # The engine's swapped weights are the learner's lm.
        for name, t in loop.learner.lm_state_dict().items():
            assert torch.equal(eng._model.state_dict()[name], t), name
    finally:
        loop.close()
        eng.close()


def test_rlhf_drain_baseline_runs_inline():
    eng, loop = _build_loop(overlap=False, num_sgd_iter=1)
    try:
        hist = loop.run(2)
        assert [m["weight_version"] for m in hist] == [1, 2]
        assert loop._gen.workers == 0
        assert loop.stale_batches_dropped == 0
    finally:
        loop.close()
        eng.close()


@dataclasses.dataclass
class _LaggingEngine:
    """An engine whose rollouts are stamped ``lag`` versions behind its
    current weights for the first ``stale_batches`` batches."""
    lag: int
    stale_batches: int
    weight_version: int = 0
    calls: int = 0
    work: float = 0.0

    def generate_rollouts(self, prompts, max_new_tokens, sampling=None):
        self.calls += 1
        v = self.weight_version
        if self.calls <= self.stale_batches:
            v = max(0, v - self.lag)
        return [{"prompt": p, "tokens": [7] * max_new_tokens,
                 "logprobs": [-1.0] * max_new_tokens,
                 "versions": [v] * max_new_tokens} for p in prompts]

    def stats(self):
        return {"work_seconds": self.work}

    def swap_weights(self, params, version, timeout=None):
        self.weight_version = version
        return version


def test_rlhf_staleness_gate_drops_stale_batches():
    """A batch whose oldest token is more than ``max_weight_staleness``
    versions behind the learner is dropped, counted, and never trained
    on; the next fresh batch is consumed."""
    module = GPT2WithValue(CFG)
    eng = _LaggingEngine(lag=0, stale_batches=0)
    prompts = [[1, 2, 3, 4]] * 2
    cfg = rlhf.RLHFConfig(rollouts_per_step=2, max_new_tokens=4,
                          num_sgd_iter=1, max_weight_staleness=1,
                          overlap=False, device="cpu")
    loop = rlhf.RLHFLoop(eng, module, prompts, rlhf.target_token_reward(7),
                         cfg)
    try:
        loop.run(2)  # versions 0 -> 2
        assert loop.stale_batches_dropped == 0
        eng.lag, eng.stale_batches = 2, eng.calls + 3
        m = loop.step()
        assert loop.stale_batches_dropped == 3
        assert m["stale_batches_dropped"] == 3
        assert m["weight_version"] == 3 and eng.weight_version == 3
        assert eng.calls == 2 + 3 + 1
    finally:
        loop.close()


def test_rlhf_reward_improves_on_toy_preference():
    """PPO through the serving engine with a hot swap every step climbs
    the target-token reward (tests/test_rlhf.py's gate: the mean of the
    last 4 steps' rewards exceeds the first 4's by more than 0.1)."""
    eng, loop = _build_loop()
    try:
        hist = loop.run(18)
        rewards = [m["reward_mean"] for m in hist]
        first = float(np.mean(rewards[:4]))
        last = float(np.mean(rewards[-4:]))
        assert last > first + 0.1, (
            f"no reward improvement: first4={first:.3f} last4={last:.3f} "
            f"curve={['%.2f' % r for r in rewards]}")
        assert eng.stats()["swaps"] == 18
    finally:
        loop.close()
        eng.close()
