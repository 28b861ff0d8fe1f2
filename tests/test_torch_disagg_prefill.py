"""In-process disaggregated prefill of the port against the JAX
package's, on converted fp32 weights (tiny GPT-2).

The native wire is exact: offloaded admissions decode the tokens of an
inline prefill (greedy: JAX's), and the worker sees only the uncached
tail.  The int8 wire is at least 3x smaller and leaks nothing.  The wire
format itself (``pack_pages``/``unpack_pages`` and the block-int8
quantizer) is byte for byte the JAX package's numpy code."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.models import GPT2 as JGPT2
from ray_tpu.models import GPT2Config as JConfig
from ray_tpu.ops import collectives as jcoll
from ray_tpu.serve import llm_engine as jengine
from ray_tpu.serve import prefill as jprefill
from ray_tpu_torch.models import GPT2, GPT2Config
from ray_tpu_torch.models.convert import gpt2_params_from_jax
from ray_tpu_torch.serve import LLMEngine, NaiveLM, SamplingParams
from ray_tpu_torch.serve import prefill as tprefill

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


def _workers(tmodel, **kw):
    """A port worker holding the converted weights, and the JAX worker
    (whose seeded build is the JAX engine's model)."""
    tw = tprefill.PrefillWorker("gpt2", {"dtype": torch.float32}, 0,
                                page_size=8, device="cpu", **kw)
    tw._model.load_state_dict(tmodel.state_dict())
    jw = jprefill.PrefillWorker("gpt2", {"tiny": True, "dtype": "float32"},
                                0, page_size=8, use_object_plane=False, **kw)
    return tw, jw


def test_inline_exact_matches_jax(models):
    """test_serving_tier.py:242: two offloaded admissions, the second
    sharing a 16-token prefix with the first; tokens equal the inline
    prefill's, and the counts (offloaded, wire bytes, prefix hits, the
    worker's requests and tokens) equal the JAX engine's."""
    jmodel, params, tmodel = models
    tw, jw = _workers(tmodel)
    kw = dict(max_slots=2, page_size=8, max_ctx=64, prefix_cache=True,
              prefill_min_tokens=8)
    eng = LLMEngine(tmodel, device="cpu", prefill=tw, **kw)
    jeng = jengine.LLMEngine(jmodel, params, prefill=jw, **kw)
    rng = np.random.default_rng(29)
    shared = list(map(int, rng.integers(0, 512, size=16)))
    p1 = shared + [2, 4, 6, 8, 10, 12, 14, 1]
    p2 = shared + [9] * 12
    try:
        o1 = eng.result(eng.submit(p1, 6, sampling=SP), timeout=120)
        o2 = eng.result(eng.submit(p2, 6), timeout=120)
        jeng.result(jeng.submit(p1, 6), timeout=120)
        jo2 = jeng.result(jeng.submit(p2, 6), timeout=120)
        st, jst = eng.stats(), jeng.stats()
    finally:
        eng.close()
        jeng.close()
    assert o1 == NaiveLM(tmodel, width=64, device="cpu").generate(
        p1, 6, sampling=SP)
    assert o2 == jo2 == jengine.NaiveLM(jmodel, params, width=64).generate(
        p2, 6)
    for key in ("prefill_offloaded", "wire_bytes", "wire_fp32_bytes",
                "prefix_hit_pages", "prefill_tokens_saved"):
        assert st[key] == jst[key], (key, st[key], jst[key])
    assert st["prefill_offloaded"] == 2 and st["prefix_hit_pages"] >= 2
    assert st["pages_in_use"] == 0 and st["prefill_inflight"] == 0
    wst, jwst = tw.stats(), jw.stats()
    assert wst["requests"] == jwst["requests"] == 2
    assert wst["tokens"] == jwst["tokens"] == len(p1) + len(p2) - 16


def test_int8_wire_is_3x_smaller_and_leaks_nothing(models):
    """test_serving_tier.py:278: decode completes through the approximate
    pages, the wire is >= 3x smaller than fp32, the byte counts are the
    JAX engine's, and no page leaks."""
    jmodel, params, tmodel = models
    tw, jw = _workers(tmodel, wire_dtype="int8")
    kw = dict(max_slots=2, page_size=8, max_ctx=64, prefill_min_tokens=8)
    eng = LLMEngine(tmodel, device="cpu", prefill=tw, **kw)
    jeng = jengine.LLMEngine(jmodel, params, prefill=jw, **kw)
    (p,) = [list(map(int, np.random.default_rng(31).integers(0, 512,
                                                             size=21)))]
    try:
        out = eng.result(eng.submit(p, 6), timeout=120)
        jeng.result(jeng.submit(p, 6), timeout=120)
        st, jst = eng.stats(), jeng.stats()
    finally:
        eng.close()
        jeng.close()
    assert len(out) == 6
    assert st["prefill_offloaded"] == 1
    assert st["wire_fp32_bytes"] / st["wire_bytes"] >= 3.0, st
    assert (st["wire_bytes"], st["wire_fp32_bytes"]) == (
        jst["wire_bytes"], jst["wire_fp32_bytes"])
    assert st["pages_in_use"] == 0


def test_worker_payload_equals_jax(models):
    """One prefill of a 21-token prompt from start 8: the tail pages, the
    next token and its logprob match the JAX worker's (1e-5)."""
    _, _, tmodel = models
    tw, jw = _workers(tmodel)
    p = list(map(int, np.random.default_rng(4).integers(0, 512, size=21)))
    got, want = tw.prefill(p, 8), jw.prefill(p, 8)
    assert got["next_token"] == want["next_token"]
    assert got["k"].shape == want["k"].shape == (2, 2, 8, 2, 32)
    np.testing.assert_allclose(got["next_logp"], want["next_logp"],
                               atol=1e-5)
    np.testing.assert_allclose(got["k"], want["k"], atol=1e-5)
    np.testing.assert_allclose(got["v"], want["v"], atol=1e-5)
    assert (got["p"], got["start"], got["wire_bytes"]) == (
        want["p"], want["start"], want["wire_bytes"])


@pytest.mark.parametrize("wire", ["native", "int8"])
def test_pack_unpack_equal_jax_byte_for_byte(wire):
    rng = np.random.default_rng(7)
    k = rng.standard_normal((2, 3, 8, 2, 32)).astype(np.float32)
    v = rng.standard_normal((2, 3, 8, 2, 32)).astype(np.float32)
    got, want = tprefill.pack_pages(k, v, wire), jprefill.pack_pages(k, v,
                                                                     wire)
    assert got.keys() == want.keys()
    for key, val in want.items():
        if isinstance(val, np.ndarray):
            assert got[key].dtype == val.dtype
            assert got[key].tobytes() == val.tobytes(), key
        else:
            assert got[key] == val, key
    for a, b in zip(tprefill.unpack_pages(got), jprefill.unpack_pages(want)):
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("shape,block", [((4, 70), 32), ((3, 5, 64), 64),
                                         ((2, 256), 256)])
def test_int8_quantizer_equals_jax_numpy_mirror(shape, block):
    x = np.random.default_rng(3).normal(size=shape).astype(np.float32)
    x[0] = 0.0  # an all-zero block: scale 0
    q, s = tprefill.quantize_block_int8_np(x, block)
    jq, js = jcoll.quantize_block_int8_np(x, block)
    assert q.tobytes() == jq.tobytes() and s.tobytes() == js.tobytes()
    n = shape[-1]
    assert tprefill.dequantize_block_int8_np(q, s, n).tobytes() == \
        jcoll.dequantize_block_int8_np(jq, js, n).tobytes()


class _DeploymentLike:
    """A deployment handle's surface: ``method(name).remote(*args)``
    returns a ref whose ``future()`` the job polls."""

    def __init__(self, worker):
        self.worker = worker
        self.calls = []

    def method(self, name):
        handle = self

        class _Ref:
            def __init__(self, value):
                self._value = value

            def future(self):
                from concurrent.futures import Future

                f = Future()
                f.set_result(self._value)
                return f

        class _Method:
            def remote(self, *args):
                handle.calls.append(name)
                return _Ref(getattr(handle.worker, name)(*args))

        return _Method()


def test_deployment_kind_raises_naming_the_serve_control_plane():
    """The Serve control plane is ported: a deployment handle is the
    ``"deployment"`` kind, and a job sent through it calls the replicas'
    ``prefill`` and gives what the worker gives in-process."""
    worker = tprefill.PrefillWorker("gpt2", {"tiny": True, "num_layers": 1,
                                             "dtype": torch.float32}, 0,
                                    page_size=8, device="cpu",
                                    use_object_plane=False)
    handle = _DeploymentLike(worker)
    client = tprefill.PrefillClient(handle)
    assert client._kind == "deployment"
    tokens = list(range(1, 20))
    got = client.submit(tokens, 0, tprefill.SamplingParams()).poll()
    want = tprefill._resolve_payload(worker.prefill(tokens, 0, 0.0, 1.0, 0))
    assert handle.calls == ["prefill"]
    assert got[2] == want[2]
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


# ---------------------------------------------------------------------------
# Prefill through a PrefillWorker actor of the port's runtime, with and
# without the object plane.  These come last: the module's cluster is up
# from the first of them on, and an in-process worker left at
# use_object_plane=None would take the plane whenever a cluster is up.
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def cluster():
    import ray_tpu_torch

    ray_tpu_torch.init(num_cpus=2, num_gpus=0,
                       object_store_memory=256 * 1024**2)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def _converted_worker_class():
    """A PrefillWorker that serves the converted JAX weights.  Defined in a
    function, so cloudpickle ships it by value to the actor's process."""

    class ConvertedPrefillWorker(tprefill.PrefillWorker):
        def __init__(self, state_dict, *args, **kw):
            super().__init__(*args, **kw)
            self._model.load_state_dict(state_dict)

    return ConvertedPrefillWorker


@pytest.mark.parametrize("plane", [False, True],
                         ids=["actor", "actor_object_plane"])
def test_actor_kind_gives_the_local_kind_tokens_and_jax_greedy(
        models, cluster, plane):
    """The engine in the driver, the worker an actor on device="cpu": the
    sampled and greedy tokens, the counts and the wire bytes equal the
    in-process worker's, the greedy tokens equal the JAX engine's, and no
    page leaks.  With the object plane the payload carries refs to the
    page arrays in place of the arrays."""
    jmodel, params, tmodel = models
    _, jw = _workers(tmodel)
    tw = tprefill.PrefillWorker("gpt2", {"dtype": torch.float32}, 0,
                                page_size=8, device="cpu",
                                use_object_plane=False)
    tw._model.load_state_dict(tmodel.state_dict())
    actor_cls = cluster.remote(num_cpus=1)(_converted_worker_class())
    actor = actor_cls.remote(tmodel.state_dict(), "gpt2",
                             {"dtype": torch.float32}, 0, page_size=8,
                             device="cpu", use_object_plane=plane)
    kw = dict(max_slots=2, page_size=8, max_ctx=64, prefix_cache=True,
              prefill_min_tokens=8)
    rng = np.random.default_rng(29)
    shared = list(map(int, rng.integers(0, 512, size=16)))
    p1 = shared + [2, 4, 6, 8, 10, 12, 14, 1]
    p2 = shared + [9] * 12
    out, stats = {}, {}
    for kind, target in (("local", tw), ("actor", actor)):
        eng = LLMEngine(tmodel, device="cpu", prefill=target, **kw)
        try:
            out[kind] = (eng.result(eng.submit(p1, 6, sampling=SP),
                                    timeout=120),
                         eng.result(eng.submit(p2, 6), timeout=120))
            stats[kind] = eng.stats()
        finally:
            eng.close()
    jeng = jengine.LLMEngine(jmodel, params, prefill=jw, **kw)
    try:
        jeng.result(jeng.submit(p1, 6), timeout=120)
        jo2 = jeng.result(jeng.submit(p2, 6), timeout=120)
    finally:
        jeng.close()
    assert out["actor"] == out["local"] and out["actor"][1] == jo2
    for key in ("prefill_offloaded", "wire_bytes", "wire_fp32_bytes",
                "prefix_hit_pages", "prefill_tokens_saved"):
        assert stats["actor"][key] == stats["local"][key], key
    assert stats["actor"]["prefill_offloaded"] == 2
    assert stats["actor"]["pages_in_use"] == 0
    payload = cluster.get(actor.prefill.remote(p1, 8), timeout=120)
    assert ("refs" in payload) == plane and ("k" in payload) != plane
    k, v, nxt, _ = tprefill._resolve_payload(payload)
    want = tw.prefill(p1, 8)
    assert nxt == want["next_token"]
    assert k.tobytes() == want["k"].tobytes()
    assert v.tobytes() == want["v"].tobytes()
    cluster.kill(actor)
