"""``LLMServer`` as a Serve deployment of the port, against the JAX
package, on a tiny fp32 GPT-2 (vocab 64) with one module cluster.

- After ``swap_weights`` of a ref to ``gpt2_params_from_jax(params)`` on
  every replica, ``generate_many``'s greedy tokens equal the JAX
  ``NaiveLM``'s on ``params`` (prompts in several affinity groups, two
  replicas);
- streamed chunks of a prompt sent as a ref concatenate to the same
  tokens;
- ``autoscale_metric`` is in-flight work per decode slot;
- prefill through a ``PrefillWorker`` deployment gives the colocated
  engine's tokens;
- the engine's ``serve_*`` metric names are the JAX engine's, and they
  reach ``prometheus_text()`` from a replica;
- ``generate_many`` records a ``serve.generate_many`` span when tracing
  is on.

Every ``get`` has a timeout; torch runs on one intra-op thread."""
from __future__ import annotations

import time
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.models import GPT2 as JGPT2
from ray_tpu.models import GPT2Config as JConfig
from ray_tpu.serve import llm_engine as jengine
from ray_tpu_torch import serve
from ray_tpu_torch.models.convert import gpt2_params_from_jax
from ray_tpu_torch.serve import (
    LLMEngine,
    LLMServer,
    PrefillWorker,
    build_model,
    generate_many,
)
from ray_tpu_torch.serve import llm_engine as tengine
from ray_tpu_torch.serve.prefix_cache import affinity_key

T = 120  # seconds: the bound of every get
VOCAB = 64
SHAPE = dict(vocab_size=VOCAB, num_layers=2, hidden_size=32, num_heads=2,
             max_position_embeddings=64)
KW = {"tiny": True, "dtype": torch.float32, **SHAPE}
ENGINE = dict(max_slots=4, page_size=8, max_ctx=64)
NEW = 8


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cluster():
    import ray_tpu_torch

    ray_tpu_torch.init(num_cpus=4, object_store_memory=128 * 1024**2)
    try:
        yield ray_tpu_torch
    finally:
        serve.shutdown()
        ray_tpu_torch.shutdown()


@pytest.fixture(scope="module")
def jax_lm():
    """(JAX model, params of another seed than the replicas' own)."""
    jmodel = JGPT2(JConfig.tiny(dtype=jnp.float32, **SHAPE))
    params = jmodel.init(jax.random.PRNGKey(1),
                         jnp.zeros((1, 8), jnp.int32))["params"]
    return jmodel, params


@pytest.fixture(scope="module")
def llm(cluster):
    """Two LLMServer replicas on the CPU."""
    dep = serve.deployment(LLMServer, name="llm", num_replicas=2)
    handle = serve.run(dep.bind("gpt2", KW, 0, device="cpu", **ENGINE))
    yield handle
    serve.delete("llm")


def _prompts():
    rng = np.random.default_rng(0)
    shared = rng.integers(0, VOCAB, size=20).tolist()
    prompts = [shared + rng.integers(0, VOCAB, size=n).tolist()
               for n in (1, 5)]
    prompts += [rng.integers(0, VOCAB, size=n).tolist() for n in (3, 9, 30)]
    return prompts


def _replicas():
    return list(serve.api._deployments["llm"]._replicas)


def test_generate_many_after_a_swap_to_jax_weights(cluster, llm, jax_lm):
    rt = cluster
    jmodel, params = jax_lm
    ref = rt.put(gpt2_params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                              params)))
    # The ref rides inside the call's arguments: each replica's engine
    # resolves it at its next token boundary.
    assert rt.get([r.handle_request.remote("swap_weights", (ref, 1), {})
                   for r in _replicas()], timeout=T) == [1, 1]
    prompts = _prompts()
    assert len({affinity_key(p) for p in prompts}) >= 2
    got = generate_many(llm, prompts, NEW, timeout=T)
    naive = jengine.NaiveLM(jmodel, params, width=64)
    assert got == [naive.generate(p, NEW) for p in prompts]
    stats = rt.get([r.handle_request.remote("stats", (), {})
                    for r in _replicas()], timeout=T)
    assert [s["weight_version"] for s in stats] == [1, 1]
    assert sum(s["completed"] for s in stats) >= len(prompts)


def test_streamed_chunks_concatenate_to_the_tokens(cluster, llm):
    rt = cluster
    replica = _replicas()[0]
    prompt = _prompts()[2]
    want = rt.get(replica.handle_request.remote(
        "__call__", ({"tokens": prompt, "max_new_tokens": NEW},), {}),
        timeout=T)["tokens"]
    rid = rt.get(replica.handle_request.remote(
        "submit_stream", (rt.put(np.asarray(prompt, np.int32)), NEW), {}),
        timeout=T)
    chunks = []
    while True:
        chunk = rt.get(replica.handle_request.remote(
            "next_chunk", (rid,), {}), timeout=T)
        if chunk is None:
            break
        chunks.append(chunk)
    assert chunks and sum(chunks, []) == want


def test_autoscale_metric_is_in_flight_work_per_slot(cluster, llm):
    rt = cluster
    assert rt.get(llm.method("autoscale_metric").remote(), timeout=T) == 0.0
    server = LLMServer("gpt2", KW, 0, device="cpu", start=False, **ENGINE)
    try:
        for n in range(6):
            server.engine.submit([1, 2, 3], 2)
            st = server.stats()
            want = (st["active"] + st["pending"]
                    + st["prefill_inflight"]) / ENGINE["max_slots"]
            assert server.autoscale_metric() == want == (n + 1) / 4
    finally:
        server.drain()


def test_prefill_through_a_deployment_equals_colocated(cluster):
    handle = serve.run(serve.deployment(PrefillWorker, name="prefill").bind(
        "gpt2", KW, 0, page_size=ENGINE["page_size"], device="cpu"))
    prompts = _prompts()
    outs = {}
    for tag, kw in (("colocated", {}),
                    ("deployment", {"prefill": handle,
                                    "prefill_min_tokens": 8})):
        eng = LLMEngine(build_model("gpt2", KW, 0, "cpu"), device="cpu",
                        **ENGINE, **kw)
        try:
            rids = [eng.submit(p, NEW) for p in prompts]
            outs[tag] = [eng.result(r, timeout=T) for r in rids]
            outs[tag + "_stats"] = eng.stats()
        finally:
            eng.close()
    serve.delete("prefill")
    assert outs["deployment"] == outs["colocated"]
    assert outs["deployment_stats"]["prefill_offloaded"] >= 3
    assert outs["colocated_stats"]["prefill_offloaded"] == 0


def _metric_names(engine_cls):
    stub = types.SimpleNamespace(_metrics=None)
    engine_cls._ensure_metrics(stub)
    return {m.name for m in stub._metrics.values()}


def test_serve_metric_names_are_the_jax_engines(cluster, llm):
    from ray_tpu_torch.util.metrics import prometheus_text

    names = _metric_names(tengine.LLMEngine)
    assert names == _metric_names(jengine.LLMEngine)
    assert all(n.startswith("serve_") for n in names)
    # A replica's engine exports every ~2 s of work: a request, a pause,
    # another request (whose first iteration flushes the first's counts).
    req = {"tokens": [1, 2, 3], "max_new_tokens": NEW}
    cluster.get(llm.remote(req), timeout=T)
    time.sleep(2.2)
    cluster.get(llm.remote(req), timeout=T)
    exported = {line.split("{")[0].split(" ")[0]
                for line in prometheus_text().splitlines()
                if line.startswith("serve_")}
    # Histograms export their count; the prefix-cache and speculative
    # metrics stay unset without a cache or a draft.
    want = {n for n in names
            if n not in ("serve_prefix_hit_pages", "serve_spec_acceptance",
                         "serve_queue_wait_s")} | {"serve_queue_wait_s_count"}
    assert want <= exported, want - exported


def test_generate_many_records_a_span_when_tracing_is_on(cluster, llm):
    from ray_tpu_torch.util import tracing

    tracing.pop_local_spans()
    tracing.enable_tracing()
    try:
        out = generate_many(llm, _prompts()[:2], 2, timeout=T)
        spans = [s for s in tracing.pop_local_spans()
                 if s["name"] == "serve.generate_many"]
    finally:
        tracing.disable_tracing()
    assert [len(o) for o in out] == [2, 2]
    assert len(spans) == 1 and spans[0]["attributes"] == {"requests": 2}
