"""Serving plane of the port (counterpart of ``ray_tpu/serve``).

- The Serve control plane, copied from the JAX package: ``@deployment``
  and ``run`` build replica actor sets on the port's runtime,
  ``DeploymentHandle`` routes to them, a stdlib HTTP proxy forwards JSON
  bodies to handles, the controller autoscales replicas with the
  reference's formula (``calculate_desired_num_replicas``), ``@batch``
  collects concurrent calls into one, and ``ingress`` serves an ASGI app.
- The continuous-batching engine with a paged KV cache (speculative
  decoding, the local prefix cache, disaggregated prefill, hot weight
  swaps and rollouts), its naive reference, ``build_model`` (GPT-2 and
  the Llama family), seeded sampling, the prefix-cache keys and the
  prefill worker.  ``LLMServer`` is the deployment callable that hosts
  one engine per replica; ``generate_many`` is its client over the
  object plane.

``PrefixDirectory`` (the cluster prefix cache) is not ported yet: it
waits for multi-host (ROADMAP Queue 1 item 1a).

The engine, the prefill worker and the sampler import torch, so they
load on first use: a replica of a plain deployment starts without torch.
"""
from ray_tpu_torch.serve.api import (  # noqa: F401
    Deployment,
    DeploymentHandle,
    delete,
    deployment,
    get_deployment_handle,
    run,
    shutdown,
    start_http_proxies,
    start_http_proxy,
)
from ray_tpu_torch.serve.asgi import ASGIAdapter, ingress  # noqa: F401
from ray_tpu_torch.serve.autoscaling import (  # noqa: F401
    calculate_desired_num_replicas,
)
from ray_tpu_torch.serve.batching import batch  # noqa: F401
from ray_tpu_torch.serve.prefix_cache import (  # noqa: F401
    PrefixCacheLocal,
    affinity_key,
    create_directory,
)

_LLM_EXPORTS = ("LLMEngine", "LLMServer", "NaiveLM", "PagePool",
                "build_model", "cache_namespace_for", "generate_many")
_PREFILL_EXPORTS = ("PrefillWorker", "PrefillClient")


def __getattr__(name):
    if name in _LLM_EXPORTS:
        from ray_tpu_torch.serve import llm_engine

        return getattr(llm_engine, name)
    if name in _PREFILL_EXPORTS:
        from ray_tpu_torch.serve import prefill

        return getattr(prefill, name)
    if name == "SamplingParams":
        from ray_tpu_torch.serve.sampling import SamplingParams

        return SamplingParams
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
