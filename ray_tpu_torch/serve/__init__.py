"""Serving plane of the port (counterpart of ``ray_tpu/serve``): the
continuous-batching engine with a paged KV cache (speculative decoding,
the local prefix cache, in-process disaggregated prefill, hot weight
swaps and rollouts), its naive reference, ``build_model`` (GPT-2 and
the Llama family), seeded
sampling, the prefix-cache keys and the prefill worker."""
from ray_tpu_torch.serve.llm_engine import (  # noqa: F401
    LLMEngine,
    LLMServer,
    NaiveLM,
    PagePool,
    build_model,
    cache_namespace_for,
    generate_many,
)
from ray_tpu_torch.serve.prefill import PrefillClient, PrefillWorker  # noqa: F401
from ray_tpu_torch.serve.prefix_cache import (  # noqa: F401
    PrefixCacheLocal,
    affinity_key,
    create_directory,
)
from ray_tpu_torch.serve.sampling import SamplingParams  # noqa: F401
