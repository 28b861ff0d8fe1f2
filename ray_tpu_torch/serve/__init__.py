"""Serving plane of the port (counterpart of ``ray_tpu/serve``): the
continuous-batching engine with a paged KV cache, its naive reference,
``build_model``, and seeded sampling."""
from ray_tpu_torch.serve.llm_engine import (  # noqa: F401
    LLMEngine,
    LLMServer,
    NaiveLM,
    PagePool,
    build_model,
)
from ray_tpu_torch.serve.sampling import SamplingParams  # noqa: F401
