"""Typed errors of the serving engine (copies of the ``ray_tpu``
counterparts, which the port may not import)."""


class RayTpuTorchError(Exception):
    """Base class of the port's errors."""


class EngineClosedError(RayTpuTorchError):
    """The LLM decode engine was closed (replica drain / fatal engine
    error) with this request still pending or in flight."""


class KVPoolExhaustedError(RayTpuTorchError):
    """The engine's paged KV cache cannot hold this request: it needs
    more pages than the pool's capacity (or the pool is exhausted with
    nothing left to preempt).  Raise max_ctx/num_pages or shorten the
    request."""
