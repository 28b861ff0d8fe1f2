"""Typed errors of the port: the serving engine's, and the task/actor
runtime's (``RayTpuError`` and below, copied from ``ray_tpu/exceptions.py``
with the class names kept; the port may not import the JAX package)."""
from __future__ import annotations

import traceback
from typing import Optional


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


class RayTpuError(RayTpuTorchError):
    """Base for all errors of the runtime."""


class TaskError(RayTpuError):
    """A task raised an exception; re-raised at `get()` on the caller.

    Carries the remote traceback string (reference: RayTaskError,
    python/ray/exceptions.py)."""

    def __init__(self, cause_cls_name: str, cause: Optional[BaseException], tb_str: str, task_name: str = ""):
        self.cause = cause
        self.cause_cls_name = cause_cls_name
        self.tb_str = tb_str
        self.task_name = task_name
        super().__init__(f"task {task_name!r} failed with {cause_cls_name}:\n{tb_str}")

    @classmethod
    def from_exception(cls, e: BaseException, task_name: str = "") -> "TaskError":
        return cls(type(e).__name__, e, traceback.format_exc(), task_name)

    def __reduce__(self):
        # The cause itself may not be picklable; ship the name + traceback.
        return (TaskError, (self.cause_cls_name, None, self.tb_str, self.task_name))


class WorkerCrashedError(RayTpuError):
    """The worker process executing the task died unexpectedly."""


class ActorDiedError(RayTpuError):
    """The actor is dead (crashed, killed, or out of restarts)."""

    def __init__(self, msg="the actor is dead"):
        super().__init__(msg)


class ActorUnavailableError(RayTpuError):
    """The actor is temporarily unavailable (restarting)."""


class ObjectLostError(RayTpuError):
    """Object was evicted/lost and could not be reconstructed from lineage."""


class GetTimeoutError(RayTpuError, TimeoutError):
    """`get(timeout=...)` expired."""


class RpcTimeoutError(RayTpuError, TimeoutError):
    """A control-plane RPC exceeded its deadline (the reply never arrived
    within the transport's budget — lost frame, dead peer, or a wedged
    head).  Distinct from :class:`GetTimeoutError`: that one means the
    *object* wasn't ready in time; this one means the *channel* gave no
    answer at all, so retries/failover are the right reaction."""

    def __init__(self, op: str = "", elapsed: float = 0.0,
                 timeout: Optional[float] = None, attempts: int = 1):
        self.op = op
        self.elapsed = elapsed
        self.timeout = timeout
        self.attempts = attempts
        bound = f"{timeout:.3f}s" if timeout is not None else "unbounded"
        super().__init__(
            f"RPC {op!r} got no reply within its deadline "
            f"(elapsed {elapsed:.3f}s, budget {bound}, "
            f"{attempts} attempt(s))")

    def __reduce__(self):
        return (RpcTimeoutError,
                (self.op, self.elapsed, self.timeout, self.attempts))


class HeadConnectionError(RayTpuError, ConnectionError):
    """Connecting/registering with the head failed.  Carries the head
    address, how long we tried, and whether the TCP socket ever connected
    (separates "nothing is listening" from "the head accepted the socket
    but never completed registration")."""

    def __init__(self, address: str, elapsed: float,
                 socket_connected: bool, detail: str = ""):
        self.address = address
        self.elapsed = elapsed
        self.socket_connected = socket_connected
        phase = ("socket connected but registration never completed"
                 if socket_connected else "TCP connection failed")
        msg = (f"could not join head at {address}: {phase} "
               f"after {elapsed:.1f}s")
        if detail:
            msg += f" ({detail})"
        super().__init__(msg)

    def __reduce__(self):
        return (HeadConnectionError,
                (self.address, self.elapsed, self.socket_connected))


class ObjectStoreFullError(RayTpuError):
    pass


class RuntimeEnvSetupError(RayTpuError):
    pass


class OutOfMemoryError(RayTpuError):
    """Worker was killed by the memory monitor under host memory pressure
    and the task's retry budget is exhausted (reference:
    src/ray/common/memory_monitor.h:52 + worker_killing_policy.h:33)."""


class PlacementGroupSchedulingError(RayTpuError):
    """Placement group could not be reserved (infeasible or timeout)."""
