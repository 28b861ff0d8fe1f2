"""Task/actor specifications and common enums.

Equivalent of the reference's TaskSpecification (src/ray/common/task/
task_spec.h, protobuf common.proto TaskSpec) — a plain dataclass here since
the wire is in-cluster pickle; a protobuf schema can replace it when the
head moves out of process.

Copied from ``ray_tpu/_private/task_spec.py`` (the JAX package).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch._private.ids import (
    ActorID,
    JobID,
    NodeID,
    ObjectID,
    PlacementGroupID,
    TaskID,
    WorkerID,
)


# Metadata prefix marking an inline object as a serialized error result
# (reference: RAY_ERROR metadata in plasma objects).
ERROR_META = b"__rtpu_error__"


class TaskType(enum.Enum):
    NORMAL = 0
    ACTOR_CREATION = 1
    ACTOR_TASK = 2
    DRIVER = 3


class ArgKind(enum.Enum):
    VALUE = 0  # serialized inline value
    REF = 1  # ObjectID to resolve before execution


@dataclass
class TaskArg:
    kind: ArgKind
    value: Any = None  # (metadata, data) bytes for VALUE
    ref: Optional[ObjectID] = None
    # ObjectIDs nested inside a VALUE arg (e.g. a list of refs): pinned for
    # the task's lifetime like direct ref args (borrow protocol,
    # reference: contained_ids in src/ray/core_worker/reference_count.h).
    contained: List[ObjectID] = field(default_factory=list)
    # Owner address for REF args held in a caller's in-process store
    # (reference: owner_address in TaskArg, common.proto) — the executing
    # worker fetches the bytes from the owner, not the head.
    owner: Optional[dict] = None
    # oid-binary -> owner address for `contained` refs (same role).
    contained_owners: Optional[Dict[bytes, dict]] = None

    def __reduce__(self):
        return (_rebuild_arg, (self.kind.value, self.value, self.ref,
                               self.contained or None, self.owner,
                               self.contained_owners))


def _rebuild_arg(kind, value, ref, contained, owner, contained_owners):
    return TaskArg(ArgKind(kind), value, ref, contained or [], owner,
                   contained_owners)


@dataclass
class SchedulingStrategy:
    """Union of DEFAULT / SPREAD / node-affinity / placement-group strategies
    (reference: python/ray/util/scheduling_strategies.py)."""

    kind: str = "DEFAULT"  # DEFAULT | SPREAD | NODE_AFFINITY | PLACEMENT_GROUP
    node_id: Optional[NodeID] = None
    soft: bool = False
    placement_group_id: Optional[PlacementGroupID] = None
    bundle_index: int = -1
    capture_child_tasks: bool = False

    def __reduce__(self):
        # Compact wire form: specs cross a process boundary per task on the
        # hot path; the default dataclass pickle (class + field dict) costs
        # several x this tuple form.
        if self.kind == "DEFAULT" and self.node_id is None:
            return (_default_strategy, ())
        return (SchedulingStrategy,
                (self.kind, self.node_id, self.soft,
                 self.placement_group_id, self.bundle_index,
                 self.capture_child_tasks))


def _default_strategy() -> SchedulingStrategy:
    return SchedulingStrategy()


@dataclass
class TaskSpec:
    task_id: TaskID
    job_id: JobID
    task_type: TaskType
    name: str
    # Function payload: cloudpickle blob + stable hash for caching, or for
    # actor tasks the method name resolved against the actor instance.
    func_blob: Optional[bytes] = None
    func_hash: Optional[bytes] = None
    method_name: Optional[str] = None
    args: List[TaskArg] = field(default_factory=list)
    kwargs: Dict[str, TaskArg] = field(default_factory=dict)
    num_returns: int = 1
    resources: Dict[str, float] = field(default_factory=dict)
    scheduling_strategy: SchedulingStrategy = field(default_factory=SchedulingStrategy)
    max_retries: int = 3
    retry_exceptions: bool = False
    # Actor fields
    actor_id: Optional[ActorID] = None
    max_restarts: int = 0
    # Default max_retries for this actor's method calls (creation spec only;
    # reference: max_task_retries, src/ray/core_worker/task_manager.h —
    # actor tasks replay across restarts up to this many times).
    max_task_retries: int = 0
    max_concurrency: int = 1
    actor_name: Optional[str] = None
    actor_method_names: List[str] = field(default_factory=list)
    namespace: Optional[str] = None
    lifetime: Optional[str] = None  # None | "detached"
    runtime_env: Optional[dict] = None
    # Ownership / lineage
    owner_worker_id: Optional[WorkerID] = None
    parent_task_id: Optional[TaskID] = None
    # Bookkeeping filled in by the scheduler
    attempt: int = 0
    # Distributed trace context carried from the submitting thread:
    # (trace_id, parent_span_id) hex pair — see ray_tpu_torch.observability.
    trace_ctx: Optional[Tuple[str, str]] = None

    def return_ids(self) -> List[ObjectID]:
        ids = getattr(self, "_return_ids", None)
        if ids is None:
            ids = [ObjectID.for_task_return(self.task_id, i)
                   for i in range(self.num_returns)]
            self._return_ids = ids
        return ids

    def scheduling_class(self) -> Tuple:
        """Key for lease reuse: same-shaped tasks share leased workers
        (reference: SchedulingClass in src/ray/common/task/task_spec.h).
        Cached — it's recomputed on every pending-queue drain pass."""
        key = getattr(self, "_sched_class", None)
        if key is None:
            key = (tuple(sorted(self.resources.items())),
                   self.runtime_env is None)
            self._sched_class = key
        return key

    def __reduce__(self):
        return (_rebuild_spec, (
            self.task_id, self.job_id, self.task_type.value, self.name,
            self.func_blob, self.func_hash, self.method_name,
            self.args or None, self.kwargs or None, self.num_returns,
            self.resources or None, self.scheduling_strategy,
            self.max_retries, self.retry_exceptions, self.actor_id,
            self.max_restarts, self.max_task_retries, self.max_concurrency,
            self.actor_name, self.actor_method_names or None,
            self.namespace, self.lifetime, self.runtime_env,
            self.owner_worker_id, self.parent_task_id, self.attempt,
            self.trace_ctx))


def _rebuild_spec(task_id, job_id, task_type, name, func_blob, func_hash,
                  method_name, args, kwargs, num_returns, resources,
                  scheduling_strategy, max_retries, retry_exceptions,
                  actor_id, max_restarts, max_task_retries, max_concurrency,
                  actor_name, actor_method_names, namespace, lifetime,
                  runtime_env, owner_worker_id, parent_task_id, attempt,
                  trace_ctx=None):
    return TaskSpec(task_id, job_id, TaskType(task_type), name, func_blob,
                    func_hash, method_name, args or [], kwargs or {},
                    num_returns, resources or {}, scheduling_strategy,
                    max_retries, retry_exceptions, actor_id, max_restarts,
                    max_task_retries, max_concurrency, actor_name,
                    actor_method_names or [], namespace, lifetime,
                    runtime_env, owner_worker_id, parent_task_id, attempt,
                    trace_ctx)


@dataclass
class TaskResult:
    object_id: ObjectID
    inline: Optional[Tuple[bytes, bytes]] = None  # (metadata, data) for small objects
    in_store: bool = False
    size: int = 0
    meta: bytes = b""
    # Refs nested in an inline result: [(oid binary, owner addr)].  The
    # returner holds a `ret:` pin on each at its owner; the caller takes
    # over with a `res:` pin tied to the result entry's lifetime, then
    # releases the returner's pin (reference: contained-ref handover in
    # task replies, reference_count.h:543).
    contained: Optional[List[Tuple[bytes, dict]]] = None

    def __reduce__(self):
        return (TaskResult, (self.object_id, self.inline, self.in_store,
                             self.size, self.meta, self.contained))


class TaskStatus(enum.Enum):
    PENDING = 0
    SCHEDULED = 1
    RUNNING = 2
    FINISHED = 3
    FAILED = 4
