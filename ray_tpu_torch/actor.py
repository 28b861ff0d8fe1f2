"""Actor API: ActorClass / ActorHandle / ActorMethod.

Reference: python/ray/actor.py (ActorClass :377, ActorHandle :1021,
ActorMethod :92).  Creation is routed through the GCS actor manager
(head.req_create_actor), method calls go directly to the actor's dedicated
worker process through the head's connection router.

Copied from ``ray_tpu/actor.py`` (the JAX package).
"""
from __future__ import annotations

import hashlib
from typing import Any, Dict, List, Optional

import cloudpickle

from ray_tpu_torch._private.ids import ActorID, TaskID
from ray_tpu_torch._private.task_spec import TaskSpec, TaskType
from ray_tpu_torch.remote_function import _resources_from_options, _strategy_from_options


def _normalize_renv(renv, worker):
    """Package local py_modules into pkg:// URIs at actor creation (the
    default path is already normalized at connect; this covers per-call
    .options(runtime_env=...))."""
    if not renv or not renv.get("py_modules"):
        return renv
    from ray_tpu_torch._private.runtime_env_pkg import normalize_py_modules

    return normalize_py_modules(renv, worker.transport)


class ActorMethod:
    def __init__(self, handle: "ActorHandle", name: str,
                 options: Optional[Dict[str, Any]] = None):
        self._handle = handle
        self._name = name
        self._options = options or {}
        self._qual_name = f"{handle._class_name}.{name}"

    def options(self, **kw) -> "ActorMethod":
        merged = dict(self._options)
        merged.update(kw)
        return ActorMethod(self._handle, self._name, merged)

    def remote(self, *args, **kwargs):
        return self._handle._invoke(self._name, args, kwargs, self._options,
                                    self._qual_name)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"actor method {self._name} cannot be called directly; "
            f"use .{self._name}.remote()")


class ActorHandle:
    def __init__(self, actor_id: ActorID, method_names: List[str],
                 class_name: str = "Actor", max_task_retries: int = 0):
        import collections

        self._actor_id = actor_id
        self._method_names = list(method_names)
        self._class_name = class_name
        self._max_task_retries = max_task_retries
        # Driver-side pins for promoted large-literal args (creation args
        # live for the handle's lifetime; zero-return calls keep a
        # bounded window — see worker.make_args).
        self._arg_holds: collections.deque = collections.deque(maxlen=32)

    @property
    def actor_id(self) -> ActorID:
        return self._actor_id

    def _invoke(self, method_name: str, args, kwargs, options: Dict[str, Any],
                qual_name: Optional[str] = None):
        from ray_tpu_torch._private.ids import fast_task_id
        from ray_tpu_torch._private.worker import global_worker

        if global_worker is None:
            raise RuntimeError("ray_tpu_torch.init() has not been called")
        if getattr(global_worker, "mode", None) == "local":
            return global_worker.call_actor(
                self._actor_id, method_name, args, kwargs,
                options.get("num_returns", 1))
        holds: list = []
        if args or kwargs:
            task_args, task_kwargs = global_worker.make_args(args, kwargs,
                                                             holds=holds)
        else:
            task_args, task_kwargs = [], {}
        num_returns = options.get("num_returns", 1) if options else 1
        spec = TaskSpec(
            task_id=fast_task_id(),
            job_id=global_worker.job_id,
            task_type=TaskType.ACTOR_TASK,
            name=qual_name or f"{self._class_name}.{method_name}",
            method_name=method_name,
            args=task_args,
            kwargs=task_kwargs,
            num_returns=num_returns,
            actor_id=self._actor_id,
            max_retries=options.get("max_task_retries",
                                    self._max_task_retries),
            retry_exceptions=bool(options.get("retry_exceptions", False)),
        )
        refs = global_worker.submit_actor_task(spec)
        if num_returns == 0:
            if holds:
                # No result ref to pin the promoted args to: park them on
                # the handle (bounded) so they outlive the call window.
                self._arg_holds.append(holds)
            return None
        if holds:
            for r in refs:
                r._hold_args = holds
        return refs[0] if num_returns == 1 else refs

    def __getattr__(self, name: str) -> ActorMethod:
        if name.startswith("_"):
            raise AttributeError(name)
        if name not in self._method_names:
            raise AttributeError(
                f"actor {self._class_name} has no method {name!r}")
        m = ActorMethod(self, name)
        # Cache on the instance: repeated handle.method lookups are on the
        # submission hot path (not serialized — __reduce__ rebuilds from
        # ctor args, so caches never travel).
        self.__dict__[name] = m
        return m

    def __repr__(self):
        return f"ActorHandle({self._class_name}, {self._actor_id.hex()[:12]})"

    def __reduce__(self):
        return (ActorHandle, (self._actor_id, self._method_names,
                              self._class_name, self._max_task_retries))

    def __hash__(self):
        return hash(self._actor_id)

    def __eq__(self, other):
        return isinstance(other, ActorHandle) and other._actor_id == self._actor_id


class ActorClass:
    def __init__(self, cls, options: Optional[Dict[str, Any]] = None):
        self._cls = cls
        self._options = options or {}
        # Pickled lazily on first .remote(): decoration runs mid-module-import,
        # and pickling then would snapshot the module globals before
        # later-defined helpers exist (cloudpickle captures by-value classes'
        # globals at dump time).
        self._blob_cache: Optional[bytes] = None
        self._hash_cache: Optional[bytes] = None
        self._method_names = [
            n for n in dir(cls)
            if callable(getattr(cls, n, None)) and not n.startswith("__")
        ]
        self.__name__ = getattr(cls, "__name__", "Actor")

    @property
    def _blob(self) -> bytes:
        if self._blob_cache is None:
            self._blob_cache = cloudpickle.dumps(self._cls)
            self._hash_cache = hashlib.sha256(self._blob_cache).digest()
        return self._blob_cache

    @property
    def _hash(self) -> bytes:
        self._blob
        return self._hash_cache

    def options(self, **kw) -> "ActorClass":
        merged = dict(self._options)
        merged.update(kw)
        ac = ActorClass.__new__(ActorClass)
        ac._cls = self._cls
        ac._options = merged
        ac._blob_cache = self._blob_cache
        ac._hash_cache = self._hash_cache
        ac._method_names = self._method_names
        ac.__name__ = self.__name__
        return ac

    def remote(self, *args, **kwargs) -> ActorHandle:
        from ray_tpu_torch._private.worker import global_worker

        if global_worker is None:
            raise RuntimeError("ray_tpu_torch.init() has not been called")
        opts = self._options
        if getattr(global_worker, "mode", None) == "local":
            actor_id = global_worker.create_actor(
                self._cls, args, kwargs, name=opts.get("name"))
            return ActorHandle(actor_id, self._method_names, self.__name__)
        holds: list = []
        task_args, task_kwargs = global_worker.make_args(args, kwargs,
                                                         holds=holds)
        actor_id = ActorID.of(global_worker.job_id)
        spec = TaskSpec(
            task_id=TaskID.from_random(),
            job_id=global_worker.job_id,
            task_type=TaskType.ACTOR_CREATION,
            name=self.__name__ + ".__init__",
            func_blob=self._blob,
            func_hash=self._hash,
            args=task_args,
            kwargs=task_kwargs,
            num_returns=0,
            resources=_resources_from_options(opts),
            scheduling_strategy=_strategy_from_options(opts),
            max_retries=0,
            actor_id=actor_id,
            max_restarts=opts.get("max_restarts", 0),
            max_task_retries=opts.get("max_task_retries", 0),
            max_concurrency=opts.get("max_concurrency", 1),
            actor_name=opts.get("name"),
            actor_method_names=self._method_names,
            # Explicit per-call values win even when falsy; only
            # None/absent falls back to the job defaults.
            namespace=(opts.get("namespace")
                       if opts.get("namespace") is not None
                       else getattr(global_worker, "namespace", None)),
            lifetime=opts.get("lifetime"),
            runtime_env=_normalize_renv(
                opts.get("runtime_env")
                if opts.get("runtime_env") is not None
                else getattr(global_worker, "default_runtime_env", None),
                global_worker),
        )
        spec.owner_worker_id = global_worker.worker_id
        spec.parent_task_id = global_worker.current_task_id()
        global_worker.transport.request("create_actor", {"spec": spec})
        handle = ActorHandle(actor_id, self._method_names, self.__name__,
                             max_task_retries=spec.max_task_retries)
        if holds:
            # Creation args promoted to put objects stay pinned for the
            # handle's lifetime: the creation task may execute (and even
            # re-execute on actor restart) long after this returns.
            handle._arg_holds.append(holds)
        return handle

    def __call__(self, *a, **kw):
        raise TypeError(
            f"actor class {self.__name__} cannot be instantiated directly; "
            f"use {self.__name__}.remote()")
