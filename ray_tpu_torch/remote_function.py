"""@remote functions (reference: python/ray/remote_function.py:35).

Copied from ``ray_tpu/remote_function.py`` (the JAX package).
"""
from __future__ import annotations

import hashlib
from typing import Any, Dict, Optional

import cloudpickle

from ray_tpu_torch._private.ids import TaskID
from ray_tpu_torch._private.task_spec import SchedulingStrategy, TaskSpec, TaskType


def _resources_from_options(opts: Dict[str, Any],
                            default_num_cpus: float = 1.0) -> Dict[str, float]:
    resources = dict(opts.get("resources") or {})
    num_cpus = opts.get("num_cpus")
    resources["CPU"] = float(default_num_cpus if num_cpus is None else num_cpus)
    if resources["CPU"] == 0:
        resources.pop("CPU")
    num_gpus = opts.get("num_gpus")
    if num_gpus:
        resources["GPU"] = float(num_gpus)
    if opts.get("memory"):
        resources["memory"] = float(opts["memory"])
    return resources


def _strategy_from_options(opts: Dict[str, Any]) -> SchedulingStrategy:
    st = opts.get("scheduling_strategy")
    if st is None:
        return SchedulingStrategy()
    if isinstance(st, str):
        return SchedulingStrategy(kind=st)
    # Duck-typed: util.scheduling_strategies classes.
    if hasattr(st, "placement_group"):
        pg = st.placement_group
        return SchedulingStrategy(
            kind="PLACEMENT_GROUP",
            placement_group_id=pg.id,
            bundle_index=getattr(st, "placement_group_bundle_index", -1),
            capture_child_tasks=getattr(
                st, "placement_group_capture_child_tasks", False),
        )
    if hasattr(st, "node_id"):
        from ray_tpu_torch._private.ids import NodeID

        nid = st.node_id
        if isinstance(nid, str):
            nid = NodeID.from_hex(nid)
        return SchedulingStrategy(kind="NODE_AFFINITY", node_id=nid,
                                  soft=getattr(st, "soft", False))
    raise TypeError(f"bad scheduling strategy {st!r}")


class RemoteFunction:
    def __init__(self, fn, options: Optional[Dict[str, Any]] = None):
        self._function = fn
        self._options = options or {}
        # Lazy pickle: see ActorClass — dumping at decoration time snapshots
        # incomplete module globals.
        self._blob_cache: Optional[bytes] = None
        self._hash_cache: Optional[bytes] = None
        # (name, resources, strategy, ...) resolved once per instance; the
        # resources/strategy objects are shared across submitted specs and
        # treated as read-only downstream.
        self._call_cache = None
        self.__name__ = getattr(fn, "__name__", "remote_fn")

    @property
    def _blob(self) -> bytes:
        if self._blob_cache is None:
            self._blob_cache = cloudpickle.dumps(self._function)
            self._hash_cache = hashlib.sha256(self._blob_cache).digest()
        return self._blob_cache

    @property
    def _hash(self) -> bytes:
        self._blob
        return self._hash_cache

    def options(self, **kw) -> "RemoteFunction":
        merged = dict(self._options)
        merged.update(kw)
        rf = RemoteFunction.__new__(RemoteFunction)
        rf._function = self._function
        rf._options = merged
        rf._blob_cache = self._blob_cache
        rf._hash_cache = self._hash_cache
        rf._call_cache = None
        rf.__name__ = self.__name__
        return rf

    def remote(self, *args, **kwargs):
        from ray_tpu_torch._private.ids import fast_task_id
        from ray_tpu_torch._private.worker import global_worker

        if global_worker is None:
            raise RuntimeError("ray_tpu_torch.init() has not been called")
        opts = self._options
        if getattr(global_worker, "mode", None) == "local":
            # local_mode: run inline, no serialization, plain stack traces
            # (reference: ray.init(local_mode=True)).
            return global_worker.run_function(
                self._function, args, kwargs, opts.get("num_returns", 1))
        holds: list = []
        if args or kwargs:
            task_args, task_kwargs = global_worker.make_args(args, kwargs,
                                                             holds=holds)
        else:
            task_args, task_kwargs = [], {}
        # Options are immutable per RemoteFunction instance: resolve the
        # resource vector / strategy / shared knobs once (submission path).
        cached = self._call_cache
        if cached is None:
            renv_opt = opts.get("runtime_env")
            if renv_opt and renv_opt.get("py_modules"):
                # Package + upload local py_modules once per RemoteFunction
                # (cached): specs must carry pkg:// URIs, not driver paths.
                from ray_tpu_torch._private.runtime_env_pkg import \
                    normalize_py_modules

                renv_opt = normalize_py_modules(renv_opt,
                                                global_worker.transport)
            cached = self._call_cache = (
                opts.get("name") or self.__name__,
                _resources_from_options(opts),
                _strategy_from_options(opts),
                opts.get("num_returns", 1),
                opts.get("max_retries", 3),
                bool(opts.get("retry_exceptions", False)),
                renv_opt,
            )
        name, resources, strategy, num_returns, max_retries, retry_exc, \
            renv = cached
        spec = TaskSpec(
            task_id=fast_task_id(),
            job_id=global_worker.job_id,
            task_type=TaskType.NORMAL,
            name=name,
            func_blob=self._blob,
            func_hash=self._hash,
            args=task_args,
            kwargs=task_kwargs,
            num_returns=num_returns,
            resources=resources,
            scheduling_strategy=strategy,
            max_retries=max_retries,
            retry_exceptions=retry_exc,
            # Explicit per-call values win even when falsy (runtime_env={}
            # deliberately clears the job default); only None/absent falls
            # back (reference: JobConfig default semantics).
            runtime_env=(renv if renv is not None
                         else getattr(global_worker, "default_runtime_env",
                                      None)),
        )
        refs = global_worker.submit_task(spec)
        if num_returns == 0:
            return None
        if holds:
            # Pin promoted large-literal args to the result refs: the head
            # pins them for the task's lifetime once it SEES the spec, but
            # the driver-side drop can otherwise race the submit itself
            # (the ref-gc drainer is a different thread).
            for r in refs:
                r._hold_args = holds
        return refs[0] if num_returns == 1 else refs

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"remote function {self.__name__} cannot be called directly; "
            f"use {self.__name__}.remote()")
