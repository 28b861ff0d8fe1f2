"""Local mode: every task and actor call executes inline in the driver.

Reference: ray.init(local_mode=True) (python/ray/_private/worker.py —
the LocalModeManager executing task specs synchronously).  The debugging
contract: no subprocesses, no serialization, plain stack traces straight
into user code, pdb works.  Exceptions raised by tasks propagate to
``get`` as the ORIGINAL exception (not a wrapped TaskError) — the point
of local mode is an undisturbed debugger.

Scope: tasks, actors (incl. named), put/get/wait, nested calls.  Cluster
features that require real processes (placement groups as constraints,
TPU partitioning, spilling) are accepted and ignored, matching the
reference's local-mode behavior.

Copied from ``ray_tpu/_private/local_mode.py`` (the JAX package).
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ray_tpu_torch._private.ids import ActorID, JobID, ObjectID, WorkerID
from ray_tpu_torch.object_ref import ObjectRef


class _Stored:
    __slots__ = ("value", "error")

    def __init__(self, value=None, error: Optional[BaseException] = None):
        self.value = value
        self.error = error


class LocalModeTransport:
    """Answers the head-request ops the public API issues, locally: real
    answers where one exists (resources, named actors, KV, state), benign
    accept-and-ignore for cluster-only machinery (placement groups,
    cancel) — so any script using those APIs still debugs in local mode."""

    def __init__(self, worker: "LocalModeWorker"):
        self._w = worker
        self._kv: Dict[tuple, bytes] = {}

    def request(self, op: str, payload: dict,
                timeout: Optional[float] = None):
        import os as _os

        w = self._w
        if op == "cluster_resources":
            return {"CPU": float(_os.cpu_count() or 1),
                    "memory": 2.0 * 1024 ** 3}
        if op == "state":
            what = payload.get("what")
            if what == "actors":
                with w._lock:
                    return [{"actor_id": aid.hex(), "state": "ALIVE",
                             "name": None}
                            for aid in w._actors]
            return []
        if op == "kill_actor":
            w.kill_actor(payload["actor_id"])
            return True
        if op == "get_actor":
            return w.get_named_actor_info(payload["name"])
        if op == "kv":
            action = payload.get("action")
            key = (payload.get("ns", "default"), payload.get("key"))
            if action == "put":
                self._kv[key] = payload.get("value")
                return True
            if action == "get":
                return self._kv.get(key)
            if action == "del":
                return self._kv.pop(key, None) is not None
            if action == "keys":
                ns = payload.get("ns", "default")
                return [k for n, k in self._kv if n == ns]
        if op == "pg_ready":
            return True
        # Everything else (create_pg, remove_pg, cancel, add_ref, ...):
        # accepted and ignored — there is no cluster to configure.
        return None

    def request_oneway(self, op: str, payload: dict):
        self.request(op, payload)

    def notify(self, msg: dict):
        pass

    def close(self):
        pass


class LocalModeWorker:
    """The CoreWorker surface the public API uses, executed inline."""

    def __init__(self):
        self.worker_id = WorkerID.from_random()
        self.job_id = JobID.from_random()
        self._store: Dict[ObjectID, _Stored] = {}
        self._actors: Dict[ActorID, Any] = {}
        self._named_actors: Dict[str, ActorID] = {}
        self._lock = threading.RLock()
        self.mode = "local"
        self.transport = LocalModeTransport(self)

    # ---- object plane ----
    def put(self, value) -> ObjectRef:
        oid = ObjectID.from_random()
        with self._lock:
            self._store[oid] = _Stored(value=value)
        return ObjectRef(oid)

    def store_result(self, value=None,
                     error: Optional[BaseException] = None) -> ObjectRef:
        oid = ObjectID.from_random()
        with self._lock:
            self._store[oid] = _Stored(value=value, error=error)
        return ObjectRef(oid)

    def get(self, refs, timeout: Optional[float] = None):
        single = isinstance(refs, ObjectRef)
        out = []
        for r in ([refs] if single else list(refs)):
            with self._lock:
                stored = self._store.get(r.id)
            if stored is None:
                raise KeyError(f"unknown object {r.id} (local mode)")
            if stored.error is not None:
                raise stored.error
            out.append(stored.value)
        return out[0] if single else out

    def wait(self, refs: Sequence[ObjectRef], num_returns: int = 1,
             timeout: Optional[float] = None, fetch_local: bool = True
             ) -> Tuple[List[ObjectRef], List[ObjectRef]]:
        refs = list(refs)
        if num_returns > len(refs):
            raise ValueError("num_returns > len(refs)")
        # Everything is already computed inline.
        return refs[:num_returns], refs[num_returns:]

    # ---- execution ----
    def run_function(self, fn, args, kwargs, num_returns: int = 1):
        args = [self._resolve(a) for a in args]
        kwargs = {k: self._resolve(v) for k, v in kwargs.items()}
        try:
            out = fn(*args, **kwargs)
            if num_returns not in (0, 1):
                # Same contract as cluster mode: the return count must
                # match the declaration — surfacing the mismatch at get()
                # keeps local-mode-tested code deployable.
                out = list(out)
                if len(out) != num_returns:
                    raise ValueError(
                        f"task declared num_returns={num_returns} but "
                        f"returned {len(out)} values")
        except BaseException as e:  # noqa: BLE001 — stored, raised at get
            if num_returns == 1:
                return self.store_result(error=e)
            return [self.store_result(error=e) for _ in range(num_returns)]
        if num_returns == 0:
            return None
        if num_returns == 1:
            return self.store_result(out)
        return [self.store_result(v) for v in out]

    def create_actor(self, cls, args, kwargs, name: Optional[str] = None):
        args = [self._resolve(a) for a in args]
        kwargs = {k: self._resolve(v) for k, v in kwargs.items()}
        instance = cls(*args, **kwargs)
        actor_id = ActorID.from_random()
        with self._lock:
            self._actors[actor_id] = instance
            if name:
                if name in self._named_actors:
                    raise ValueError(f"actor name {name!r} already taken")
                self._named_actors[name] = actor_id
        return actor_id

    def call_actor(self, actor_id: ActorID, method: str, args, kwargs,
                   num_returns: int = 1):
        with self._lock:
            instance = self._actors.get(actor_id)
        if instance is None:
            from ray_tpu_torch import exceptions as exc

            return self.store_result(
                error=exc.ActorDiedError("actor killed (local mode)"))
        return self.run_function(getattr(instance, method), args, kwargs,
                                 num_returns)

    def kill_actor(self, actor_id: ActorID):
        with self._lock:
            self._actors.pop(actor_id, None)
            for name, aid in list(self._named_actors.items()):
                if aid == actor_id:
                    del self._named_actors[name]

    def get_named_actor(self, name: str) -> ActorID:
        with self._lock:
            aid = self._named_actors.get(name)
        if aid is None:
            raise ValueError(f"no actor named {name!r} (local mode)")
        return aid

    def get_named_actor_info(self, name: str) -> dict:
        """get_actor() payload matching the head's shape (actor id + a
        creation-spec shim carrying method names from the CLASS, like the
        cluster creation path)."""
        from types import SimpleNamespace

        with self._lock:
            aid = self._named_actors.get(name)
            if aid is None:
                raise ValueError(f"no actor named {name!r} (local mode)")
            inst = self._actors[aid]
        cls = type(inst)
        methods = [n for n in dir(cls)
                   if callable(getattr(cls, n, None))
                   and not n.startswith("__")]
        return {"actor_id": aid,
                "creation_spec": SimpleNamespace(
                    actor_method_names=methods,
                    name=f"{cls.__name__}.__init__")}

    def _resolve(self, v):
        if isinstance(v, ObjectRef):
            return self.get(v)
        return v

    # ---- misc surface ----
    def add_local_ref(self, oid: ObjectID, owner_addr=None):
        """ObjectRef lifetime hooks: local mode keeps values until
        shutdown (debugging runs are short; matches the reference's
        local-mode no-GC behavior)."""

    def remove_local_ref(self, oid: ObjectID, owner_addr=None):
        pass

    def shutdown(self):
        with self._lock:
            self._store.clear()
            self._actors.clear()
            self._named_actors.clear()
