"""Global Control Service: cluster metadata, actor directory, KV, pubsub,
object directory + distributed reference counting, placement groups, jobs.

TPU-native re-architecture of the reference's GCS server
(src/ray/gcs/gcs_server/gcs_server.h:77) and of the owner-side reference
counter (src/ray/core_worker/reference_count.h:61).  Two deliberate
divergences, both motivated by the target topology (one controller host plus
gang-scheduled TPU-host worker processes, not a 250-node heterogeneous
cluster):

1. The GCS runs *in the head process* behind thread-safe method calls rather
   than as a separate gRPC server.  The interface is kept message-shaped so it
   can be moved out-of-process (or to C++) without touching callers.
2. Reference counting is owner-centralized: every process keeps local
   refcounts and reports add/remove of its *root* references to the GCS,
   which holds the authoritative holder-set per object.  This trades the
   reference's fully distributed borrowing protocol for a much smaller state
   machine; lineage release and store eviction key off the same holder-set.

Storage is pluggable like the reference's StoreClient
(src/ray/gcs/store_client/store_client.h:33): in-memory default, with a
file-backed snapshot for GCS restart (redis equivalent) later.

Copied from ``ray_tpu/_private/gcs.py`` (the JAX package).
"""
from __future__ import annotations

import threading
import time
from collections import defaultdict
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

from ray_tpu_torch._private.ids import (
    ActorID,
    JobID,
    NodeID,
    ObjectID,
    PlacementGroupID,
    TaskID,
    WorkerID,
)
from ray_tpu_torch._private.task_spec import TaskSpec, TaskStatus


class ActorState:
    DEPENDENCIES_UNREADY = "DEPENDENCIES_UNREADY"
    PENDING_CREATION = "PENDING_CREATION"
    ALIVE = "ALIVE"
    RESTARTING = "RESTARTING"
    DEAD = "DEAD"


class ActorInfo:
    """Actor lifecycle record (reference FSM: gcs_actor_manager.h:280)."""

    __slots__ = (
        "actor_id", "name", "namespace", "state", "creation_spec", "node_id",
        "worker_id", "num_restarts", "max_restarts", "death_cause", "lifetime",
        "reconnect_worker_id",
        "class_name", "pending_calls", "resources_held",
    )

    def __init__(self, actor_id: ActorID, creation_spec: TaskSpec):
        self.actor_id = actor_id
        self.name = creation_spec.actor_name
        self.namespace = creation_spec.namespace or "default"
        self.state = ActorState.PENDING_CREATION
        self.creation_spec = creation_spec
        self.node_id: Optional[NodeID] = None
        self.worker_id: Optional[WorkerID] = None
        self.num_restarts = 0
        self.max_restarts = creation_spec.max_restarts
        self.death_cause: Optional[str] = None
        self.lifetime = creation_spec.lifetime
        self.class_name = creation_spec.name.replace(".__init__", "")
        # Set on snapshot-restore: the worker id this actor ran on before
        # the head died; a re-registering worker with this id re-adopts
        # the actor (head failover, see head._on_register).
        self.reconnect_worker_id = None
        self.pending_calls: List[TaskSpec] = []
        # True while the creation-task resources are allocated on a node;
        # guards against double-release on kill + worker-death paths.
        self.resources_held = False


class NodeInfo:
    __slots__ = ("node_id", "resources", "alive", "labels", "address",
                 "last_heartbeat", "stats")

    def __init__(self, node_id: NodeID, resources: Dict[str, float], labels=None):
        self.node_id = node_id
        self.resources = dict(resources)
        self.alive = True
        self.labels = labels or {}
        self.address = None
        self.last_heartbeat = time.monotonic()
        self.stats: Dict[str, float] = {}  # cpu/mem/store usage snapshot


class ObjectEntry:
    """Object directory + refcount record (owner-side state)."""

    __slots__ = (
        "object_id", "locations", "inline", "holders", "lineage_task",
        "size", "meta", "spilled_path", "lost", "segments",
        "spill", "spill_host", "contained", "partials",
    )

    def __init__(self, object_id: ObjectID):
        self.object_id = object_id
        self.locations: Set[NodeID] = set()
        self.inline: Optional[Tuple[bytes, bytes]] = None  # (meta, data) small objects
        self.holders: Set[bytes] = set()  # worker ids holding a root reference
        self.lineage_task: Optional[TaskID] = None
        self.size = 0
        # Serialization metadata, kept directory-side for objects whose store
        # lives in another process/host (cross-host pull resolutions need it).
        self.meta: Optional[bytes] = None
        self.spilled_path: Optional[str] = None
        self.lost = False
        # Non-canonical shm segment name PER LOCATION (pooled segments,
        # replica segments); a node absent here means readers on its host
        # derive the name from the object id.  Per-node because a replica
        # never shares the primary's segment name.
        self.segments: Dict[NodeID, str] = {}
        # Directory-side spill record: (path, meta, size) of an on-disk
        # copy that outlives its store (eager durability backup or an
        # eviction spill the head was told about).  ``spill_host`` is the
        # host key owning the file; None = the head's own host — the form
        # that stays valid across a head restart (host keys are per-
        # process-random, the head host is not).
        self.spill: Optional[Tuple[str, bytes, int]] = None
        self.spill_host: Optional[str] = None
        # Head-counted refs nested inside this object's value: each holds
        # a ``res:<this id>`` holder ref for as long as THIS entry lives,
        # released (cascading) when it is freed — a nested object must
        # never die while something can still reach it through the outer
        # ref (reference: contained-ref handover, reference_count.h:543).
        self.contained: Optional[List[ObjectID]] = None
        # Cooperative-broadcast partial holders: sender key (worker id /
        # node key) -> {"addr", "chunk", "total", "chunks": set, "host"}.
        # A receiver mid-pull advertises the chunk ranges it has landed
        # so concurrent pullers stripe off it instead of the owner; the
        # record dies with its process (or on its drop notify).  None
        # until the first advertisement — most objects never have one.
        self.partials: Optional[Dict[bytes, dict]] = None


class TaskEvent:
    __slots__ = ("task_id", "name", "status", "node_id", "worker_id", "start", "end",
                 "attempt", "error", "type", "parent_task_id", "trace_id")

    def __init__(self, task_id, name, status, **kw):
        self.task_id = task_id
        self.name = name
        self.status = status
        self.node_id = kw.get("node_id")
        self.worker_id = kw.get("worker_id")
        self.start = kw.get("start")
        self.end = kw.get("end")
        self.attempt = kw.get("attempt", 0)
        self.error = kw.get("error")
        self.type = kw.get("type", "NORMAL")
        self.parent_task_id = kw.get("parent_task_id")
        # Distributed trace this task belongs to (tracing plane).
        self.trace_id = kw.get("trace_id")


class GCS:
    """The cluster brain. All methods are thread-safe."""

    def __init__(self):
        self._lock = threading.RLock()
        # Tables (reference: gcs_table_storage.h typed tables)
        self.nodes: Dict[NodeID, NodeInfo] = {}
        self.actors: Dict[ActorID, ActorInfo] = {}
        self.named_actors: Dict[Tuple[str, str], ActorID] = {}
        self.jobs: Dict[JobID, dict] = {}
        self.objects: Dict[ObjectID, ObjectEntry] = {}
        self.kv: Dict[str, Dict[bytes, bytes]] = defaultdict(dict)
        self.task_events: Dict[TaskID, TaskEvent] = {}
        # Lineage: task specs kept while their outputs may need reconstruction
        # (reference: lineage in task_manager.h:90, max_lineage_bytes).
        self.lineage: Dict[TaskID, TaskSpec] = {}
        self.lineage_refcount: Dict[TaskID, int] = defaultdict(int)
        # Pubsub (reference: src/ray/pubsub) — in-process callback channels.
        self._subscribers: Dict[str, List[Callable[[Any], None]]] = defaultdict(list)

    # ---------------- persistence ----------------
    def snapshot(self) -> dict:
        """Durable cluster state (reference: gcs_table_storage.h over
        RedisStoreClient, redis_store_client.h:28 — here a picklable dict
        written to the session dir).  Scope: the tables that outlive
        processes — KV (function/class exports, workflow state), jobs, and
        detached-actor name registrations; live sockets/workers/objects are
        process state and rebuild on restart."""
        with self._lock:
            actors = {}
            for aid, info in self.actors.items():
                if info.state == ActorState.DEAD:
                    continue
                actors[aid] = {
                    "creation_spec": info.creation_spec,
                    "worker_id": (info.worker_id.binary()
                                  if info.worker_id else None),
                    "num_restarts": info.num_restarts,
                }
            # Durable spill records: on-disk object copies outlive both
            # their store AND the head process — a restarted head must be
            # able to serve restores for them (spill-record survival
            # across head kill9, the node-loss durability contract).
            # Only head-host records (spill_host None) persist: a remote
            # host's files are reachable only through its agent, which
            # re-registers and re-reports its own spill state.
            spills = {}
            for oid, e in self.objects.items():
                if e.spill is not None and e.spill_host is None:
                    spills[oid.binary()] = {
                        "path": e.spill[0], "meta": e.spill[1],
                        "size": e.spill[2]}
            return {
                "kv": {ns: dict(t) for ns, t in self.kv.items()},
                "jobs": dict(self.jobs),
                "named_actors": dict(self.named_actors),
                "actors": actors,
                "object_spills": spills,
            }

    def restore(self, snap: dict):
        from ray_tpu_torch._private.ids import WorkerID as _WorkerID

        with self._lock:
            for ns, t in snap.get("kv", {}).items():
                self.kv[ns].update(t)
            self.jobs.update(snap.get("jobs", {}))
            # Actors: restore live records as RESTARTING and remember the
            # worker each ran on — its (still-running) worker process
            # re-registers after a head restart and re-adopts the actor
            # with its state intact (head failover; reference: GCS FT over
            # redis_store_client.h + worker reconnect,
            # ray_config_def.h:58-62).  Workers that never come back are
            # reaped by the head's reconnect-window timer.
            for aid, rec in snap.get("actors", {}).items():
                if aid in self.actors:
                    continue
                info = ActorInfo(aid, rec["creation_spec"])
                info.state = ActorState.RESTARTING
                info.num_restarts = rec.get("num_restarts", 0)
                if rec.get("worker_id"):
                    info.reconnect_worker_id = _WorkerID(rec["worker_id"])
                self.actors[aid] = info
            for key, actor_id in snap.get("named_actors", {}).items():
                if actor_id in self.actors:
                    self.named_actors.setdefault(key, actor_id)
            import os as _os

            from ray_tpu_torch._private.ids import ObjectID as _ObjectID

            for oid_bin, rec in snap.get("object_spills", {}).items():
                if not _os.path.exists(rec["path"]):
                    continue  # the file died with the old session dir
                e = self._entry(_ObjectID(oid_bin))
                e.spill = (rec["path"], rec["meta"], rec["size"])
                e.spill_host = None
                e.meta = e.meta or rec["meta"]
                e.size = e.size or rec["size"]

    def save_snapshot(self, path: str):
        import os
        import pickle

        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(self.snapshot(), f)
        os.replace(tmp, path)  # atomic: readers never see a torn file

    def load_snapshot(self, path: str) -> bool:
        import pickle

        try:
            with open(path, "rb") as f:
                self.restore(pickle.load(f))
            return True
        except (FileNotFoundError, EOFError, pickle.UnpicklingError):
            return False

    # ---------------- pubsub ----------------
    def subscribe(self, channel: str, callback: Callable[[Any], None]):
        with self._lock:
            self._subscribers[channel].append(callback)

    def publish(self, channel: str, message: Any):
        with self._lock:
            subs = list(self._subscribers.get(channel, ()))
        for cb in subs:
            try:
                cb(message)
            except Exception:
                pass

    # ---------------- nodes ----------------
    def register_node(self, info: NodeInfo):
        with self._lock:
            self.nodes[info.node_id] = info
        self.publish("NODE", ("ALIVE", info.node_id))

    def remove_node(self, node_id: NodeID):
        with self._lock:
            info = self.nodes.get(node_id)
            if info:
                info.alive = False
        self.publish("NODE", ("DEAD", node_id))

    def alive_nodes(self) -> List[NodeInfo]:
        with self._lock:
            return [n for n in self.nodes.values() if n.alive]

    # ---------------- jobs ----------------
    def get_job_config(self, job_id: JobID) -> dict:
        with self._lock:
            info = self.jobs.get(job_id)
            return dict((info or {}).get("config") or {})

    def add_job(self, job_id: JobID, config: dict):
        with self._lock:
            self.jobs[job_id] = {"job_id": job_id, "config": config,
                                 "start_time": time.time(), "status": "RUNNING"}

    def finish_job(self, job_id: JobID):
        with self._lock:
            if job_id in self.jobs:
                self.jobs[job_id]["status"] = "FINISHED"
                self.jobs[job_id]["end_time"] = time.time()

    # ---------------- KV (internal_kv) ----------------
    def kv_put(self, key: bytes, value: bytes, namespace: str = "default",
               overwrite: bool = True) -> bool:
        with self._lock:
            ns = self.kv[namespace]
            if not overwrite and key in ns:
                return False
            ns[key] = value
            return True

    def kv_get(self, key: bytes, namespace: str = "default") -> Optional[bytes]:
        with self._lock:
            return self.kv[namespace].get(key)

    def kv_del(self, key: bytes, namespace: str = "default"):
        with self._lock:
            self.kv[namespace].pop(key, None)

    def kv_keys(self, prefix: bytes, namespace: str = "default") -> List[bytes]:
        with self._lock:
            return [k for k in self.kv[namespace] if k.startswith(prefix)]

    # ---------------- actors ----------------
    def register_actor(self, spec: TaskSpec) -> ActorInfo:
        with self._lock:
            info = ActorInfo(spec.actor_id, spec)
            self.actors[spec.actor_id] = info
            if info.name:
                key = (info.namespace, info.name)
                if key in self.named_actors:
                    raise ValueError(f"actor name {info.name!r} already taken")
                self.named_actors[key] = spec.actor_id
            return info

    def actor_started(self, actor_id: ActorID, node_id: NodeID, worker_id: WorkerID):
        with self._lock:
            info = self.actors[actor_id]
            info.state = ActorState.ALIVE
            info.node_id = node_id
            info.worker_id = worker_id
        self.publish("ACTOR", ("ALIVE", actor_id))

    def actor_failed(self, actor_id: ActorID, cause: str) -> str:
        """Returns the new state: RESTARTING (caller should reschedule) or DEAD."""
        with self._lock:
            info = self.actors.get(actor_id)
            if info is None or info.state == ActorState.DEAD:
                return ActorState.DEAD
            restartable = (info.max_restarts == -1
                           or info.num_restarts < info.max_restarts)
            if restartable:
                info.num_restarts += 1
                info.state = ActorState.RESTARTING
                info.node_id = info.worker_id = None
            else:
                info.state = ActorState.DEAD
                info.death_cause = cause
                if info.name:
                    self.named_actors.pop((info.namespace, info.name), None)
            state = info.state
        self.publish("ACTOR", (state, actor_id))
        return state

    def kill_actor(self, actor_id: ActorID):
        with self._lock:
            info = self.actors.get(actor_id)
            if info is None:
                return
            info.state = ActorState.DEAD
            info.death_cause = "killed via kill()"
            if info.name:
                self.named_actors.pop((info.namespace, info.name), None)
        self.publish("ACTOR", (ActorState.DEAD, actor_id))

    def get_actor_info(self, actor_id: ActorID) -> Optional[ActorInfo]:
        with self._lock:
            return self.actors.get(actor_id)

    def get_named_actor(self, name: str, namespace: str = "default") -> Optional[ActorID]:
        with self._lock:
            return self.named_actors.get((namespace, name))

    def list_named_actors(self, all_namespaces: bool = False) -> List[dict]:
        with self._lock:
            return [{"namespace": ns, "name": n} for (ns, n) in self.named_actors]

    # ---------------- object directory + refcounting ----------------
    def _entry(self, oid: ObjectID) -> ObjectEntry:
        e = self.objects.get(oid)
        if e is None:
            e = self.objects[oid] = ObjectEntry(oid)
        return e

    def object_sealed(self, oid: ObjectID, node_id: NodeID, size: int,
                      lineage_task: Optional[TaskID] = None,
                      meta: Optional[bytes] = None,
                      segment: Optional[str] = None):
        with self._lock:
            e = self._entry(oid)
            e.locations.add(node_id)
            e.size = size
            e.lost = False
            if meta is not None:
                e.meta = meta
            if segment is not None:
                e.segments[node_id] = segment
            if lineage_task is not None:
                e.lineage_task = lineage_task

    def object_inline(self, oid: ObjectID, meta: bytes, data: bytes,
                      lineage_task: Optional[TaskID] = None):
        with self._lock:
            e = self._entry(oid)
            e.inline = (meta, data)
            e.size = len(data)
            e.lost = False
            if lineage_task is not None:
                e.lineage_task = lineage_task

    def object_spill_recorded(self, oid: ObjectID, path: str, meta: bytes,
                              size: int, host: Optional[str] = None):
        """Record a directory-side spill/backup copy: the bytes live at
        ``path`` on ``host`` (None = the head host) and survive the owning
        store's death.  The restore path is head._try_reconstruct."""
        with self._lock:
            e = self._entry(oid)
            e.spill = (path, meta, size)
            e.spill_host = host
            if meta is not None and e.meta is None:
                e.meta = meta
            if size and not e.size:
                e.size = size

    def object_lookup(self, oid: ObjectID) -> Optional[ObjectEntry]:
        with self._lock:
            return self.objects.get(oid)

    def add_reference(self, oid: ObjectID, holder: bytes):
        with self._lock:
            self._entry(oid).holders.add(holder)

    def remove_reference(self, oid: ObjectID, holder: bytes) -> bool:
        """Returns True when the object has no more holders (safe to free)."""
        with self._lock:
            e = self.objects.get(oid)
            if e is None:
                return True
            e.holders.discard(holder)
            return not e.holders

    def remove_all_references(self, holder: bytes) -> List[ObjectID]:
        """Worker/driver died: drop all its references. Returns freed ids."""
        with self._lock:
            freed = []
            for oid, e in self.objects.items():
                if holder in e.holders:
                    e.holders.discard(holder)
                    if not e.holders:
                        freed.append(oid)
            return freed

    def free_object(self, oid: ObjectID):
        with self._lock:
            e = self.objects.pop(oid, None)
            if e is not None and e.lineage_task is not None:
                self._release_lineage(e.lineage_task)

    # ---------------- lineage ----------------
    def record_lineage(self, spec: TaskSpec):
        with self._lock:
            self.lineage[spec.task_id] = spec
            self.lineage_refcount[spec.task_id] = spec.num_returns

    def get_lineage(self, task_id: TaskID) -> Optional[TaskSpec]:
        with self._lock:
            return self.lineage.get(task_id)

    def _release_lineage(self, task_id: TaskID):
        n = self.lineage_refcount.get(task_id)
        if n is None:
            return
        n -= 1
        if n <= 0:
            self.lineage.pop(task_id, None)
            self.lineage_refcount.pop(task_id, None)
        else:
            self.lineage_refcount[task_id] = n

    # ---------------- task events (observability) ----------------
    def record_task_event(self, ev: TaskEvent):
        with self._lock:
            self.task_events[ev.task_id] = ev

    def update_task_status(self, task_id: TaskID, status: TaskStatus, **kw):
        with self._lock:
            ev = self.task_events.get(task_id)
            if ev is not None:
                ev.status = status
                for k, v in kw.items():
                    setattr(ev, k, v)

    # ---------------- state API backing ----------------
    def list_actors(self) -> List[dict]:
        with self._lock:
            return [
                {
                    "actor_id": a.actor_id.hex(),
                    "class_name": a.class_name,
                    "state": a.state,
                    "name": a.name,
                    "num_restarts": a.num_restarts,
                    "node_id": a.node_id.hex() if a.node_id else None,
                }
                for a in self.actors.values()
            ]

    def touch_node(self, node_id: NodeID):
        """Refresh a node's liveness lease (any agent traffic counts)."""
        with self._lock:
            info = self.nodes.get(node_id)
            if info is not None:
                info.last_heartbeat = time.monotonic()

    def update_node_stats(self, node_id: NodeID, stats: dict):
        """Per-node usage snapshot from the monitor loop / node agent
        (reference: the reporter agent feeding the dashboard)."""
        with self._lock:
            info = self.nodes.get(node_id)
            if info is not None:
                info.stats = dict(stats)
                info.last_heartbeat = time.monotonic()

    def list_nodes(self) -> List[dict]:
        with self._lock:
            return [
                {
                    "node_id": n.node_id.hex(),
                    "alive": n.alive,
                    "resources": dict(n.resources),
                    "labels": dict(n.labels),
                    "stats": dict(n.stats),
                }
                for n in self.nodes.values()
            ]

    def list_tasks(self) -> List[dict]:
        with self._lock:
            out = []
            for t in self.task_events.values():
                status = t.status.name if hasattr(t.status, "name") \
                    else str(t.status)
                out.append({
                    "task_id": t.task_id.hex(),
                    "name": t.name,
                    "status": status,
                    # "state" aliases "status" to match the reference's
                    # state API column naming.
                    "state": status,
                    "attempt": t.attempt,
                    "type": t.type,
                    "error": t.error,
                    "start": t.start,
                    "end": t.end,
                    "duration": (t.end - t.start)
                    if t.start is not None and t.end is not None else None,
                    "worker_id": t.worker_id.hex() if t.worker_id else None,
                    "node_id": t.node_id.hex() if t.node_id else None,
                    "parent_task_id": t.parent_task_id.hex()
                    if t.parent_task_id else None,
                    "trace_id": t.trace_id,
                })
            return out

    @staticmethod
    def _object_state(o: ObjectEntry) -> str:
        if o.lost:
            return "LOST"
        if o.inline is not None:
            return "INLINE"
        if o.locations:
            return "SEALED"
        if o.spill is not None or o.spilled_path is not None:
            return "SPILLED"
        return "PENDING"

    def list_objects(self) -> List[dict]:
        with self._lock:
            return [
                {
                    "object_id": o.object_id.hex(),
                    "size": o.size,
                    "locations": [n.hex() for n in o.locations],
                    "inline": o.inline is not None,
                    "num_holders": len(o.holders),
                    "state": self._object_state(o),
                    "node_id": next(iter(o.locations)).hex()
                    if o.locations else None,
                }
                for o in self.objects.values()
            ]

    def list_jobs(self) -> List[dict]:
        with self._lock:
            return [
                {"job_id": j["job_id"].hex(), "status": j["status"]}
                for j in self.jobs.values()
            ]
