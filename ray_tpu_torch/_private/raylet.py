"""Raylet: per-node manager — worker pool, local dispatch, node object store.

Equivalent of the reference's NodeManager + WorkerPool + LocalTaskManager
(src/ray/raylet/node_manager.h:115, worker_pool.h:156,
local_task_manager.h:58).  One Raylet instance per (possibly virtual) node;
all raylets of a local cluster live in the head process, workers are real
subprocesses.  Virtual multi-node is the test fixture the reference builds
with ray.cluster_utils.Cluster (python/ray/cluster_utils.py:99).

Copied from ``ray_tpu/_private/raylet.py`` (the JAX package).
"""
from __future__ import annotations

import os
import subprocess
import sys
import threading
import time
from collections import deque
from typing import Dict, Optional

from ray_tpu_torch._private.ids import NodeID, WorkerID
from ray_tpu_torch._private.object_store import SharedMemoryStore
from ray_tpu_torch._private.task_spec import TaskSpec, TaskType

DEFAULT_MAX_WORKERS = 64
IDLE_WORKER_TTL_S = 300.0


class WorkerHandle:
    __slots__ = ("worker_id", "proc", "conn", "busy", "actor_id", "node_id",
                 "current_task", "idle_since", "gpu_visible", "gpus",
                 "task_started_at", "direct_addr", "leased_to", "lease_spec",
                 "blocked")

    def __init__(self, worker_id: WorkerID, proc, node_id: NodeID):
        self.worker_id = worker_id
        self.proc = proc  # subprocess.Popen (None until registered? no: set at spawn)
        self.conn = None  # set on register
        self.busy = False
        self.actor_id = None
        self.node_id = node_id
        self.current_task: Optional[TaskSpec] = None
        self.idle_since = time.monotonic()
        self.gpu_visible = False
        self.gpus: tuple = ()  # GPU indices this worker owns
        self.task_started_at = 0.0  # dispatch time of current_task
        self.direct_addr = None  # the worker's own direct listener address
        self.leased_to = None    # caller worker id holding a lease on us
        self.lease_spec = None   # synthetic spec whose resources the lease holds
        self.blocked = False     # blocked in get(): resources released


class Raylet:
    """Node-local state. Thread-safety provided by the Head's single dispatch
    lock (all mutation happens under head._lock)."""

    def __init__(self, node_id: NodeID, head, store_capacity: int,
                 labels: Optional[dict] = None, max_workers: int = DEFAULT_MAX_WORKERS,
                 gpus: int = 0):
        self.node_id = node_id
        self.head = head
        self.store = SharedMemoryStore(
            store_capacity,
            spill_dir=os.path.join(head.session_dir, "spill",
                                   node_id.hex()[:12]))
        self.labels = labels or {}
        self.max_workers = max_workers
        self.workers: Dict[WorkerID, WorkerHandle] = {}
        self.idle: deque = deque()  # WorkerIDs of registered idle workers
        self.queued: deque = deque()  # TaskSpecs waiting for a free worker
        self.num_starting = 0
        self.consecutive_start_failures = 0
        self.dead = False
        # GPU partitioning: each GPU worker sees only the GPU indices it
        # was granted (CUDA_VISIBLE_DEVICES), and owns them until it exits,
        # so two GPU workers on one host never share a card by accident.
        self.gpus_total = int(gpus)
        self._free_gpus = list(range(self.gpus_total))

    # ---- worker pool ----
    @staticmethod
    def _gpus_needed(spec: TaskSpec) -> int:
        """Exclusive GPUs for a GPU spec: whole-number requests partition
        (ceil); fractional requests return 0 = *shared* mode — the worker
        is GPU-visible with no exclusive GPU claim, because sharing is the
        declared intent and an exclusive grant would deadlock the peers the
        scheduler co-packed onto the same GPU."""
        req = spec.resources.get("GPU", 0)
        if req < 1:
            return 0

        import math

        return int(math.ceil(req))

    @staticmethod
    def _needs_gpu(spec: TaskSpec) -> bool:
        return spec.resources.get("GPU", 0) > 0

    def ensure_worker(self, spec: Optional[TaskSpec] = None):
        """Spawn a new worker process if needed for `spec` (or any task)."""
        needs_gpu = spec is not None and self._needs_gpu(spec)
        needs_gpus = self._gpus_needed(spec) if needs_gpu else 0
        if needs_gpu:
            # GPU tasks need a GPU-visible worker whose GPU share covers
            # the request.  A worker that is busy or permanently pinned to
            # an actor can never serve this spec, so "some GPU worker
            # exists" is not enough.  Spawn another as long as none with
            # enough GPUs is *available or starting*; each GPU worker is
            # spawned onto a disjoint GPU partition (CUDA_VISIBLE_DEVICES).
            for w in self.workers.values():
                if not w.gpu_visible:
                    continue
                # Shared-mode specs (needs_gpus == 0) are satisfied by any
                # GPU-visible worker.
                if self.gpus_total > 0 and len(w.gpus) < needs_gpus:
                    continue
                if w.conn is None:  # still starting — wait for it
                    return
                if not w.busy and w.actor_id is None:  # idle and claimable
                    return
            if len(self.workers) < self.max_workers:
                if needs_gpus:
                    gpus = self._allocate_gpus(needs_gpus)
                    if gpus is None:
                        # No free GPUs: every GPU is held by a live GPU
                        # worker.  The spec waits until one dies/releases
                        # (the scheduler already capped grants to the
                        # node's GPU total, so this only happens while a
                        # pinned worker is shutting down).
                        return
                else:
                    gpus = ()  # shared mode: all GPUs visible, none owned
                self.spawn_worker(gpu_visible=True, gpus=gpus)
            return
        # A task without GPUs never runs on a GPU-visible worker (see
        # _pop_idle), so only CPU-only idle workers can serve it.
        if self.num_starting > 0 or any(
                not self.workers[w].gpu_visible
                for w in self.idle if w in self.workers):
            return
        if len(self.workers) + self.num_starting >= self.max_workers:
            return
        self.spawn_worker()

    def _allocate_gpus(self, n: int) -> Optional[tuple]:
        """Reserve n GPU indices for a new GPU worker (None if unavailable)."""
        if len(self._free_gpus) < n:
            return None
        gpus = tuple(self._free_gpus[:n])
        del self._free_gpus[:n]
        return gpus

    def _worker_env(self, worker_id: WorkerID, gpu_visible: bool,
                    gpus: tuple) -> Dict[str, str]:
        """Env-var *overlay* every worker needs, local or remote (transport
        vars are added by the spawner — head socket locally, head TCP on
        agents; the spawner applies this on top of its inherited environ).
        It sets CUDA_VISIBLE_DEVICES on every worker but a shared-mode GPU
        worker, which keeps the inherited value."""
        env = {
            "RAY_TPU_AUTHKEY": self.head.authkey.hex(),
            "RAY_TPU_NODE_ID": self.node_id.hex(),
            "RAY_TPU_WORKER_ID": worker_id.hex(),
            # Host identity for the direct transport's endpoint selection
            # (same host => unix socket; cross-host => TCP).  RemoteRaylet
            # overrides with its agent's host key.
            "RAY_TPU_HOST_KEY": getattr(self, "host_key", None)
                                 or self.head.host_key,
        }
        # Tracing plane: ship the driver's RESOLVED tracing switch — the
        # flag may have been set via _system_config or enable_tracing(),
        # which a fresh subprocess's CONFIG would never see.
        try:
            from ray_tpu_torch.util.tracing import tracing_enabled

            if tracing_enabled():
                env["RAY_TPU_TRACING_ENABLED"] = "1"
        except Exception:
            pass
        if gpu_visible and gpus:
            # The worker's own partition: it sees the granted GPUs only, as
            # cuda:0, cuda:1, ... in its own numbering.
            env["CUDA_VISIBLE_DEVICES"] = ",".join(str(g) for g in gpus)
        elif not gpu_visible:
            # A CPU worker sees no GPU: a port entry point asked for CUDA
            # there raises instead of quietly taking a card.
            env["CUDA_VISIBLE_DEVICES"] = ""
        return env

    def spawn_worker(self, gpu_visible: bool = False,
                     gpus: tuple = ()) -> WorkerID:
        worker_id = WorkerID.from_random()
        env = dict(os.environ)
        env.update(self._worker_env(worker_id, gpu_visible, gpus))
        from ray_tpu_torch._private import inject_pkg_pythonpath

        inject_pkg_pythonpath(env)
        env["RAY_TPU_HEAD_SOCKET"] = self.head.socket_path
        env["RAY_TPU_SESSION_DIR"] = self.head.session_dir
        # Per-worker log files, tailed by the head's LogMonitor and echoed
        # to the driver (reference: log_monitor.py:104).
        logs_dir = os.path.join(self.head.session_dir, "logs")
        os.makedirs(logs_dir, exist_ok=True)
        stem = os.path.join(logs_dir, f"worker-{worker_id.hex()[:16]}")
        out_f = open(stem + ".out", "ab")
        err_f = open(stem + ".err", "ab")
        try:
            proc = subprocess.Popen(
                [sys.executable, "-m", "ray_tpu_torch._private.default_worker"],
                env=env,
                stdout=out_f,
                stderr=err_f,
            )
        finally:
            out_f.close()
            err_f.close()
        h = WorkerHandle(worker_id, proc, self.node_id)
        h.gpu_visible = gpu_visible
        h.gpus = tuple(gpus)
        self.workers[worker_id] = h
        self.num_starting += 1
        return worker_id

    def on_worker_registered(self, worker_id: WorkerID, conn,
                             direct_addr=None) -> Optional[WorkerHandle]:
        h = self.workers.get(worker_id)
        if h is None:
            return None
        h.conn = conn
        h.direct_addr = direct_addr
        self.num_starting = max(0, self.num_starting - 1)
        self.consecutive_start_failures = 0
        self.idle.append(worker_id)
        h.idle_since = time.monotonic()
        return h

    def on_worker_lost(self, worker_id: WorkerID) -> Optional[WorkerHandle]:
        h = self.workers.pop(worker_id, None)
        if h is None:
            return None
        try:
            self.idle.remove(worker_id)
        except ValueError:
            pass
        if h.gpus:  # return the GPU partition to the free pool
            self._free_gpus.extend(h.gpus)
            self._free_gpus.sort()
            h.gpus = ()
        return h

    # ---- dispatch ----
    def try_dispatch(self):
        """Hand queued task specs to idle workers; spawn workers as needed.
        Scans the whole queue so one spec waiting for a special worker
        (e.g. GPU-visible) doesn't block runnable work behind it.
        Called under the head lock whenever state changes."""
        progress = True
        while progress and self.queued:
            progress = False
            for spec in list(self.queued):
                worker = self._pop_idle(spec)
                if worker is None:
                    self.ensure_worker(spec)
                    continue
                self.queued.remove(spec)
                progress = True
                worker.busy = True
                worker.current_task = spec
                worker.task_started_at = time.monotonic()
                if spec.task_type == TaskType.ACTOR_CREATION:
                    worker.actor_id = spec.actor_id
                self.head.send_to_worker(worker, {"type": "execute", "spec": spec})

    def _pop_idle(self, spec: TaskSpec) -> Optional[WorkerHandle]:
        needs_gpu = self._needs_gpu(spec)
        needs_gpus = self._gpus_needed(spec) if needs_gpu else 0
        for _ in range(len(self.idle)):
            wid = self.idle.popleft()
            h = self.workers.get(wid)
            if h is None or h.conn is None:
                continue
            if needs_gpu != h.gpu_visible or (
                    needs_gpu and self.gpus_total > 0
                    and len(h.gpus) < needs_gpus):
                self.idle.append(wid)
                continue
            return h
        return None

    def queue_task(self, spec: TaskSpec):
        self.queued.append(spec)
        self.try_dispatch()

    def release_worker(self, worker: WorkerHandle):
        """Task finished: return worker to the idle pool (actors stay pinned)."""
        worker.busy = False
        worker.current_task = None
        if worker.actor_id is None:
            self.idle.append(worker.worker_id)
            worker.idle_since = time.monotonic()
        self.try_dispatch()

    def shutdown(self, keep_spilled: bool = False):
        self.dead = True
        for h in list(self.workers.values()):
            try:
                if h.conn is not None:
                    h.conn.send({"type": "shutdown"})
            except Exception:
                pass
        deadline = time.monotonic() + 2.0
        for h in list(self.workers.values()):
            if h.proc is None:
                continue
            try:
                h.proc.wait(timeout=max(0.05, deadline - time.monotonic()))
            except Exception:
                try:
                    h.proc.kill()
                except Exception:
                    pass
        self.store.shutdown(keep_spilled=keep_spilled)


# ---------------------------------------------------------------------------
# Remote nodes (multi-host): head-side proxies for a node agent process
# ---------------------------------------------------------------------------
class RemoteStoreProxy:
    """Head-side handle for a store that lives in a node agent process.

    Mutations are forwarded over the agent connection; reads return None —
    the head never reads remote bytes, it hands out pull resolutions against
    the agent's ObjectTransferServer instead (the reference's raylet↔object
    manager split, src/ray/object_manager/object_manager.h:117)."""

    def __init__(self, raylet: "RemoteRaylet"):
        self._raylet = raylet
        self.arena = None
        self.evict_callback = None  # agents report via "object_evicted" msgs
        # Spill records reported by the agent ("object_spilled"): lets the
        # head hand same-host callers a direct spill-file resolution.
        self._spilled: Dict = {}

    def adopt(self, object_id, data_size: int, metadata: bytes,
              segment=None):
        self._raylet.send_agent({"type": "store_adopt",
                                 "oid": object_id.binary(),
                                 "size": data_size, "meta": metadata,
                                 "segment": segment})

    def segment_of(self, object_id):
        return None

    def delete(self, object_id, evicted: bool = False):
        self._spilled.pop(object_id, None)
        self._raylet.send_agent({"type": "store_delete",
                                 "oid": object_id.binary()})

    def note_spilled(self, object_id, path: str, meta: bytes, size: int):
        self._spilled[object_id] = (path, meta, size)

    def meta(self, object_id):
        return None

    def arena_lookup(self, object_id):
        return None

    def spilled_lookup(self, object_id):
        rec = self._spilled.get(object_id)
        if rec is None:
            return None
        path, meta, size = rec
        return {"kind": "spilled", "path": path, "meta": meta, "size": size}

    def get(self, object_id):
        return None

    def contains(self, object_id):
        return False

    def pin(self, object_id):
        pass

    def unpin(self, object_id):
        pass

    def stats(self):
        return {}

    def shutdown(self):
        pass


class _RemoteProc:
    """Popen stand-in for a worker subprocess living on another host.
    Liveness comes from the agent's worker_exit reports + the worker's own
    control connection, not from local polling."""

    def __init__(self, raylet: "RemoteRaylet", worker_id: WorkerID):
        self._raylet = raylet
        self._worker_id = worker_id
        self.returncode = None

    def poll(self):
        return self.returncode

    def wait(self, timeout=None):
        return self.returncode

    def kill(self):
        self._raylet.send_agent({"type": "kill_worker",
                                 "worker_id": self._worker_id.binary()})


class RemoteRaylet(Raylet):
    """A raylet whose store + worker processes live on another host, driven
    through a NodeAgent connection (reference: the remote raylet the GCS
    talks to via NodeManagerService, src/ray/raylet/node_manager.h:115)."""

    def __init__(self, node_id: NodeID, head, agent_conn, host_key: str,
                 transfer_addr, labels: Optional[dict] = None,
                 max_workers: int = DEFAULT_MAX_WORKERS, gpus: int = 0):
        # Deliberately NOT calling super().__init__: no local store.
        self.node_id = node_id
        self.head = head
        self.agent_conn = agent_conn
        self.host_key = host_key
        self.transfer_addr = tuple(transfer_addr)
        self.store = RemoteStoreProxy(self)
        self.labels = labels or {}
        self.max_workers = max_workers
        self.workers: Dict[WorkerID, WorkerHandle] = {}
        self.idle: deque = deque()
        self.queued: deque = deque()
        self.num_starting = 0
        self.consecutive_start_failures = 0
        self.dead = False
        self.gpus_total = int(gpus)
        self._free_gpus = list(range(self.gpus_total))
        self._agent_lock = threading.Lock()

    def send_agent(self, msg: dict):
        try:
            with self._agent_lock:
                self.agent_conn.send(msg)
        except Exception:
            pass  # agent death is handled by its conn-close path

    def spawn_worker(self, gpu_visible: bool = False,
                     gpus: tuple = ()) -> WorkerID:
        worker_id = WorkerID.from_random()
        env = self._worker_env(worker_id, gpu_visible, gpus)
        self.send_agent({"type": "spawn_worker",
                         "worker_id": worker_id.binary(), "env": env})
        h = WorkerHandle(worker_id, _RemoteProc(self, worker_id), self.node_id)
        h.gpu_visible = gpu_visible
        h.gpus = tuple(gpus)
        self.workers[worker_id] = h
        self.num_starting += 1
        return worker_id

    def shutdown(self, keep_spilled: bool = False):
        self.dead = True
        self.send_agent({"type": "shutdown"})
        try:
            self.agent_conn.close()
        except Exception:
            pass
