"""Head: wires GCS + ClusterScheduler + Raylets + worker connections together.

This is the control-plane hub of a single-host (or virtual multi-node)
cluster: the reference's gcs_server + raylet processes collapsed into one
threaded component (see gcs.py for why).  Every mutation happens under one
lock; blocking waits (get/wait) are deferred-reply callbacks so connection
reader threads never block.

Responsibilities (reference equivalents in parentheses):
  - task manager: pending queue, retries, lineage reconstruction
    (src/ray/core_worker/task_manager.h:90, object_recovery_manager.h:41)
  - actor manager: creation leasing + restart FSM routing
    (src/ray/gcs/gcs_server/gcs_actor_manager.h:280)
  - object waits (src/ray/raylet/wait_manager.h)
  - worker connection routing (src/ray/rpc + direct transports)

Copied from ``ray_tpu/_private/head.py`` (the JAX package).
"""
from __future__ import annotations

import os
import pickle
import tempfile
import threading
import time
import traceback
from collections import defaultdict, deque
from multiprocessing.connection import Listener
from typing import Any, Callable, Dict, List, Optional, Tuple

from ray_tpu_torch import exceptions as exc
from ray_tpu_torch._private import serialization as ser
from ray_tpu_torch._private.gcs import GCS, ActorState, NodeInfo, TaskEvent
from ray_tpu_torch._private.ids import (
    ActorID,
    NodeID,
    ObjectID,
    PlacementGroupID,
    TaskID,
    WorkerID,
)
from ray_tpu_torch._private.raylet import (
    Raylet,
    RemoteRaylet,
    RemoteStoreProxy,
    WorkerHandle,
)
from ray_tpu_torch._private.scheduler import (
    ClusterScheduler,
    Infeasible,
    PlacementGroupInfo,
)
from ray_tpu_torch._private.task_spec import (
    ERROR_META,
    TaskResult,
    TaskSpec,
    TaskStatus,
    TaskType,
)


class Head:
    def __init__(self, session_dir: Optional[str] = None, tcp_port: int = 0):
        self.session_dir = session_dir or tempfile.mkdtemp(prefix="rttp_session_")
        os.makedirs(self.session_dir, exist_ok=True)
        self.socket_path = os.path.join(self.session_dir, "head.sock")
        if os.path.exists(self.socket_path):
            os.unlink(self.socket_path)  # stale socket from a dead head
        # Persistent cluster identity: a restarted head must present the
        # SAME authkey or reconnecting agents/workers/drivers fail their
        # HMAC handshake (reference: the GCS's stable redis-backed
        # identity).  tcp_port=0 keeps the ephemeral-port behavior for
        # in-process test clusters; a standalone head passes a fixed port.
        keyfile = os.path.join(self.session_dir, "authkey.bin")
        if os.path.exists(keyfile):
            with open(keyfile, "rb") as f:
                self.authkey = f.read()
        else:
            self.authkey = os.urandom(16)
            fd = os.open(keyfile, os.O_WRONLY | os.O_CREAT | os.O_EXCL,
                         0o600)
            with os.fdopen(fd, "wb") as f:
                f.write(self.authkey)
        self.gcs = GCS()
        self.scheduler = ClusterScheduler()
        self.raylets: Dict[NodeID, Raylet] = {}
        self._lock = threading.RLock()
        # task_id -> spec for everything in flight (pending or running)
        self.pending: deque = deque()  # specs with no feasible placement yet
        self.running: Dict[TaskID, Tuple[TaskSpec, WorkerID]] = {}
        # Deferred replies: task_id -> list of callbacks fired on completion
        self._object_waiters: Dict[ObjectID, List[Callable[[dict], None]]] = defaultdict(list)
        self._actor_waiters: Dict[ActorID, List[Callable[[dict], None]]] = defaultdict(list)
        self._pg_waiters: Dict[PlacementGroupID, List[Callable[[dict], None]]] = defaultdict(list)
        self._conns: Dict[WorkerID, Any] = {}
        self._conn_worker: Dict[int, WorkerID] = {}
        # Worker registrations that raced ahead of their node's (re-)
        # registration during head failover: replayed in add_remote_node.
        self._pending_worker_regs: Dict[NodeID, list] = defaultdict(list)
        self._pending_pgs: List[PlacementGroupInfo] = []
        # Arena reader leases: oid -> {holder worker id: count}.  Granted when
        # an arena resolution is handed to a reader, released when the reader
        # drops its last zero-copy view.  The equivalent of plasma's client
        # in-use counts (the reference never reuses memory while a client
        # holds the buffer): an arena slot must not be recycled while any
        # process may still read it.
        self._arena_leases: Dict[ObjectID, Dict[bytes, int]] = defaultdict(dict)
        self._arena_pending_free: set = set()
        self._cancelled: set = set()  # task ids cancelled while running
        # task id -> host usage fraction at kill time (memory-monitor
        # victims, head- or agent-side): the death handler surfaces a
        # typed OutOfMemoryError carrying the usage once retries run out.
        self._oom_killed: Dict[TaskID, float] = {}
        # Nodes declared dead exactly once: conn EOF, lease expiry, and
        # explicit kills all funnel through remove_node, which must not
        # double-run death processing (reference: the GCS node manager's
        # single DEAD transition, gcs_node_manager.h).
        self._dead_nodes: set = set()
        self._shutdown = False
        # Idempotency-key reply cache: retried/duplicated request frames
        # (client resends after a lost reply, chaos dup injection,
        # reconnect resends) are applied exactly once — duplicates attach
        # to the original execution and are answered from its reply.
        from ray_tpu_torch._private.config import CONFIG as _CONFIG
        from ray_tpu_torch._private.retry import ReplyCache

        self._rpc_cache = ReplyCache(
            cap=_CONFIG.rpc_reply_cache_size,
            ttl=_CONFIG.rpc_reply_cache_ttl_s)
        # ---- tracing plane ----
        # Cluster span sink: workers flush span batches here (span_batch
        # op / node_stats piggyback); byte-budgeted so tracing can stay
        # on without unbounded head memory.  The event log is the flight
        # recorder's "what happened lately" feed (node joins/deaths,
        # kills) — cheap enough to run even with tracing off.
        from ray_tpu_torch.observability.trace_store import TraceStore

        self.trace_store = TraceStore(
            max_bytes=_CONFIG.trace_store_max_bytes,
            per_trace_bytes=_CONFIG.trace_max_bytes)
        self._event_log: deque = deque(maxlen=512)
        # ---- multi-host plane ----
        # Host identity: object resolutions are host-aware — same host means
        # "attach the shm segment", different host means "pull over TCP from
        # the owning store" (reference: object_manager.h:117 push/pull).
        self.host_key = os.urandom(8).hex()
        self.node_host: Dict[NodeID, str] = {}       # node -> host key
        self.node_xfer: Dict[NodeID, tuple] = {}      # node -> (ip, port)
        self._local_xfer: Dict[NodeID, Any] = {}      # local transfer servers
        # Cooperative-broadcast reverse index: partial-holder key (worker
        # id / node key) -> oids it advertised, so a process death clears
        # its advertisements in O(its objects), not O(all objects).
        self._partial_index: Dict[bytes, set] = defaultdict(set)
        self._driver_hosts: Dict[bytes, str] = {}     # remote driver host keys
        self._driver_nodes: Dict[bytes, NodeID] = {}  # driver wid -> pseudo node
        self._driver_conns: Dict[bytes, Any] = {}     # driver wid -> live conn
        self._has_remote = False
        self._listener = Listener(self.socket_path, family="AF_UNIX",
                                  authkey=self.authkey)
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               name="rtpu-accept", daemon=True)
        self._accept_thread.start()
        # TCP listener: remote node agents, remote drivers, and workers on
        # remote nodes all connect here (the networked flank of the same
        # control protocol the AF_UNIX listener speaks).  Binds loopback by
        # default — a purely local cluster must not expose its control
        # plane on external interfaces; set RAY_TPU_TORCH_TCP_HOST=0.0.0.0 when
        # remote hosts are expected to join.
        from ray_tpu_torch._private.config import CONFIG

        self.tcp_bind_host = CONFIG.tcp_host
        self._tcp_listener = Listener((self.tcp_bind_host, tcp_port),
                                      family="AF_INET", authkey=self.authkey)
        self.tcp_port = self._tcp_listener.address[1]
        self._tcp_accept_thread = threading.Thread(
            target=self._accept_loop,
            kwargs={"listener": self._tcp_listener,
                    "thread_name": "rtpu-conn-tcp"},
            name="rtpu-accept-tcp", daemon=True)
        self._tcp_accept_thread.start()
        # Health monitor: catches worker processes that die before/without
        # closing their connection (e.g. failed to start at all) — the
        # equivalent of the reference's GCS health checks
        # (gcs_health_check_manager.h:39).
        # Memory-pressure policing (reference: memory_monitor.h:52 +
        # worker_killing_policy.h:33): evaluated from the same monitor loop.
        from ray_tpu_torch._private.memory_monitor import MemoryMonitor

        self.memory_monitor = MemoryMonitor(self)
        self._monitor_thread = threading.Thread(target=self._monitor_loop,
                                                name="rtpu-monitor", daemon=True)
        self._monitor_thread.start()
        # Worker log capture → GCS pubsub → driver echo (reference:
        # log_monitor.py:104).
        from ray_tpu_torch._private.log_monitor import LogMonitor

        self.log_monitor = LogMonitor(os.path.join(self.session_dir, "logs"),
                                      self.gcs)
        # GCS persistence (reference: RedisStoreClient-backed GCS FT,
        # redis_store_client.h:28): restore durable tables from a prior
        # snapshot in this session dir, and re-snapshot periodically when
        # gcs_snapshot_period_s > 0.
        self.gcs_snapshot_path = os.path.join(self.session_dir,
                                              "gcs_snapshot.pkl")
        self.gcs.load_snapshot(self.gcs_snapshot_path)
        # ---- arg-locality plane (place compute where the bytes live) ----
        # Tasks with directory-tracked ObjectRef args park until the args
        # exist somewhere, so placement sees real per-host byte counts;
        # the default policy then prefers the holder host, and args still
        # missing from the chosen host are prefetched into its store
        # while the task is queued (initialized BEFORE snapshot restore —
        # restored creation specs go through _schedule below).
        self._locality_on: bool = CONFIG.locality_scheduling
        self._locality_prefetch: bool = (self._locality_on
                                         and CONFIG.locality_prefetch)
        self._dep_parked: Dict[ObjectID, List[TaskSpec]] = defaultdict(list)
        self._prefetch_inflight: set = set()          # {(oid, node_id)}
        self._prefetch_recs: Dict[tuple, dict] = {}   # in-flight records
        self._prefetch_log: deque = deque(maxlen=256)  # wall-stamp proof
        self._prefetch_q = None                       # lazy worker queue
        self._loc_counters: Dict[str, float] = {}     # sched_locality_*
        # Restored actors that had NO worker at snapshot time (creation
        # still queued) have nothing to re-adopt: reschedule their
        # creation now — it waits in the pending queue until capacity
        # (re-)registers.
        with self._lock:
            from ray_tpu_torch._private.gcs import ActorState as _AS

            for info in self.gcs.actors.values():
                if info.state == _AS.RESTARTING \
                        and info.reconnect_worker_id is None:
                    self._schedule(info.creation_spec)
        self._boot_time = __import__("time").monotonic()
        self._reconnect_reaped = False
        # ---- object durability plane (node-loss survivability) ----
        # Puts have no lineage: without a second copy they die with their
        # node.  object_durability=replicate:K keeps K async replicas on
        # distinct holder nodes; =spill keeps an on-disk backup the head
        # can restore from.  Off by default — the fault-free hot path
        # pays only one predicate check per seal.
        self._durability: Optional[tuple] = None
        spec = (CONFIG.object_durability or "off").strip().lower()
        if spec.startswith("replicate"):
            k = 2
            if ":" in spec:
                try:
                    k = max(2, int(spec.split(":", 1)[1]))
                except ValueError:
                    pass
            self._durability = ("replicate", k)
        elif spec == "spill":
            self._durability = ("spill",)
        self._durability_min = CONFIG.object_durability_min_bytes
        self._durability_q = None
        self._durability_pending = 0  # queued + in-flight (quiesce gate)
        self._repl_client = None  # lazy TransferClient for replica pulls
        if self._durability is not None:
            import queue as _queue

            self._durability_q = _queue.Queue()
            threading.Thread(target=self._durability_loop,
                             name="rtpu-durability", daemon=True).start()
        period = CONFIG.gcs_snapshot_period_s
        if period > 0:
            def snapshot_loop():
                import time as _time

                while not self._shutdown:
                    _time.sleep(period)
                    try:
                        self.gcs.save_snapshot(self.gcs_snapshot_path)
                    except Exception:
                        pass

            threading.Thread(target=snapshot_loop, name="rtpu-gcs-snap",
                             daemon=True).start()

    def _monitor_loop(self):
        import time as _time

        from ray_tpu_torch._private.config import CONFIG

        # The loop paces both worker-liveness checks and memory-pressure
        # ticks: honor the faster of the two periods so a sub-500ms
        # memory_monitor_refresh_ms is actually achieved.
        period = CONFIG.health_check_period_s
        if self.memory_monitor.enabled:
            period = min(period, self.memory_monitor.period_s)
        period = max(0.02, period)  # floor: never busy-spin the head lock
        stats_period = CONFIG.node_stats_period_s
        last_stats = 0.0
        while not self._shutdown:
            _time.sleep(period)
            # Local node stats (reference: the per-node reporter agent;
            # local raylets share this host, so one host snapshot + each
            # raylet's own store stats).  Remote nodes report over their
            # agent connection instead.
            now = _time.monotonic()
            if stats_period > 0 and now - last_stats >= stats_period:
                last_stats = now
                from ray_tpu_torch._private.node_stats import (collect_node_stats,
                                                         host_snapshot)
                from ray_tpu_torch._private.raylet import RemoteRaylet

                base = host_snapshot()  # ONE cpu/mem read per tick —
                # local raylets share this host (per-raylet cpu_percent
                # calls would measure microsecond intervals)
                from ray_tpu_torch._private.recovery import recovery_stats

                rec = recovery_stats()  # cluster-level recovery counters:
                # exported on the head's own node row so chaos runs can
                # assert recovery happened from node_stats/dashboard
                with self._lock:
                    first_local = True
                    for raylet in self.raylets.values():
                        if isinstance(raylet, RemoteRaylet):
                            continue
                        stats = collect_node_stats(
                            store=raylet.store,
                            num_workers=len(raylet.workers),
                            host_base=base)
                        if first_local:
                            first_local = False
                            stats.update(rec)
                        self.gcs.update_node_stats(raylet.node_id, stats)
            # Agent lease expiry: a remote node whose heartbeat went
            # silent past the lease is declared dead exactly once — its
            # locations are discarded (recovery paths take over), its
            # leased/queued work is requeued, its workers struck
            # (reference: gcs_health_check_manager.h node failure).
            lease = CONFIG.node_lease_timeout_s
            if lease > 0:
                expired = []
                now = _time.monotonic()
                with self._lock:
                    for nid, raylet in self.raylets.items():
                        if not isinstance(raylet, RemoteRaylet) \
                                or raylet.max_workers <= 0:
                            continue  # local nodes + driver pseudo-nodes
                        info = self.gcs.nodes.get(nid)
                        if info is not None \
                                and now - info.last_heartbeat > lease:
                            expired.append(nid)
                for nid in expired:
                    self.remove_node(
                        nid, cause=f"agent lease expired (no heartbeat "
                                   f"for {lease:.0f}s)")
            with self._lock:
                self._reap_unreconnected_actors()
                self.memory_monitor.tick()
                for raylet in list(self.raylets.values()):
                    for h in list(raylet.workers.values()):
                        if h.proc is not None and h.proc.poll() is not None:
                            if h.conn is None:
                                raylet.num_starting = max(0, raylet.num_starting - 1)
                                raylet.consecutive_start_failures += 1
                            self._handle_worker_death(
                                h, f"worker process exited with code "
                                   f"{h.proc.returncode}")
                            raylet.on_worker_lost(h.worker_id)
                            self._conns.pop(h.worker_id, None)
                            if raylet.consecutive_start_failures >= 3:
                                # Workers can't start at all (e.g. broken env):
                                # fail queued work instead of spawn-looping.
                                while raylet.queued:
                                    spec = raylet.queued.popleft()
                                    self.scheduler.return_resources(
                                        raylet.node_id, spec)
                                    self._fail_task(spec, exc.WorkerCrashedError(
                                        "worker processes repeatedly failed "
                                        "to start on this node"))
                            else:
                                raylet.try_dispatch()

    @property
    def tcp_address(self) -> str:
        if self.tcp_bind_host not in ("0.0.0.0", "::"):
            return f"{self.tcp_bind_host}:{self.tcp_port}"
        from ray_tpu_torch._private.transfer import routable_ip

        return f"{routable_ip()}:{self.tcp_port}"

    # ================= cluster membership =================
    def add_node(self, resources: Dict[str, float], labels: Optional[dict] = None,
                 store_capacity: int = 2 * 1024**3, max_workers: int = 64) -> NodeID:
        node_id = NodeID.from_random()
        with self._lock:
            raylet = Raylet(node_id, self, store_capacity, labels, max_workers,
                            gpus=int(resources.get("GPU", 0)))
            raylet.store.evict_callback = (
                lambda oid, nid=node_id: self._on_object_evicted(oid, nid))
            # Spill policy: only objects the directory still references are
            # worth the disk write; the rest just evict (reference:
            # LocalObjectManager spills pinned/referenced objects,
            # local_object_manager.h:41).
            raylet.store.should_spill = self._object_is_referenced
            # Directory-side spill records: the head must know about every
            # on-disk copy so it can serve restores after the owning
            # store (node) dies — and so the record survives a head
            # restart via the GCS snapshot.
            raylet.store.spill_callback = (
                lambda oid, nid=node_id: self._on_local_spill(oid, nid))
            self.raylets[node_id] = raylet
            self.node_host[node_id] = self.host_key
            self.scheduler.add_node(node_id, resources, labels)
            self.gcs.register_node(NodeInfo(node_id, resources, labels))
            if self._has_remote:
                self._ensure_local_transfer(node_id)
            self._drain_pending()
            self._drive_pending_pgs()
        return node_id

    def add_remote_node(self, msg: dict, conn) -> NodeID:
        """A node agent registered over TCP: attach its host to the cluster
        (reference: raylet self-registration with the GCS).  A
        RE-registration after head failover carries the agent's previous
        node_id and its surviving worker processes, which are adopted
        rather than respawned."""
        from ray_tpu_torch._private.config import CONFIG

        node_id = (NodeID(msg["node_id"]) if msg.get("node_id")
                   else NodeID.from_random())
        resources = dict(msg["resources"])
        labels = msg.get("labels") or {}
        with self._lock:
            # A healed partition may re-register a node the lease expiry
            # already declared dead: it rejoins as a live node and must be
            # removable again.
            self._dead_nodes.discard(node_id)
            raylet = RemoteRaylet(
                node_id, self, conn, msg["host_key"], msg["transfer_addr"],
                labels, msg.get("max_workers", 64),
                gpus=int(resources.get("GPU", 0)))
            self.raylets[node_id] = raylet
            self.node_host[node_id] = msg["host_key"]
            self.node_xfer[node_id] = tuple(msg["transfer_addr"])
            self._has_remote = True
            # Local stores must now be pull-servable by remote hosts.
            for nid in list(self.raylets):
                self._ensure_local_transfer(nid)
            self.scheduler.add_node(node_id, resources, labels)
            self.gcs.register_node(NodeInfo(node_id, resources, labels))
            # Adopt the agent's surviving worker processes (failover):
            # handles exist immediately; each worker's own reconnect then
            # attaches its control conn (possibly already parked below).
            from ray_tpu_torch._private.raylet import _RemoteProc, WorkerHandle

            for w in msg.get("workers") or []:
                if isinstance(w, dict):
                    wid = WorkerID(w["worker_id"])
                    gpus = tuple(w.get("gpus") or ())
                else:  # bare worker-id (older agents)
                    wid, gpus = WorkerID(w), ()
                h = WorkerHandle(wid, _RemoteProc(raylet, wid), node_id)
                if gpus:
                    # The surviving worker still owns these GPUs: keep
                    # them out of the fresh raylet's free pool.
                    h.gpu_visible = True
                    h.gpus = gpus
                    raylet._free_gpus = [g for g in raylet._free_gpus
                                         if g not in gpus]
                raylet.workers[wid] = h
            for worker_id, wconn, daddr in self._pending_worker_regs.pop(
                    node_id, []):
                self._conns[worker_id] = wconn
                h = raylet.on_worker_registered(worker_id, wconn, daddr)
                self._try_readopt_actor(raylet, node_id, worker_id, h)
            self._drain_pending()
            self._drive_pending_pgs()
        self._send_on(conn, {"type": "node_registered",
                             "node_id": node_id.binary(),
                             # Head-resolved config the agent must honor
                             # (its own CONFIG never sees the head's
                             # _system_config overrides).
                             "node_stats_period_s":
                                 CONFIG.node_stats_period_s})
        return node_id

    def add_remote_driver(self, msg: dict, conn) -> NodeID:
        """A remote driver joined over TCP.  It carries its own embedded
        store + transfer server (so its puts stay host-local and stay
        pullable), surfaced here as an unschedulable pseudo-node."""
        node_id = NodeID.from_random()
        worker_id = msg["worker_id"]
        with self._lock:
            raylet = RemoteRaylet(node_id, self, conn, msg["host_key"],
                                  msg["transfer_addr"], max_workers=0)
            self.raylets[node_id] = raylet
            self.node_host[node_id] = msg["host_key"]
            self.node_xfer[node_id] = tuple(msg["transfer_addr"])
            self._has_remote = True
            for nid in list(self.raylets):
                self._ensure_local_transfer(nid)
            self._driver_hosts[worker_id] = msg["host_key"]
            self._driver_nodes[worker_id] = node_id
            self._driver_conns[worker_id] = conn
            self.gcs.add_job(msg["job_id"], msg.get("job_config") or {})
        self._send_on(conn, {"type": "driver_registered",
                             "node_id": node_id.binary()})
        return node_id

    def _ensure_local_transfer(self, node_id: NodeID):
        """Start a transfer server over a local raylet's store (idempotent;
        only local stores need one here — remote stores bring their own)."""
        if node_id in self._local_xfer or node_id in self.node_xfer:
            return
        raylet = self.raylets.get(node_id)
        if raylet is None or isinstance(raylet.store, RemoteStoreProxy):
            return
        from ray_tpu_torch._private.transfer import ObjectTransferServer

        srv = ObjectTransferServer(raylet.store, self.authkey)
        self._local_xfer[node_id] = srv
        self.node_xfer[node_id] = srv.address

    def remove_node(self, node_id: NodeID, cause: str = "node removed"):
        """Node-death protocol — one authority for every death signal
        (agent conn EOF, lease expiry, chaos kill, explicit removal).
        Exactly once per node: discard its object locations (surviving
        replicas / spill records / lineage take over), requeue work that
        was queued-but-never-started there, run worker-death processing
        for every worker (running-task retries, lease reclaim, actor FSM,
        rollout-worker strikes via ActorDiedError), and fail objects with
        no recovery path so waiters error instead of hanging forever."""
        from ray_tpu_torch._private.recovery import note

        with self._lock:
            if node_id in self._dead_nodes:
                return
            self._dead_nodes.add(node_id)
            self._log_event("node_death", node=node_id.hex(), cause=cause)
            # Flight recorder: snapshot BEFORE death processing reshuffles
            # the task table, so the bundle shows what was running (and
            # which spans the victim flushed) at the moment of death.
            self._flight_snapshot(
                f"node_death_{node_id.hex()[:8]}",
                {"cause": cause, "node": node_id.hex()})
            raylet = self.raylets.pop(node_id, None)
            # PGs demoted to PENDING by the node loss re-reserve through
            # the pending queue once capacity returns (their surviving
            # bundles' reservations were released by the scheduler).
            for pg in self.scheduler.remove_node(node_id):
                if pg not in self._pending_pgs:
                    self._pending_pgs.append(pg)
            # Prefetches targeting the dead node can never complete.
            for key in [k for k in self._prefetch_inflight
                        if k[1] == node_id]:
                self._finish_prefetch(key, 0, False)
            self.gcs.remove_node(node_id)
            self.node_host.pop(node_id, None)
            self.node_xfer.pop(node_id, None)
            self._drop_partials_for(b"na:" + node_id.binary())
            srv = self._local_xfer.pop(node_id, None)
            if srv is not None:
                srv.shutdown()
            if raylet is None:
                return
            if raylet.max_workers > 0:  # driver pseudo-nodes don't count
                note("node_deaths")
            # Queued-but-never-started specs: their node (and its held
            # resources) died with them — reschedule cluster-wide with no
            # attempt charged, they never ran.
            queued, raylet.queued = list(raylet.queued), deque()
            # All workers on the node die.  Their conns are left to the
            # EOF teardown path (on_conn_closed), which reclaims each
            # worker's held references and leases exactly as for a lone
            # worker death.
            for h in list(raylet.workers.values()):
                self._handle_worker_death(h, f"{cause}: node is dead")
            for spec in queued:
                self._schedule(spec)
            # Tear the store down BEFORE reconstruction: a reconstructed
            # task re-creating an output must not collide with (or be
            # resolved against) the dead store's still-linked segments.
            # Spill files survive — they are the durability plane's
            # restore source.
            raylet.shutdown(keep_spilled=True)
            # Objects on the node are lost; recovery order: surviving
            # replica location > lineage reconstruction > spill restore >
            # typed ObjectLostError (never a silent hang).
            for oid, entry in list(self.gcs.objects.items()):
                if node_id not in entry.locations:
                    continue
                entry.locations.discard(node_id)
                entry.segments.pop(node_id, None)
                if entry.inline is not None:
                    continue
                if entry.locations:
                    note("objects_restored")  # a replica carries it
                    continue
                # Mark lost BEFORE recovery: recovery paths that complete
                # (restore, output reconstruct) clear it; an in-flight
                # put re-run leaves it set so _fail_task can fail the put
                # typed if the re-run can never schedule, and get-side
                # probes keep re-entering _try_reconstruct meanwhile.
                entry.lost = True
                if not self._try_reconstruct(oid, entry):
                    self._fail_object_locked(oid, exc.ObjectLostError(
                        f"object {oid} was lost with its node ({cause}) "
                        "and has no lineage, replica, or spill copy to "
                        "recover from"))
            self._drain_pending()
            self._drive_pending_pgs()

    def kill_node(self, node_id: NodeID):
        """Chaos: SIGKILL every worker process on the node, then run the
        node-death protocol — the in-process equivalent of SIGKILLing a
        node agent and its children (no graceful store drain, no worker
        shutdown handshake)."""
        with self._lock:
            raylet = self.raylets.get(node_id)
            if raylet is None:
                return
            self._log_event("kill_node", node=node_id.hex())
            for h in list(raylet.workers.values()):
                try:
                    h.proc.kill()
                except Exception:
                    pass
        self.remove_node(node_id, cause="node killed (chaos)")

    def _fail_object_locked(self, oid: ObjectID, error: BaseException):
        """No recovery path: record the error as the object's value so
        every current waiter and future get raises it (reference: owner
        failure => ObjectLostError, never an indefinite hang)."""
        from ray_tpu_torch._private.recovery import note

        note("objects_lost")
        meta, data = _serialize_error(error)
        self._record_error_result(oid, (meta, data))

    def _on_local_spill(self, oid: ObjectID, node_id: NodeID):
        """A local raylet store wrote a spill/backup file: mirror the
        record into the directory so it can outlive the store (node
        death restore) and the head process (GCS snapshot)."""
        raylet = self.raylets.get(node_id)
        if raylet is None:
            return
        rec = raylet.store.spilled_lookup(oid)
        if rec is not None:
            self.gcs.object_spill_recorded(oid, rec["path"], rec["meta"],
                                           rec["size"], host=None)

    # ================= worker connections =================
    def _accept_loop(self, listener=None, thread_name: str = "rtpu-conn"):
        listener = listener or self._listener
        while not self._shutdown:
            try:
                conn = listener.accept()
            except (OSError, EOFError):
                return
            t = threading.Thread(target=self._conn_loop, args=(conn,),
                                 name=thread_name, daemon=True)
            t.start()

    def _send_on(self, conn, msg) -> bool:
        """Send on a worker/agent/driver connection under its per-conn lock.

        Multiple head threads write to the same Connection (request
        replies, execute pushes, store ops to agents); an unserialized
        multi-chunk send would interleave bytes and corrupt the stream."""
        lock = getattr(conn, "_rtpu_send_lock", None)
        try:
            if lock is not None:
                with lock:
                    conn.send(msg)
            else:
                conn.send(msg)
            return True
        except Exception:
            return False

    def _conn_loop(self, conn):
        conn._rtpu_send_lock = threading.Lock()
        worker_id: Optional[WorkerID] = None
        agent_node: Optional[NodeID] = None
        driver_wid: Optional[bytes] = None
        try:
            while True:
                msg = conn.recv()
                mtype = msg.get("type")
                if agent_node is not None:
                    # Any traffic from an agent refreshes its liveness
                    # lease; the dedicated "heartbeat" frames just bound
                    # the silence of an otherwise-idle node.
                    self.gcs.touch_node(agent_node)
                if mtype == "register":
                    worker_id = WorkerID(msg["worker_id"])
                    self._on_register(worker_id, NodeID(msg["node_id"]), conn,
                                      msg.get("direct_addr"))
                elif mtype == "register_node":
                    agent_node = self.add_remote_node(msg, conn)
                elif mtype == "register_driver":
                    driver_wid = msg["worker_id"]
                    worker_id = WorkerID(driver_wid)
                    self.add_remote_driver(msg, conn)
                elif mtype == "worker_exit":
                    if agent_node is not None:
                        self.on_remote_worker_exit(agent_node, msg)
                elif mtype == "node_stats":
                    if agent_node is not None:
                        self.gcs.update_node_stats(agent_node,
                                                   msg.get("stats") or {})
                        spans = msg.get("spans")
                        if spans:
                            # Agent-relayed span batch riding the stats
                            # cadence (its own ring + worker leftovers).
                            self.trace_store.ingest(spans)
                elif mtype == "heartbeat":
                    pass  # touch_node above already refreshed the lease
                elif mtype == "worker_oom":
                    if agent_node is not None:
                        self.on_worker_oom(WorkerID(msg["worker_id"]),
                                           float(msg.get("usage", 0.0)))
                elif mtype == "object_replicated":
                    if agent_node is not None:
                        self.on_object_replicated(agent_node, msg)
                elif mtype == "object_partial":
                    if agent_node is not None:
                        host = self.node_host.get(agent_node)
                    elif driver_wid is not None:
                        host = self._driver_hosts.get(driver_wid)
                    else:
                        host = self._caller_host(worker_id)
                    self.on_object_partial(msg, host)
                elif mtype == "object_partial_drop":
                    self.on_object_partial_drop(msg)
                elif mtype == "object_evicted":
                    nid = agent_node or (driver_wid and
                                         self._driver_nodes.get(driver_wid))
                    if nid is not None:
                        with self._lock:
                            self._on_object_evicted(ObjectID(msg["oid"]), nid)
                elif mtype == "object_spilled":
                    nid = agent_node or (driver_wid and
                                         self._driver_nodes.get(driver_wid))
                    if nid is not None:
                        with self._lock:
                            raylet = self.raylets.get(nid)
                            if raylet is not None and isinstance(
                                    raylet.store, RemoteStoreProxy):
                                raylet.store.note_spilled(
                                    ObjectID(msg["oid"]), msg["path"],
                                    msg["meta"], msg["size"])
                            # Directory-side copy of the record, tagged
                            # with the owning host: same-host restores
                            # survive the proxy (and the node row) dying.
                            self.gcs.object_spill_recorded(
                                ObjectID(msg["oid"]), msg["path"],
                                msg["meta"], msg["size"],
                                host=self.node_host.get(nid))
                elif mtype == "task_done":
                    self.on_task_done(msg)
                elif mtype == "worker_blocked":
                    self.on_worker_blocked(WorkerID(msg["worker_id"]))
                elif mtype == "worker_unblocked":
                    self.on_worker_unblocked(WorkerID(msg["worker_id"]))
                elif mtype == "seal":
                    self.on_seal(msg)
                elif mtype == "put_inline":
                    self.on_put_inline(msg)
                elif mtype == "seal_batch":
                    self.on_seal_batch(msg)
                elif mtype == "put_inline_batch":
                    self.on_put_inline_batch(msg)
                elif mtype == "arena_release":
                    self.on_arena_release(msg)
                elif mtype == "request":
                    self._handle_request(msg, conn, worker_id)
                elif mtype == "notify":
                    # One-way request: no reply frame (hot-path submits).
                    try:
                        tc = msg.get("tc")
                        if tc is not None and self._tracing_on():
                            from ray_tpu_torch import observability as obs

                            with obs.use_context(tuple(tc)):
                                self.handle_request(
                                    msg["op"], msg.get("payload") or {},
                                    lambda *a, **k: None, worker_id)
                        else:
                            self.handle_request(
                                msg["op"], msg.get("payload") or {},
                                lambda *a, **k: None, worker_id)
                    except Exception:
                        traceback.print_exc()
        except (EOFError, OSError, BrokenPipeError):
            pass
        except Exception:
            traceback.print_exc()
        finally:
            # Teardown is identity-checked: a peer that already
            # RE-registered over a fresh connection (head failover /
            # transient drop) must not be torn down by its old socket's
            # delayed EOF.
            if agent_node is not None:
                raylet = self.raylets.get(agent_node)
                if raylet is not None \
                        and getattr(raylet, "agent_conn", None) is conn:
                    self.remove_node(agent_node)
            elif driver_wid is not None:
                if self._driver_conns.get(driver_wid) is conn:
                    self.on_driver_disconnected(driver_wid)
            elif worker_id is not None:
                if self._conns.get(worker_id) is conn:
                    self.on_conn_closed(worker_id)

    def on_remote_worker_exit(self, node_id: NodeID, msg: dict):
        """Agent reported one of its worker subprocesses exited — mirrors
        the local health-monitor poll path."""
        with self._lock:
            raylet = self.raylets.get(node_id)
            if raylet is None:
                return
            h = raylet.workers.get(WorkerID(msg["worker_id"]))
            if h is None:
                return
            h.proc.returncode = msg.get("code", -1)
            if h.conn is None:
                raylet.num_starting = max(0, raylet.num_starting - 1)
                raylet.consecutive_start_failures += 1
            self._handle_worker_death(
                h, f"worker process exited with code {msg.get('code')}")
            raylet.on_worker_lost(h.worker_id)
            self._conns.pop(h.worker_id, None)
            raylet.try_dispatch()

    def on_worker_oom(self, worker_id: WorkerID, usage: float):
        """A node agent's memory monitor is about to kill (or just killed)
        one of its workers: mark the victim's running task so its death
        surfaces as a typed, retryable OutOfMemoryError instead of a
        generic WorkerCrashedError (the head-side monitor marks its own
        victims the same way in memory_monitor.tick)."""
        from ray_tpu_torch._private.recovery import note

        with self._lock:
            _, h = self._find_worker(worker_id)
            if h is None or h.current_task is None:
                return
            note("oom_worker_kills")
            self._oom_killed[h.current_task.task_id] = usage

    def on_object_replicated(self, node_id: NodeID, msg: dict):
        """An agent finished pulling a durability replica into its store:
        register the new location (readers on that host resolve the
        replica's own segment name, never the primary's)."""
        from ray_tpu_torch._private.recovery import note

        oid = ObjectID(msg["oid"])
        with self._lock:
            key = (oid, node_id)
            was_prefetch = key in self._prefetch_inflight
            if node_id not in self.raylets:
                if was_prefetch:
                    self._finish_prefetch(key, msg["size"], False)
                return  # replica landed after the node died: useless
            self.gcs.object_sealed(oid, node_id, msg["size"],
                                   meta=msg.get("meta"),
                                   segment=msg.get("segment"))
            note("objects_replicated")
            if was_prefetch:
                self._finish_prefetch(key, msg["size"], True)
            # Same-host waiters (e.g. a queued task's worker about to
            # resolve this arg) can now attach the replica segment.
            self._notify_object(oid)

    def on_driver_disconnected(self, driver_wid: bytes):
        with self._lock:
            self._driver_hosts.pop(driver_wid, None)
            self._driver_conns.pop(driver_wid, None)
            self._drop_partials_for(driver_wid)
            node_id = self._driver_nodes.pop(driver_wid, None)
        if node_id is not None:
            self.remove_node(node_id)
        freed = self.gcs.remove_all_references(driver_wid)
        with self._lock:
            self._reclaim_lessee_locked(driver_wid)
            for oid in freed:
                self._free_object(oid)
            self._drain_pending()
            self._drive_pending_pgs()

    def _reclaim_lessee_locked(self, lessee: bytes):
        """Lessee (worker or remote driver) died: release every worker
        lease it held plus its arena leases — leaked leases are permanent
        capacity loss (reference: lease reclaim on lessee death,
        lease_policy / raylet).  Under the head lock."""
        for raylet in self.raylets.values():
            for h in list(raylet.workers.values()):
                if h.leased_to == lessee:
                    self._release_lease_locked(raylet, h)
        self._drop_arena_leases_for(lessee)

    def _on_register(self, worker_id: WorkerID, node_id: NodeID, conn,
                     direct_addr=None):
        with self._lock:
            self._conns[worker_id] = conn
            raylet = self.raylets.get(node_id)
            if raylet is None:
                # Failover race: this worker's node agent has not
                # re-registered yet — park the registration.
                self._pending_worker_regs[node_id].append(
                    (worker_id, conn, direct_addr))
                return
            h = raylet.on_worker_registered(worker_id, conn, direct_addr)
            self._try_readopt_actor(raylet, node_id, worker_id, h)
            raylet.try_dispatch()

    def _try_readopt_actor(self, raylet, node_id, worker_id, h):
        """Head-failover re-adoption: a surviving actor worker came back —
        re-bind its restored actor record (state intact in the worker
        process) instead of pooling the worker.  Under the head lock."""
        for info in self.gcs.actors.values():
            if info.reconnect_worker_id == worker_id:
                info.reconnect_worker_id = None
                if h is not None:
                    h.actor_id = info.actor_id
                    h.busy = True
                    try:
                        raylet.idle.remove(worker_id)
                    except ValueError:
                        pass
                info.resources_held = True
                self.scheduler.reacquire(node_id, info.creation_spec)
                self.gcs.actor_started(info.actor_id, node_id, worker_id)
                self._notify_actor_waiters(info.actor_id)
                calls, info.pending_calls = info.pending_calls, []
                for call in calls:
                    self._push_actor_task(info, call)
                return

    def _reap_unreconnected_actors(self):
        """After the reconnect window, restored actors whose worker never
        came back go through the normal death path (restart budget or
        DEAD) — called under the head lock from the monitor loop."""
        if self._reconnect_reaped:
            return
        import time as _time

        from ray_tpu_torch._private.config import CONFIG

        if _time.monotonic() - self._boot_time < CONFIG.reconnect_window_s:
            return
        self._reconnect_reaped = True
        # Parked worker registrations whose node never re-registered:
        # close them out (the workers give up their own reconnect loops).
        for regs in self._pending_worker_regs.values():
            for _wid, wconn, _d in regs:
                try:
                    wconn.close()
                except Exception:
                    pass
        self._pending_worker_regs.clear()
        for info in list(self.gcs.actors.values()):
            if info.reconnect_worker_id is None:
                continue
            info.reconnect_worker_id = None
            self._on_actor_worker_death(
                info.actor_id,
                "actor worker did not reconnect after head restart")

    def on_conn_closed(self, worker_id: WorkerID):
        with self._lock:
            self._conns.pop(worker_id, None)
            for raylet in self.raylets.values():
                h = raylet.workers.get(worker_id)
                if h is not None:
                    self._handle_worker_death(h, "worker process died")
                    raylet.on_worker_lost(worker_id)
                    raylet.try_dispatch()
                    break
            self._reclaim_lessee_locked(worker_id.binary())
            freed = self.gcs.remove_all_references(worker_id.binary())
            for oid in freed:
                self._free_object(oid)
            self._drain_pending()
            self._drive_pending_pgs()

    def send_to_worker(self, worker: WorkerHandle, msg: dict):
        if not self._send_on(worker.conn, msg):
            self.on_conn_closed(worker.worker_id)

    # ================= tracing plane =================
    def _tracing_on(self) -> bool:
        from ray_tpu_torch.util.tracing import tracing_enabled

        return tracing_enabled()

    def _drain_local_spans(self) -> None:
        """Pull the head/driver process's own span ring into the store.
        Workers and agents push theirs over the wire; in-process
        emitters (driver spans, head.<op> spans) are drained whenever
        the store is about to be read."""
        if not self._tracing_on():
            return
        from ray_tpu_torch import observability as obs

        spans = obs.drain_spans()
        if spans:
            self.trace_store.ingest(spans)

    def _log_event(self, kind: str, **detail) -> None:
        self._event_log.append({"ts": time.time(), "event": kind,
                                **detail})

    def _flight_snapshot(self, reason: str,
                         extra: Optional[dict] = None) -> Optional[str]:
        """Snapshot rings + task table + event log into a postmortem
        bundle.  No-op unless a flight-record dir is configured; never
        raises into the death path that triggered it."""
        from ray_tpu_torch.observability.flight_recorder import (
            flight_record_dir,
            write_bundle,
        )

        if flight_record_dir() is None:
            return None
        self._drain_local_spans()
        try:
            tasks = self.gcs.list_tasks()
        except Exception:
            tasks = []
        path = write_bundle(reason, spans=self.trace_store.spans(),
                            tasks=tasks, events=list(self._event_log),
                            extra=extra)
        if path is not None:
            self._log_event("flight_record", reason=reason, path=path)
        return path

    def req_span_batch(self, payload, reply, caller):
        """Span flush from a worker/driver: ingest into the TraceStore."""
        spans = payload.get("spans") or []
        if spans:
            self.trace_store.ingest(spans)
        reply(True)

    def req_flight_record(self, payload, reply, caller):
        """Driver-triggered postmortem snapshot (gang restart handlers,
        MeshGroupError paths)."""
        reply(self._flight_snapshot(
            payload.get("reason") or "manual",
            {"trigger": "request"}))

    def req_traces(self, payload, reply, caller):
        self._drain_local_spans()
        reply(self.trace_store.list_traces(
            limit=int(payload.get("limit") or 50)))

    def req_trace_timeline(self, payload, reply, caller):
        """Raw material for timeline assembly: task rows + the trace's
        spans (all spans when no trace_id) — the client merges them with
        observability.timeline.build_chrome_trace."""
        self._drain_local_spans()
        trace_id = payload.get("trace_id")
        with self._lock:
            tasks = self.gcs.list_tasks()
        if trace_id:
            tasks = [t for t in tasks if t.get("trace_id") == trace_id]
        reply({"tasks": tasks,
               "spans": self.trace_store.spans(trace_id or None)})

    def req_span_summary(self, payload, reply, caller):
        self._drain_local_spans()
        reply(self.trace_store.summary())

    # ================= request router =================
    def _handle_request(self, msg: dict, conn, worker_id: Optional[WorkerID]):
        msg_id = msg["msg_id"]
        op = msg["op"]

        def reply(value=None, error: Optional[BaseException] = None):
            # The op is echoed in the reply frame so client-side fault
            # injection and debugging can address replies by op.
            self._send_on(conn, {"type": "reply", "msg_id": msg_id,
                                 "op": op, "ok": error is None,
                                 "value": value, "error": error})

        tc = msg.get("tc")
        if tc is not None and self._tracing_on():
            from ray_tpu_torch import observability as obs

            with obs.use_context(tuple(tc)):
                self.handle_request_keyed(op, msg.get("payload") or {},
                                          reply, worker_id,
                                          msg.get("rpc_key"))
            return
        self.handle_request_keyed(op, msg.get("payload") or {}, reply,
                                  worker_id, msg.get("rpc_key"))

    def handle_request_keyed(self, op: str, payload: dict,
                             reply: Callable[..., None],
                             caller: Optional[WorkerID] = None,
                             key: Optional[bytes] = None):
        """Keyed entry point: frames carrying an idempotency key pass the
        reply cache first — the first frame per key executes, duplicates
        (resends after a dropped reply, chaos dup injection, reconnect
        resends) are answered from the cached/attached reply and never
        re-applied."""
        if key is not None:
            run, wrapped = self._rpc_cache.admit(key, reply)
            if not run:
                return
            reply = wrapped
        try:
            self.handle_request(op, payload, reply, caller)
        except BaseException as e:  # noqa: BLE001 — errors go to the caller
            reply(error=e)

    def handle_request(self, op: str, payload: dict,
                       reply: Callable[..., None],
                       caller: Optional[WorkerID] = None):
        """Single entry point for worker requests AND direct driver calls."""
        fn = getattr(self, "req_" + op, None)
        if fn is None:
            reply(error=ValueError(f"unknown op {op!r}"))
            return
        # Head-side span: records the op inside the caller's trace.
        # Sitting BELOW the reply-cache admit means a resent frame
        # answered from cache never re-records — the resend-dedup
        # guarantee for head spans.  span_batch itself is exempt (the
        # flush path must not generate spans about shipping spans).
        if op != "span_batch" and self._tracing_on():
            from ray_tpu_torch import observability as obs

            if obs.get_context() is not None:
                t0 = time.time()
                try:
                    fn(payload, reply, caller)
                finally:
                    obs.record("head." + op, t0, time.time())
                return
        fn(payload, reply, caller)

    def req_notify_msg(self, payload, reply, caller):
        """Acked notify: a one-way message routed through the keyed
        request path (chaos / rpc_acked_ops), so a dropped seal or
        task_done is retried by its sender and a duplicated frame is
        deduplicated by the reply cache instead of double-applying."""
        msg = payload["msg"]
        t = msg.get("type")
        fn = {
            "seal": self.on_seal,
            "put_inline": self.on_put_inline,
            "seal_batch": self.on_seal_batch,
            "put_inline_batch": self.on_put_inline_batch,
            "task_done": self.on_task_done,
            "arena_sealed": self.on_arena_sealed,
            "arena_release": self.on_arena_release,
            "worker_blocked":
                lambda m: self.on_worker_blocked(WorkerID(m["worker_id"])),
            "worker_unblocked":
                lambda m: self.on_worker_unblocked(WorkerID(m["worker_id"])),
            "object_partial":
                lambda m: self.on_object_partial(m,
                                                 self._caller_host(caller)),
            "object_partial_drop": self.on_object_partial_drop,
        }.get(t)
        if fn is None:
            reply(error=ValueError(f"notify_msg cannot route {t!r}"))
            return
        fn(msg)
        reply(True)

    # ----- ops -----
    def req_submit(self, payload, reply, caller):
        self.submit_task(payload["spec"])
        reply(True)

    def req_resolve_batch(self, payload, reply, caller):
        """Resolve many objects in one round trip: returns {hex: msg} for
        every object that is available RIGHT NOW (arena leases granted as
        in req_get_locations); callers fall back to the blocking per-object
        path for the rest.  Collapses the driver's get([refs...]) from one
        request per ref to one request per batch."""
        caller_host = self._caller_host(caller)
        out = {}
        with self._lock:
            for oid in payload["oids"]:
                resolved = self._resolve_object(oid, caller_host=caller_host)
                if resolved is not None:
                    if resolved.get("kind") == "arena":
                        self._grant_arena_lease(oid, caller)
                    self._note_pull_resolution(resolved)
                    out[oid.binary()] = resolved
        reply(out)

    def req_get_locations(self, payload, reply, caller):
        """Resolve an object: reply immediately if available, else defer."""
        oid: ObjectID = payload["oid"]
        timeout = payload.get("timeout")
        caller_host = self._caller_host(caller)
        with self._lock:
            resolved = self._resolve_object(oid, caller_host=caller_host)
            if resolved is not None:
                if resolved.get("kind") == "arena":
                    self._grant_arena_lease(oid, caller)
                if not payload.get("recheck"):
                    # A puller re-confirming its resolution already paid
                    # the wire-bytes count at the original handout.
                    self._note_pull_resolution(resolved)
                reply(resolved)
                return
            entry = self.gcs.object_lookup(oid)
            if entry is not None and entry.lost:
                if not self._try_reconstruct(oid, entry):
                    reply(error=exc.ObjectLostError(f"{oid} lost and not reconstructable"))
                    return
                # A spill restore completes synchronously (its notify ran
                # before this waiter registered): re-resolve now instead
                # of parking a callback nothing will ever fire.
                resolved = self._resolve_object(oid, caller_host=caller_host)
                if resolved is not None:
                    if resolved.get("kind") == "arena":
                        self._grant_arena_lease(oid, caller)
                    self._note_pull_resolution(resolved)
                    reply(resolved)
                    return
            cb_list = self._object_waiters[oid]
            record = {"done": False}

            def cb(_ready_oid):
                if record["done"]:
                    return
                # Re-resolve for THIS caller's host: different waiters on
                # different hosts need different resolutions.
                resolved_msg = self._resolve_object(oid,
                                                    caller_host=caller_host)
                if resolved_msg is None:
                    return
                record["done"] = True
                if resolved_msg.get("kind") == "arena":
                    self._grant_arena_lease(oid, caller)
                self._note_pull_resolution(resolved_msg)
                reply(resolved_msg)

            cb_list.append(cb)
        if timeout is not None:
            def on_timeout():
                with self._lock:
                    if not record["done"]:
                        record["done"] = True
                        reply(error=exc.GetTimeoutError(f"get({oid}) timed out"))
            t = threading.Timer(timeout, on_timeout)
            t.daemon = True
            t.start()

    def req_wait_ready(self, payload, reply, caller):
        """ray.wait: reply once num_returns of the refs are ready (or timeout).
        Reply value is the set of ready oids at that moment."""
        oids: List[ObjectID] = payload["oids"]
        num_returns = payload["num_returns"]
        timeout = payload.get("timeout")
        state = {"done": False}

        def check_and_reply(locked: bool):
            ready = [o for o in oids if self._resolve_object(o, peek=True) is not None]
            if len(ready) >= num_returns and not state["done"]:
                state["done"] = True
                reply([o.binary() for o in ready])
                return True
            return False

        with self._lock:
            if check_and_reply(True):
                return
            for o in oids:
                if self._resolve_object(o, peek=True) is None:
                    def cb(_msg, _o=o):
                        with self._lock:
                            check_and_reply(True)
                    self._object_waiters[o].append(cb)
        if timeout is not None:
            def on_timeout():
                with self._lock:
                    if not state["done"]:
                        state["done"] = True
                        ready = [o.binary() for o in oids
                                 if self._resolve_object(o, peek=True) is not None]
                        reply(ready)
            t = threading.Timer(timeout, on_timeout)
            t.daemon = True
            t.start()

    def req_add_ref(self, payload, reply, caller):
        holder = payload.get("holder") or (caller.binary() if caller else b"driver")
        self.gcs.add_reference(payload["oid"], holder)
        reply(True)

    def req_remove_ref(self, payload, reply, caller):
        holder = payload.get("holder") or (caller.binary() if caller else b"driver")
        oid = payload["oid"]
        with self._lock:
            if self.gcs.remove_reference(oid, holder):
                self._free_object(oid)
        reply(True)

    def req_remove_ref_batch(self, payload, reply, caller):
        """Coalesced ref drops (the worker's ref-gc drainer): one message
        and one lock acquisition for a burst of K dropped ObjectRefs."""
        holder = payload.get("holder") or (caller.binary() if caller else b"driver")
        with self._lock:
            for oid_bin in payload["oids"]:
                oid = ObjectID(oid_bin)
                if self.gcs.remove_reference(oid, holder):
                    self._free_object(oid)
        reply(True)

    def req_job_config(self, payload, reply, caller):
        from ray_tpu_torch._private.ids import JobID as _JobID

        reply(self.gcs.get_job_config(_JobID(payload["job_id"])))

    def req_kv(self, payload, reply, caller):
        verb = payload["verb"]
        ns = payload.get("namespace", "default")
        if verb == "put":
            reply(self.gcs.kv_put(payload["key"], payload["value"], ns,
                                  payload.get("overwrite", True)))
        elif verb == "get":
            reply(self.gcs.kv_get(payload["key"], ns))
        elif verb == "del":
            self.gcs.kv_del(payload["key"], ns)
            reply(True)
        elif verb == "keys":
            reply(self.gcs.kv_keys(payload.get("prefix", b""), ns))
        else:
            reply(error=ValueError(f"bad kv verb {verb}"))

    def req_create_actor(self, payload, reply, caller):
        spec: TaskSpec = payload["spec"]
        with self._lock:
            self.gcs.register_actor(spec)
            self.submit_task(spec)
        reply(True)

    def req_actor_call(self, payload, reply, caller):
        spec: TaskSpec = payload["spec"]
        self.submit_actor_task(spec, dead_worker=payload.get("dead_worker"))
        reply(True)

    def req_wait_actor_alive(self, payload, reply, caller):
        actor_id: ActorID = payload["actor_id"]
        with self._lock:
            info = self.gcs.get_actor_info(actor_id)
            if info is None:
                reply(error=ValueError(f"unknown actor {actor_id}"))
                return
            if info.state == ActorState.ALIVE:
                reply(True)
                return
            if info.state == ActorState.DEAD:
                reply(error=exc.ActorDiedError(info.death_cause or "actor dead"))
                return
            self._actor_waiters[actor_id].append(reply)

    def req_get_actor(self, payload, reply, caller):
        actor_id = self.gcs.get_named_actor(payload["name"],
                                            payload.get("namespace", "default"))
        if actor_id is None:
            reply(error=ValueError(f"no actor named {payload['name']!r}"))
            return
        info = self.gcs.get_actor_info(actor_id)
        reply({"actor_id": actor_id, "creation_spec": info.creation_spec})

    def req_kill_actor(self, payload, reply, caller):
        self.kill_actor(payload["actor_id"],
                        no_restart=payload.get("no_restart", True))
        reply(True)

    def req_create_pg(self, payload, reply, caller):
        pg = PlacementGroupInfo(payload["pg_id"], payload["bundles"],
                                payload["strategy"], payload.get("name", ""))
        with self._lock:
            if not self.scheduler.pg_feasible(pg):
                pg.state = "INFEASIBLE"
                self.scheduler.placement_groups[pg.pg_id] = pg
                self.gcs.publish("PG", ("INFEASIBLE", pg.pg_id))
                reply(error=exc.PlacementGroupSchedulingError(
                    f"placement group infeasible: {payload['bundles']}"))
                return
            if self.scheduler.create_placement_group(pg):
                self.gcs.publish("PG", ("CREATED", pg.pg_id))
                reply("CREATED")
            else:
                self._pending_pgs.append(pg)
                self._pg_waiters[pg.pg_id].append(reply)

    def req_pg_ready(self, payload, reply, caller):
        pg_id = payload["pg_id"]
        timeout = payload.get("timeout")
        with self._lock:
            pg = self.scheduler.placement_groups.get(pg_id)
            if pg is not None and pg.state == "CREATED":
                reply("CREATED")
                return
            if pg is not None and pg.state == "INFEASIBLE":
                reply(error=exc.PlacementGroupSchedulingError(
                    "placement group is infeasible on this cluster"))
                return
            state = {"done": False}

            def cb(value=None, error=None):
                if not state["done"]:
                    state["done"] = True
                    reply(value, error=error)

            self._pg_waiters[pg_id].append(cb)
        if timeout is not None:
            def on_timeout():
                with self._lock:
                    if not state["done"]:
                        state["done"] = True
                        reply(error=exc.GetTimeoutError("placement group not ready"))
            t = threading.Timer(timeout, on_timeout)
            t.daemon = True
            t.start()

    def req_remove_pg(self, payload, reply, caller):
        with self._lock:
            self.scheduler.remove_placement_group(payload["pg_id"])
            self._pending_pgs = [p for p in self._pending_pgs
                                 if p.pg_id != payload["pg_id"]]
            self._drain_pending()
        reply(True)

    def req_state(self, payload, reply, caller):
        what = payload["what"]
        fn = {
            "actors": self.gcs.list_actors,
            "nodes": self.gcs.list_nodes,
            "tasks": self.gcs.list_tasks,
            "objects": self.gcs.list_objects,
            "jobs": self.gcs.list_jobs,
            "named_actors": self.gcs.list_named_actors,
        }.get(what)
        if fn is None:
            reply(error=ValueError(f"cannot list {what!r}"))
        else:
            reply(fn())

    def req_object_info(self, payload, reply, caller):
        """Directory metadata for an object (size, locations) — used by the
        streaming data executor to convert a store byte budget into an
        in-flight block bound."""
        with self._lock:
            entry = self.gcs.object_lookup(payload["oid"])
            if entry is None:
                reply(None)
                return
            reply({"size": entry.size,
                   "inline": entry.inline is not None,
                   "num_locations": len(entry.locations)})

    def req_cluster_resources(self, payload, reply, caller):
        if payload.get("available"):
            reply(self.scheduler.available_resources())
        else:
            reply(self.scheduler.total_resources())

    def req_cancel(self, payload, reply, caller):
        self.cancel_task(payload["task_id"])
        reply(True)

    # ----- direct transport: leases + actor addresses -----
    def req_lease_worker(self, payload, reply, caller):
        """Grant the caller a worker lease for a scheduling class: pick a
        node + idle worker, hold the resources for the lease's lifetime, and
        hand back the worker's direct address.  None = nothing available
        right now (caller falls back to the classic path and retries).
        Reference: raylet lease grant, node_manager.cc:1817 + lease caching
        in direct_task_transport.h:57."""
        from ray_tpu_torch._private.ids import JobID as _JobID

        spec = TaskSpec(task_id=TaskID.from_random(), job_id=_JobID.nil(),
                        task_type=TaskType.NORMAL, name="__lease__",
                        resources=dict(payload["resources"]))
        with self._lock:
            try:
                node_id = self.scheduler.pick_node(spec)
            except Infeasible as e:
                reply(error=exc.RayTpuError(str(e)))
                return
            if node_id is None:
                reply(None)
                return
            raylet = self.raylets[node_id]
            h = raylet._pop_idle(spec)
            if h is None or h.direct_addr is None:
                if h is not None:  # claimed but not direct-capable
                    raylet.idle.append(h.worker_id)
                raylet.ensure_worker(spec)
                self.scheduler.return_resources(node_id, spec)
                reply(None)
                return
            h.busy = True
            h.leased_to = caller.binary() if caller else b"driver"
            h.lease_spec = spec
            reply({"worker_id": h.worker_id.binary(),
                   "addr": h.direct_addr})

    def _release_lease_locked(self, raylet, h):
        if h.leased_to is None:
            return
        if h.blocked:
            h.blocked = False  # resources already released at block time
        else:
            self.scheduler.return_resources(h.node_id, h.lease_spec)
        h.leased_to = None
        h.lease_spec = None
        raylet.release_worker(h)

    # ----- blocked-worker resource release (reference: the raylet's
    # NotifyDirectCallTaskBlocked/Unblocked handling — a worker blocked in
    # get() yields its cpu so dependency producers can schedule; unblock
    # re-acquires, possibly oversubscribing until something finishes;
    # local_task_manager.cc ReleaseCpuResourcesFromBlockedWorker) -----
    def on_worker_blocked(self, worker_id: WorkerID):
        with self._lock:
            raylet, h = self._find_worker(worker_id)
            if h is None or h.blocked or h.actor_id is not None:
                return
            spec = h.current_task if h.current_task is not None \
                else h.lease_spec
            if spec is None:
                return
            h.blocked = True
            self.scheduler.return_resources(h.node_id, spec)
            self._drain_pending()
            raylet.try_dispatch()

    def on_worker_unblocked(self, worker_id: WorkerID):
        with self._lock:
            _, h = self._find_worker(worker_id)
            if h is None or not h.blocked:
                return
            h.blocked = False
            spec = h.current_task if h.current_task is not None \
                else h.lease_spec
            if spec is not None:
                self.scheduler.reacquire(h.node_id, spec)

    def req_return_lease(self, payload, reply, caller):
        wid = WorkerID(payload["worker_id"])
        with self._lock:
            raylet, h = self._find_worker(wid)
            if h is not None:
                self._release_lease_locked(raylet, h)
            self._drain_pending()
            self._drive_pending_pgs()
        reply(True)

    def req_actor_direct_addr(self, payload, reply, caller):
        """Resolve an actor to its worker's direct address, deferring while
        the actor is pending/restarting (reference: the actor table
        subscription that feeds direct_actor_task_submitter.h)."""
        actor_id: ActorID = payload["actor_id"]

        def send_addr(_val=None, error=None):
            if error is not None:
                reply(None, error=error)
                return
            with self._lock:
                info = self.gcs.get_actor_info(actor_id)
                if info is None or info.worker_id is None:
                    reply(error=exc.ActorDiedError("actor is gone"))
                    return
                _, h = self._find_worker(info.worker_id)
                if h is None or h.direct_addr is None:
                    reply(None)  # not direct-capable: classic path
                    return
                reply({"worker_id": info.worker_id.binary(),
                       "addr": h.direct_addr})

        with self._lock:
            info = self.gcs.get_actor_info(actor_id)
            if info is None:
                reply(error=ValueError(f"unknown actor {actor_id}"))
                return
            if info.state == ActorState.DEAD:
                reply(error=exc.ActorDiedError(
                    info.death_cause or "actor dead"))
                return
            if info.state == ActorState.ALIVE:
                pass  # fall through to send_addr below
            else:
                self._actor_waiters[actor_id].append(send_addr)
                return
        send_addr()

    def req_kill_worker(self, payload, reply, caller):
        """Coarse cancel of a direct task: kill its leased worker (classic
        cancel semantics — force=True kills the executing process)."""
        wid = WorkerID(payload["worker_id"])
        with self._lock:
            _, h = self._find_worker(wid)
            if h is not None:
                try:
                    h.proc.kill()
                except Exception:
                    pass
        reply(True)

    # ================= task manager =================
    def submit_task(self, spec: TaskSpec):
        from ray_tpu_torch._private.chaos import maybe_delay

        maybe_delay("submit")
        with self._lock:
            self.gcs.record_task_event(TaskEvent(
                spec.task_id, spec.name, TaskStatus.PENDING,
                attempt=spec.attempt, type=spec.task_type.name,
                parent_task_id=spec.parent_task_id,
                trace_id=spec.trace_ctx[0] if spec.trace_ctx else None))
            if spec.task_type != TaskType.ACTOR_CREATION:
                self.gcs.record_lineage(spec)
            # Pin arg refs for the task's lifetime (owner-side arg pinning,
            # reference: dependency_manager.h).
            for arg in list(spec.args) + list(spec.kwargs.values()):
                for oid in ([arg.ref] if arg.ref is not None else []) + arg.contained:
                    self.gcs.add_reference(oid, b"task:" + spec.task_id.binary())
            self._schedule(spec)

    def _schedule(self, spec: TaskSpec):
        if self._park_if_unready(spec):
            return
        locality, arg_bytes = self._arg_locality(spec)
        try:
            node_id = self.scheduler.pick_node(spec, locality=locality)
        except Infeasible as e:
            self._fail_task(spec, exc.PlacementGroupSchedulingError(str(e))
                            if spec.scheduling_strategy.kind == "PLACEMENT_GROUP"
                            else exc.RayTpuError(str(e)))
            return
        if node_id is None:
            self.pending.append(spec)
            return
        self._note_locality_placement(spec, node_id, arg_bytes)
        raylet = self.raylets[node_id]
        self.gcs.update_task_status(spec.task_id, TaskStatus.SCHEDULED,
                                    node_id=node_id)
        raylet.queue_task(spec)

    # ---------- arg-locality plane ----------
    @staticmethod
    def _iter_arg_refs(spec: TaskSpec, direct_only: bool = False):
        """Directory-tracked ObjectRef args of a task, deduplicated.
        Owner-resident refs (arg.owner set) resolve worker→owner and are
        invisible to the directory — skipped.  Contained refs (nested in
        arg values, materialized lazily inside the task) count for
        locality scoring but never gate dispatch (direct_only)."""
        seen = set()
        for arg in list(spec.args) + list(spec.kwargs.values()):
            refs = [arg.ref] if arg.ref is not None and arg.owner is None \
                else []
            if not direct_only:
                refs += list(arg.contained)
            for oid in refs:
                if oid not in seen:
                    seen.add(oid)
                    yield oid

    def _park_if_unready(self, spec: TaskSpec) -> bool:
        """Locality gate: hold a task whose directly-passed ref args don't
        exist anywhere yet (no value, no holder, no spill record) until
        they seal — placement then sees real byte locations instead of
        racing the producer (reference: the raylet's dependency manager
        dispatches tasks only once args are ready, dependency_manager.h).
        Lost args trigger reconstruction; unrecoverable ones get a typed
        error value so the task still dispatches and fails loudly.
        Returns True when the task was parked (re-scheduled from
        _notify_object when the first missing arg becomes available)."""
        if not self._locality_on:
            return False
        for oid in self._iter_arg_refs(spec, direct_only=True):
            entry = self.gcs.object_lookup(oid)
            if entry is not None and entry.lost:
                if not self._try_reconstruct(oid, entry):
                    self._fail_object_locked(oid, exc.ObjectLostError(
                        f"task arg {oid} was lost and cannot be "
                        f"reconstructed"))
                entry = self.gcs.object_lookup(oid)
            if entry is not None and (entry.inline is not None
                                      or entry.locations
                                      or entry.spill is not None):
                continue  # a value, a holder, or a restorable copy exists
            self._dep_parked[oid].append(spec)
            return True
        return False

    def _arg_locality(self, spec: TaskSpec):
        """(locality, arg_bytes) for a task's ref args: ``locality`` maps
        node -> resident arg bytes on that node's HOST (any node on the
        holder's host reads via zero-copy segment attach, so the signal
        is host-level); ``arg_bytes`` lists (oid, size, hosts, entry)
        per sized directory arg, reused for hit/miss metrics and
        prefetch targeting after placement."""
        if not self._locality_on:
            return None, []
        arg_bytes = []
        host_bytes: Dict[str, float] = {}
        for oid in self._iter_arg_refs(spec):
            entry = self.gcs.object_lookup(oid)
            if entry is None or entry.inline is not None \
                    or not entry.locations or not entry.size:
                continue
            hosts = {self.node_host.get(nid, self.host_key)
                     for nid in entry.locations}
            arg_bytes.append((oid, entry.size, hosts, entry))
            for hk in hosts:
                host_bytes[hk] = host_bytes.get(hk, 0.0) + entry.size
        if not host_bytes:
            return None, arg_bytes
        locality = {nid: host_bytes[hk]
                    for nid, hk in self.node_host.items()
                    if host_bytes.get(hk)}
        return (locality or None), arg_bytes

    def _note_locality_placement(self, spec: TaskSpec, node_id: NodeID,
                                 arg_bytes) -> None:
        """Post-placement accounting + prefetch kick: count how many arg
        bytes the chosen host already holds, and start pulling the rest
        into the chosen node's store while the task is still queued."""
        if not self._locality_on or not arg_bytes:
            return
        chosen_host = self.node_host.get(node_id, self.host_key)
        local = remote = 0.0
        missing = []
        for oid, size, hosts, entry in arg_bytes:
            if chosen_host in hosts:
                local += size
            else:
                remote += size
                missing.append((oid, size, entry))
        self._loc_counter_add("sched_locality_tasks_total", 1)
        self._loc_counter_add("sched_locality_hits_total"
                              if not missing else
                              "sched_locality_misses_total", 1)
        if local:
            self._loc_counter_add("sched_locality_local_arg_bytes_total",
                                  local)
            if self._has_remote:
                # Bytes that stayed off the wire because placement
                # followed them (only meaningful once a wire exists).
                self._loc_counter_add(
                    "sched_locality_transfer_bytes_avoided_total", local)
        if remote:
            self._loc_counter_add("sched_locality_remote_arg_bytes_total",
                                  remote)
        tot_l = self._loc_counters.get(
            "sched_locality_local_arg_bytes_total", 0.0)
        tot_r = self._loc_counters.get(
            "sched_locality_remote_arg_bytes_total", 0.0)
        if tot_l + tot_r > 0:
            self._loc_gauge_set("sched_locality_local_bytes_fraction",
                                tot_l / (tot_l + tot_r))
        if missing and self._locality_prefetch:
            for oid, size, entry in missing:
                self._start_prefetch(spec, oid, size, entry, node_id,
                                     chosen_host)

    def _loc_counter_add(self, name: str, delta: float) -> None:
        """Bump a sched_locality_* counter; write-through to the GCS KV
        metrics namespace so /metrics (util.metrics.prometheus_text)
        exports it.  In-process dict + pickle — cheap per placement."""
        val = self._loc_counters.get(name, 0.0) + delta
        self._loc_counters[name] = val
        try:
            self.gcs.kv_put((name + "|").encode(), pickle.dumps(val),
                            namespace="metrics")
        except Exception:
            pass

    def _loc_gauge_set(self, name: str, value: float) -> None:
        self._loc_counters[name] = value
        try:
            self.gcs.kv_put((name + "|").encode(), pickle.dumps(value),
                            namespace="metrics")
        except Exception:
            pass

    def locality_stats(self) -> dict:
        """Locality-plane counters + the recent prefetch wall-stamp log
        (smoke/bench proof surface; counters mirror /metrics)."""
        with self._lock:
            return {"counters": dict(self._loc_counters),
                    "prefetch": [dict(r) for r in self._prefetch_log]}

    def _note_pull_resolution(self, resolved: Optional[dict]) -> None:
        """A cross-host "pull" resolution handed to a real caller == that
        many bytes about to cross the transfer plane on demand.  Counted
        ONLY at the resolution-handout sites (req_resolve_batch /
        req_get_locations) — _notify_object's availability probe also
        calls _resolve_object and must not double-count."""
        if resolved is not None and resolved.get("kind") == "pull":
            self._loc_counter_add("sched_locality_wire_bytes_total",
                                  resolved.get("size") or 0)
            self._loc_counter_add("sched_locality_pull_resolutions_total", 1)

    def _start_prefetch(self, spec: TaskSpec, oid: ObjectID, size: int,
                        entry, node_id: NodeID, chosen_host: str) -> None:
        """Pull a missing arg into the chosen node's store while its task
        is still queued (worker spawn / dispatch overlaps the wire).
        Rides the durability plane's store-to-store machinery: replica
        segments are uniquely named, so a racing demand pull by the
        worker can never collide.  Under the head lock."""
        key = (oid, node_id)
        if key in self._prefetch_inflight:
            return
        addrs = []
        for nid in entry.locations:
            if self.node_host.get(nid, self.host_key) == chosen_host:
                return  # already resident on the target host
            addr = self.node_xfer.get(nid)
            if addr is not None:
                addrs.append(tuple(addr))
        raylet = self.raylets.get(node_id)
        if not addrs or raylet is None:
            return  # no pullable holder: the worker's demand path covers it
        self._prefetch_inflight.add(key)
        rec = {"oid": oid.hex(), "node": node_id.hex(),
               "task": spec.task_id.hex(), "bytes": size,
               "start": time.time(), "done": None, "ok": None}
        self._prefetch_recs[key] = rec
        self._prefetch_log.append(rec)
        self._loc_counter_add("sched_locality_prefetch_started_total", 1)
        if isinstance(raylet, RemoteRaylet):
            # The agent pulls into its own store and acks with
            # object_replicated (the durability wire protocol), which
            # registers the location and completes the record.  Partial
            # holders ride along so the agent stripes a big prefetch
            # across every source instead of one stream off addrs[0].
            msg = {"type": "store_pull", "oid": oid.binary(),
                   "addr": list(addrs[0]),
                   "addrs": [list(a) for a in addrs],
                   "size": size, "meta": entry.meta}
            psources, pchunk, _ = self._partial_sources_locked(
                entry, chosen_host)
            if psources:
                seen = {tuple(a) for a in addrs}
                msg["sources"] = [[list(a), None] for a in addrs] + [
                    s for s in psources if tuple(s[0]) not in seen]
                msg["chunk"] = pchunk
            raylet.send_agent(msg)
        else:
            if self._prefetch_q is None:
                import queue as _queue

                self._prefetch_q = _queue.Queue()
                threading.Thread(target=self._prefetch_loop,
                                 name="rtpu-prefetch", daemon=True).start()
            self._prefetch_q.put((oid, node_id, addrs, size))

    _PREFETCH_ATTEMPTS = 5  # seal→store_adopt race on the source agent

    def _prefetch_loop(self):
        """Head-side prefetch worker: store-to-store pulls into local
        (in-head) raylet stores.  Failures are silent — the worker's
        demand pull at materialization time is the correctness path."""
        import time as _time

        while not self._shutdown:
            item = self._prefetch_q.get()
            if item is None:
                return
            oid, node_id, addrs, size = item
            meta = data = None
            for attempt in range(self._PREFETCH_ATTEMPTS):
                for addr in addrs:
                    try:
                        meta, data = self._repl_pull(addr, oid)
                        break
                    except Exception:
                        meta = data = None
                if data is not None or self._shutdown:
                    break
                _time.sleep(0.05 * (2 ** attempt))
            ok = False
            if data is not None:
                with self._lock:
                    raylet = self.raylets.get(node_id)
                    entry = self.gcs.object_lookup(oid)
                    if raylet is not None and entry is not None \
                            and entry.inline is None and not entry.lost:
                        try:
                            seg = raylet.store.put_replica(oid, meta, data)
                            self.gcs.object_sealed(oid, node_id, len(data),
                                                   meta=meta, segment=seg)
                            ok = True
                        except Exception:
                            traceback.print_exc()
                    if ok:
                        self._notify_object(oid)
            self._finish_prefetch((oid, node_id),
                                  len(data) if data is not None else size, ok)

    def _finish_prefetch(self, key: tuple, nbytes: int, ok: bool) -> None:
        with self._lock:
            self._prefetch_inflight.discard(key)
            rec = self._prefetch_recs.pop(key, None)
            if rec is None:
                return
            rec["done"] = time.time()
            rec["ok"] = bool(ok)
            if ok:
                self._loc_counter_add("sched_locality_prefetch_done_total", 1)
                self._loc_counter_add("sched_locality_prefetch_bytes_total",
                                      nbytes)
                self._loc_counter_add(
                    "sched_locality_prefetch_overlap_seconds_total",
                    max(0.0, rec["done"] - rec["start"]))

    def submit_actor_task(self, spec: TaskSpec,
                          dead_worker: Optional[bytes] = None):
        """Route an actor task to the actor's dedicated worker, or queue it
        while the actor is pending/restarting (reference: direct actor task
        submitter's per-actor ordered queue,
        transport/direct_actor_task_submitter.h:67).

        ``dead_worker`` marks a budget-exhausted call rerouted off a dead
        direct channel: it may only land on the SAME incarnation (whose
        death processing will then fail it authoritatively).  If the
        actor has restarted — or is restarting — the call belongs to the
        dead incarnation and must fail, never re-execute: replaying a
        call the caller has no retry budget for onto a fresh incarnation
        re-runs side effects (and a poison call would kill every restart
        until the actor goes DEAD)."""
        with self._lock:
            info = self.gcs.get_actor_info(spec.actor_id)
            if info is None:
                self._fail_task(spec, exc.ActorDiedError("unknown actor"))
                return
            if info.state == ActorState.DEAD:
                self._fail_task(spec, exc.ActorDiedError(
                    info.death_cause or "actor is dead"))
                return
            if dead_worker is not None:
                cur = (info.worker_id.binary()
                       if info.worker_id is not None else None)
                if info.state != ActorState.ALIVE or cur != dead_worker:
                    self._fail_task(spec, exc.ActorDiedError(
                        info.death_cause or "actor worker died"))
                    return
            self.gcs.record_task_event(TaskEvent(
                spec.task_id, spec.name, TaskStatus.PENDING,
                type="ACTOR_TASK", parent_task_id=spec.parent_task_id,
                trace_id=spec.trace_ctx[0] if spec.trace_ctx else None))
            if info.state != ActorState.ALIVE or info.worker_id is None:
                info.pending_calls.append(spec)
                return
            self._push_actor_task(info, spec)

    def _push_actor_task(self, info, spec: TaskSpec):
        conn = self._conns.get(info.worker_id)
        if conn is None:
            info.pending_calls.append(spec)
            return
        self.running[spec.task_id] = (spec, info.worker_id)
        self.gcs.update_task_status(spec.task_id, TaskStatus.RUNNING,
                                    worker_id=info.worker_id)
        if not self._send_on(conn, {"type": "execute", "spec": spec}):
            # Send failed: this worker's conn is breaking.  Run death
            # processing NOW (idempotent; the lock is reentrant) so the
            # spec left in `running` is adopted and the actor FSM decides
            # replay-vs-fail by retry budget — a writer-only failure must
            # not strand the call, and requeueing to pending_calls here
            # would bypass the budget and re-execute the call on the NEXT
            # incarnation (a poison call — e.g. one that os._exit()s the
            # worker — would then kill every restart until the actor went
            # DEAD).
            self.on_conn_closed(info.worker_id)

    def on_task_done(self, msg: dict):
        from ray_tpu_torch._private.chaos import maybe_delay

        maybe_delay("task_done")
        task_id = TaskID(msg["task_id"])
        with self._lock:
            spec_worker = self.running.pop(task_id, None)
            # Completion can race an OOM kill decision (the monitor marked the
            # task just as its result message arrived) — drop the mark so the
            # map can't grow unboundedly.
            self._oom_killed.pop(task_id, None)
            worker_id = WorkerID(msg["worker_id"])
            raylet, handle = self._find_worker(worker_id)
            spec: Optional[TaskSpec] = msg.get("spec") or (
                spec_worker[0] if spec_worker else None)
            if handle is not None and spec is not None \
                    and spec.task_type == TaskType.NORMAL:
                if handle.blocked:
                    handle.blocked = False  # released at block time
                else:
                    self.scheduler.return_resources(handle.node_id, spec)
            error = msg.get("error")  # (meta, data) serialized exception or None
            results: List[TaskResult] = msg.get("results") or []
            if spec is not None:
                if error is not None and self._maybe_retry(spec, msg):
                    if handle is not None:
                        raylet.release_worker(handle)
                    self._drain_pending()
                    return
                status = TaskStatus.FAILED if error else TaskStatus.FINISHED
                kw = dict(error=msg.get("error_str"), worker_id=worker_id,
                          start=msg.get("start"), end=msg.get("end"))
                if handle is not None:
                    # Keep the SCHEDULED-time node when the worker is
                    # already gone — don't clobber it with None.
                    kw["node_id"] = handle.node_id
                self.gcs.update_task_status(task_id, status, **kw)
                # Unpin arg refs (direct and nested).
                for arg in list(spec.args) + list(spec.kwargs.values()):
                    for oid in ([arg.ref] if arg.ref is not None else []) \
                            + arg.contained:
                        if self.gcs.remove_reference(
                                oid, b"task:" + spec.task_id.binary()):
                            self._free_object(oid)
            node_id = handle.node_id if handle else None
            for res in results:
                self._record_result(res, node_id, task_id, error)
            if error is not None and spec is not None:
                for oid in spec.return_ids():
                    if not any(r.object_id == oid for r in results):
                        self._record_error_result(oid, error)
            # Actor lifecycle notifications.
            if spec is not None and spec.task_type == TaskType.ACTOR_CREATION:
                self._on_actor_creation_done(spec, worker_id, error, msg)
            if handle is not None:
                if spec is not None and spec.task_type == TaskType.ACTOR_TASK:
                    handle.busy = False  # actor workers aren't pooled
                else:
                    raylet.release_worker(handle)
            self._drain_pending()
            self._drive_pending_pgs()

    def _record_result(self, res: TaskResult, node_id, task_id: TaskID,
                       error):
        if res.inline is not None:
            self.gcs.object_inline(res.object_id, res.inline[0], res.inline[1],
                                   lineage_task=task_id)
            if res.contained:
                # Head-counted refs nested in the result value: pin them
                # under the result entry's lifetime.  This runs while
                # processing task_done, which the returner's connection
                # ordered BEFORE its own ref-gc drops — so the nested
                # object cannot be freed in the caller-registration
                # window.  (Owner-resident items carry an owner address
                # and are handled by the direct handover instead.)
                self._link_contained(res.object_id, [
                    c[0] for c in res.contained if c[1] is None])
        elif res.in_store and node_id is not None:
            self.gcs.object_sealed(res.object_id, node_id, res.size,
                                   lineage_task=task_id, meta=res.meta)
        self._notify_object(res.object_id)

    def _record_error_result(self, oid: ObjectID, error):
        self.gcs.object_inline(oid, ERROR_META + error[0], error[1])
        self._notify_object(oid)

    def _maybe_retry(self, spec: TaskSpec, msg: dict) -> bool:
        if spec.task_type == TaskType.ACTOR_TASK:
            # App-level exception on a live actor: retry only when asked
            # (retry_exceptions) and within the method's retry budget
            # (worker-death replay is handled by the actor FSM instead).
            if not spec.retry_exceptions or spec.attempt >= spec.max_retries:
                return False
            spec.attempt += 1
            self.submit_actor_task(spec)
            return True
        crashed = msg.get("crashed", False)
        if not crashed and not spec.retry_exceptions:
            return False
        if spec.attempt >= spec.max_retries:
            return False
        spec.attempt += 1
        self._schedule(spec)
        return True

    def _fail_task(self, spec: TaskSpec, error: BaseException):
        meta, data = _serialize_error(error)
        for oid in spec.return_ids():
            self._record_error_result(oid, (meta, data))
        self.gcs.update_task_status(spec.task_id, TaskStatus.FAILED,
                                    error=str(error))
        # Lost puts waiting on this task's re-execution (put
        # reconstruction, _try_reconstruct) can never recover now: fail
        # them typed so their waiters error instead of hanging.
        for oid, e in list(self.gcs.objects.items()):
            if e.lost and oid.is_put() and oid.task_id() == spec.task_id:
                self._fail_object_locked(oid, exc.ObjectLostError(
                    f"put {oid} was lost and its creating task could "
                    f"not be re-executed: {error}"))
        if spec.task_type == TaskType.ACTOR_CREATION:
            info = self.gcs.get_actor_info(spec.actor_id)
            if info is not None:
                self.gcs.kill_actor(spec.actor_id)
                info.death_cause = str(error)
                self._notify_actor_waiters(spec.actor_id, error=error)
                self._fail_pending_actor_calls(info, error)

    def cancel_task(self, task_id: TaskID):
        with self._lock:
            # Parked on a not-yet-produced arg (locality gate).
            for oid, lst in list(self._dep_parked.items()):
                for spec in list(lst):
                    if spec.task_id == task_id:
                        lst.remove(spec)
                        if not lst:
                            self._dep_parked.pop(oid, None)
                        self._fail_task(spec,
                                        exc.RayTpuError("task cancelled"))
                        return
            for spec in list(self.pending):
                if spec.task_id == task_id:
                    self.pending.remove(spec)
                    self._fail_task(spec, exc.RayTpuError("task cancelled"))
                    return
            # Placed on a node and waiting there for a worker (one may be
            # starting): pick_node reserved its resources, so give them
            # back, or the node keeps them for good.
            for raylet in self.raylets.values():
                for spec in list(raylet.queued):
                    if spec.task_id == task_id:
                        raylet.queued.remove(spec)
                        self.scheduler.return_resources(raylet.node_id, spec)
                        self._fail_task(spec, exc.RayTpuError("task cancelled"))
                        self._drain_pending()
                        return
            # Running normal tasks: find the worker currently executing it.
            for raylet in self.raylets.values():
                for handle in raylet.workers.values():
                    t = handle.current_task
                    if t is not None and t.task_id == task_id \
                            and handle.actor_id is None:
                        self._cancelled.add(task_id)
                        # Coarse cancel (like force=True in the reference):
                        # kill the worker; death handler fails the task.
                        try:
                            handle.proc.kill()
                        except Exception:
                            pass
                        return

    def _drain_pending(self):
        if not self.pending:
            return
        still: deque = deque()
        # Per-scheduling-class early-out (reference: the raylet queues tasks
        # by SchedulingClass, cluster_task_manager.h): once a class finds no
        # feasible node in this pass, its remaining tasks are skipped — the
        # drain is O(pending) instead of O(pending * completions).  Tasks
        # with placement strategies schedule against per-task state (PG
        # bundle, target node), so only default-strategy tasks share a key.
        blocked: set = set()
        while self.pending:
            spec = self.pending.popleft()
            key = (spec.scheduling_class()
                   if spec.scheduling_strategy.kind == "DEFAULT" else None)
            if key is not None and key in blocked:
                still.append(spec)
                continue
            try:
                locality, arg_bytes = self._arg_locality(spec)
                node_id = self.scheduler.pick_node(spec, locality=locality)
            except Infeasible as e:
                self._fail_task(spec, exc.RayTpuError(str(e)))
                continue
            if node_id is None:
                still.append(spec)
                if key is not None:
                    blocked.add(key)
            else:
                self._note_locality_placement(spec, node_id, arg_bytes)
                self.gcs.update_task_status(spec.task_id, TaskStatus.SCHEDULED,
                                            node_id=node_id)
                self.raylets[node_id].queue_task(spec)
        self.pending = still

    def _drive_pending_pgs(self):
        if not self._pending_pgs:
            return
        still = []
        for pg in self._pending_pgs:
            if self.scheduler.create_placement_group(pg):
                self.gcs.publish("PG", ("CREATED", pg.pg_id))
                for cb in self._pg_waiters.pop(pg.pg_id, []):
                    cb("CREATED")
            else:
                still.append(pg)
        self._pending_pgs = still

    # ================= workers: running-task bookkeeping =================
    def on_task_started(self, task_id, worker_id):
        # Dispatch marks running implicitly; normal tasks record here via raylet.
        pass

    def _find_worker(self, worker_id: WorkerID):
        for raylet in self.raylets.values():
            h = raylet.workers.get(worker_id)
            if h is not None:
                return raylet, h
        return None, None

    def _handle_worker_death(self, handle: WorkerHandle, cause: str):
        self._drop_partials_for(handle.worker_id.binary())
        if handle.leased_to is not None:
            # Leased worker died: return the lease's held resources.  The
            # lessee sees the channel break and handles its own in-flight
            # retries (owner-side task manager, see direct.py).
            if handle.blocked:
                handle.blocked = False  # released at block time
            else:
                self.scheduler.return_resources(handle.node_id,
                                                handle.lease_spec)
            handle.leased_to = None
            handle.lease_spec = None
        spec = handle.current_task
        if spec is not None and spec.task_type == TaskType.ACTOR_CREATION:
            # Died mid-creation: release and let the actor FSM below decide
            # whether to retry (max_restarts) or die.
            self.scheduler.return_resources(handle.node_id, spec)
            self.running.pop(spec.task_id, None)
        elif spec is not None and spec.task_type == TaskType.NORMAL:
            if handle.blocked:
                handle.blocked = False
            else:
                self.scheduler.return_resources(handle.node_id, spec)
            self.running.pop(spec.task_id, None)
            cancelled = spec.task_id in self._cancelled
            oom = self._oom_killed.pop(spec.task_id, None)
            if cancelled:
                self._cancelled.discard(spec.task_id)
                self._fail_task(spec, exc.RayTpuError("task cancelled"))
            elif spec.attempt < spec.max_retries:
                spec.attempt += 1
                self._schedule(spec)
            elif oom is not None:
                self._fail_task(spec, exc.OutOfMemoryError(
                    f"task was killed by the memory monitor under host "
                    f"memory pressure (usage {oom:.0%} at kill time) and "
                    f"exhausted its retries"))
            else:
                self._fail_task(spec, exc.WorkerCrashedError(cause))
        # Collect in-flight actor tasks bound to this worker: the actor FSM
        # decides whether they replay (max_task_retries across a restart,
        # reference: task_manager.h actor-task resubmit) or fail.
        inflight: List[TaskSpec] = []
        for task_id, (tspec, wid) in list(self.running.items()):
            if wid == handle.worker_id:
                self.running.pop(task_id, None)
                if tspec.task_type == TaskType.ACTOR_TASK:
                    inflight.append(tspec)
                else:
                    meta, data = _serialize_error(exc.ActorDiedError(cause))
                    for oid in tspec.return_ids():
                        self._record_error_result(oid, (meta, data))
        if handle.actor_id is not None:
            self._on_actor_worker_death(handle.actor_id, cause, inflight)
        else:
            self._fail_specs(inflight, exc.ActorDiedError(cause))

    def _fail_specs(self, specs, error: BaseException):
        if not specs:
            return
        meta, data = _serialize_error(error)
        for spec in specs:
            for oid in spec.return_ids():
                self._record_error_result(oid, (meta, data))

    # ================= actors =================
    def _on_actor_creation_done(self, spec: TaskSpec, worker_id: WorkerID,
                                error, msg):
        info = self.gcs.get_actor_info(spec.actor_id)
        if info is None:
            return
        if error is None:
            _, handle = self._find_worker(worker_id)
            node_id = handle.node_id if handle else None
            info.resources_held = True  # live actor keeps its creation resources
            self.gcs.actor_started(spec.actor_id, node_id, worker_id)
            self._notify_actor_waiters(spec.actor_id)
            calls, info.pending_calls = info.pending_calls, []
            for call in calls:
                self._push_actor_task(info, call)
        else:
            raylet, handle = self._find_worker(worker_id)
            if handle is not None:
                self.scheduler.return_resources(handle.node_id, spec)
                handle.actor_id = None
                # The worker process holds a half-constructed actor; recycle it.
                try:
                    handle.proc.kill()
                except Exception:
                    pass
            self.gcs.kill_actor(spec.actor_id)
            info.death_cause = msg.get("error_str") or "actor __init__ failed"
            err = exc.ActorDiedError(info.death_cause)
            self._notify_actor_waiters(spec.actor_id, error=err)
            self._fail_pending_actor_calls(info, err)

    def _on_actor_worker_death(self, actor_id: ActorID, cause: str,
                               inflight: Optional[List[TaskSpec]] = None):
        info = self.gcs.get_actor_info(actor_id)
        if info is None:
            self._fail_specs(inflight or [], exc.ActorDiedError(cause))
            return
        creation_spec = info.creation_spec
        if info.resources_held and info.node_id is not None:
            info.resources_held = False
            self.scheduler.return_resources(info.node_id, creation_spec)
        state = self.gcs.actor_failed(actor_id, cause)
        if state == ActorState.RESTARTING:
            # Replay in-flight calls that still have retry budget, AHEAD of
            # queued-but-never-started calls (submission order); the rest
            # fail with the death cause.
            replay, drop = [], []
            for t in (inflight or []):
                if t.attempt < t.max_retries:
                    t.attempt += 1
                    replay.append(t)
                else:
                    drop.append(t)
            info.pending_calls[:0] = replay
            self._fail_specs(drop, exc.ActorDiedError(cause))
            new_spec = creation_spec
            new_spec.attempt += 1
            self._schedule(new_spec)
        else:
            err = exc.ActorDiedError(cause)
            self._fail_specs(inflight or [], err)
            self._notify_actor_waiters(actor_id, error=err)
            self._fail_pending_actor_calls(info, err)

    def _fail_pending_actor_calls(self, info, error: BaseException):
        calls, info.pending_calls = info.pending_calls, []
        meta, data = _serialize_error(error)
        for call in calls:
            for oid in call.return_ids():
                self._record_error_result(oid, (meta, data))

    def _notify_actor_waiters(self, actor_id: ActorID,
                              error: Optional[BaseException] = None):
        for cb in self._actor_waiters.pop(actor_id, []):
            try:
                if error is None:
                    cb(True)
                else:
                    cb(None, error=error)
            except TypeError:
                cb(True)

    def kill_actor(self, actor_id: ActorID, no_restart: bool = True):
        with self._lock:
            info = self.gcs.get_actor_info(actor_id)
            if info is None:
                return
            if no_restart:
                info.max_restarts = 0
            worker_id = info.worker_id
            if info.resources_held and info.node_id is not None:
                info.resources_held = False
                self.scheduler.return_resources(info.node_id, info.creation_spec)
            self.gcs.kill_actor(actor_id)
            err = exc.ActorDiedError("actor killed")
            self._fail_pending_actor_calls(info, err)
            if worker_id is not None:
                _, handle = self._find_worker(worker_id)
                if handle is not None:
                    try:
                        handle.proc.kill()
                    except Exception:
                        pass
            self._drain_pending()

    # ================= objects =================
    def on_seal(self, msg: dict):
        """A worker sealed a large object directly into shm; adopt it."""
        with self._lock:
            self._seal_one_locked(msg)

    def _seal_one_locked(self, msg: dict) -> Optional[ObjectID]:
        oid: ObjectID = ObjectID(msg["oid"])
        node_id = NodeID(msg["node_id"])
        raylet = self.raylets.get(node_id)
        if raylet is not None:
            try:
                # Adopt is a no-op when the object was created in the
                # store directly (the driver's pooled-segment put path).
                raylet.store.adopt(oid, msg["size"], msg["meta"],
                                   segment=msg.get("segment"))
            except Exception:
                traceback.print_exc()
                return None
        self.gcs.object_sealed(oid, node_id, msg["size"],
                               lineage_task=msg.get("lineage_task"),
                               meta=msg.get("meta"),
                               segment=msg.get("segment"))
        self._link_contained(oid, msg.get("contained"))
        self._maybe_make_durable(oid, msg["size"])
        self._notify_object(oid)
        return oid

    def _link_contained(self, oid: ObjectID, contained) -> None:
        """Pin head-counted refs nested in an object's value under the
        object's own lifetime (res:<oid> holders), released cascading in
        _free_object.  Ordering makes this race-free: the seal/result
        message carrying the nested ids rides the creator's connection
        BEFORE its own ref-gc drop, so the nested object can never be
        freed in the handoff window between the creator's drop and the
        consumer's register (reference: reference_count.h:543)."""
        if not contained:
            return
        entry = self.gcs.object_lookup(oid)
        if entry is None:
            return
        holder = b"res:" + oid.binary()
        linked = entry.contained or []
        for coid_bin in contained:
            coid = ObjectID(coid_bin)
            if coid == oid or coid in linked:
                continue  # duplicate seal frame (chaos dup / resend)
            self.gcs.add_reference(coid, holder)
            linked.append(coid)
        entry.contained = linked

    def on_seal_batch(self, msg: dict):
        """Coalesced seal burst (put_many): adopt + register every object
        and its submitter's holder ref under ONE lock acquisition / ONE
        control-plane message, in submission order."""
        holder = msg.get("holder")
        with self._lock:
            for item in msg["items"]:
                oid = self._seal_one_locked(item)
                if oid is not None and holder is not None:
                    self.gcs.add_reference(oid, holder)

    def on_put_inline_batch(self, msg: dict):
        """Coalesced inline-put burst (put_many), applied in order."""
        with self._lock:
            for item in msg["items"]:
                oid = ObjectID(item["oid"])
                self.gcs.object_inline(oid, item["meta"], item["data"],
                                       lineage_task=item.get("lineage_task"))
                self._link_contained(oid, item.get("contained"))
                self._notify_object(oid)

    def on_arena_sealed(self, msg: dict):
        """Driver wrote directly into the head raylet's native arena."""
        oid = ObjectID(msg["oid"])
        with self._lock:
            self.gcs.object_sealed(oid, NodeID(msg["node_id"]), msg["size"],
                                   lineage_task=msg.get("lineage_task"))
            self._link_contained(oid, msg.get("contained"))
            self._maybe_make_durable(oid, msg["size"])
            self._notify_object(oid)

    def on_put_inline(self, msg: dict):
        oid = ObjectID(msg["oid"])
        with self._lock:
            self.gcs.object_inline(oid, msg["meta"], msg["data"],
                                   lineage_task=msg.get("lineage_task"))
            self._link_contained(oid, msg.get("contained"))
            self._notify_object(oid)

    # ----- cooperative broadcast: partial-holder directory -----
    def on_object_partial(self, msg: dict, host: Optional[str]):
        """A receiver mid-pull advertises chunk ranges it has landed; the
        record makes it a stripe source for concurrent pullers (torrent-
        style dissemination).  Dies with its process (death hooks call
        _drop_partials_for) or on the explicit drop notify after seal."""
        oid = ObjectID(msg["oid"])
        key = msg["key"]
        with self._lock:
            entry = self.gcs.object_lookup(oid)
            if entry is None or entry.inline is not None:
                return
            p = entry.partials
            if p is None:
                p = entry.partials = {}
            rec = p.get(key)
            if rec is None:
                rec = p[key] = {"addr": tuple(msg["addr"]),
                                "chunk": int(msg["chunk"]),
                                "total": int(msg["total"]),
                                "chunks": set(),
                                "host": host or self.host_key}
                self._partial_index[key].add(oid)
            rec["chunks"].update(msg.get("chunks") or ())

    def on_object_partial_drop(self, msg: dict):
        oid = ObjectID(msg["oid"])
        key = msg["key"]
        with self._lock:
            entry = self.gcs.object_lookup(oid)
            if entry is not None and entry.partials:
                entry.partials.pop(key, None)
                if not entry.partials:
                    entry.partials = None
            oids = self._partial_index.get(key)
            if oids is not None:
                oids.discard(oid)
                if not oids:
                    self._partial_index.pop(key, None)

    def _drop_partials_for(self, key: bytes) -> None:
        """Clear every partial advertisement a dead process made (under
        the head lock): a vanished peer must not be handed out as a
        stripe source — pullers would burn a range timeout on it."""
        for oid in self._partial_index.pop(key, ()):
            entry = self.gcs.object_lookup(oid)
            if entry is not None and entry.partials:
                entry.partials.pop(key, None)
                if not entry.partials:
                    entry.partials = None

    def _partial_sources_locked(self, entry, exclude_host: str):
        """(sources, chunk) for a pull resolution: every cross-host
        partial holder with at least one landed chunk, uniform chunk
        unit (mixed-config advertisers are skipped — range alignment
        needs one unit).  Also reports whether a SAME-host pull is in
        progress (the segment-coalescing hint for _pull_once)."""
        sources: list = []
        chunk = None
        local = False
        if entry.partials:
            for rec in entry.partials.values():
                if rec["host"] == exclude_host:
                    local = True
                    continue
                if not rec["chunks"]:
                    continue
                if chunk is None:
                    chunk = rec["chunk"]
                elif rec["chunk"] != chunk:
                    continue
                sources.append([list(rec["addr"]),
                                sorted(rec["chunks"])])
                if len(sources) >= 16:
                    break
        return sources, chunk, local

    def _caller_host(self, caller: Optional[WorkerID]) -> str:
        """Host key of the process asking for an object."""
        if caller is None:
            return self.host_key
        hk = self._driver_hosts.get(caller.binary())
        if hk is not None:
            return hk
        _, handle = self._find_worker(caller)
        if handle is not None:
            return self.node_host.get(handle.node_id, self.host_key)
        return self.host_key

    def _resolve_object(self, oid: ObjectID, peek: bool = False,
                        caller_host: Optional[str] = None) -> Optional[dict]:
        """Returns a resolution message or None if not yet available.

        Host-aware: a caller on the same host as a location attaches the
        shm segment (zero-copy); a caller on a different host gets a "pull"
        resolution naming the owning store's transfer server (the
        reference's ownership-based directory + pull manager,
        ownership_based_object_directory.h, pull_manager.h:52)."""
        entry = self.gcs.object_lookup(oid)
        if entry is None:
            return None
        if entry.inline is not None:
            meta, data = entry.inline
            if meta.startswith(ERROR_META):
                return {"kind": "error", "meta": meta[len(ERROR_META):], "data": data}
            return {"kind": "inline", "meta": meta, "data": data}
        ch = caller_host or self.host_key
        local_misses = 0
        # Same-host locations first: direct segment attach.
        for node_id in entry.locations:
            if self.node_host.get(node_id, self.host_key) != ch:
                continue
            raylet = self.raylets.get(node_id)
            if raylet is None:
                continue
            if isinstance(raylet.store, RemoteStoreProxy):
                # The store lives in the caller's host's agent/driver
                # process.  A spill record means the segment is gone and
                # the bytes live in the agent's spill file; otherwise the
                # segment is attachable by name on that host.
                hit = raylet.store.spilled_lookup(oid)
                if hit is not None:
                    return hit
                if entry.meta is not None:
                    return {"kind": "store", "oid": oid, "meta": entry.meta,
                            "segment": entry.segments.get(node_id)}
            else:
                hit = raylet.store.arena_lookup(oid)
                if hit is not None:
                    return hit
                meta = raylet.store.meta(oid)
                if meta is not None:
                    return {"kind": "store", "oid": oid, "meta": meta,
                            "segment": raylet.store.segment_of(oid)}
                hit = raylet.store.spilled_lookup(oid)
                if hit is not None:
                    return hit
                local_misses += 1
        # Cross-host: hand out a pull resolution against the owning
        # stores.  ALL live holder addresses ride along so the puller can
        # fail over to an alternate replica when the serving node dies
        # mid-pull (location failover, reference: pull_manager retries
        # against updated object directory locations).
        addrs = []
        for node_id in entry.locations:
            if self.node_host.get(node_id, self.host_key) == ch:
                continue
            addr = self.node_xfer.get(node_id)
            if addr is not None:
                addrs.append(list(addr))
        if addrs:
            out = {"kind": "pull", "oid": oid, "addr": addrs[0],
                   "addrs": addrs, "size": entry.size}
            # Serialization meta rides along so a striped pull can seal
            # even when every byte came from meta-less partial holders.
            meta = entry.meta
            if meta is None:
                for node_id in entry.locations:
                    raylet = self.raylets.get(node_id)
                    if raylet is not None and not isinstance(
                            raylet.store, RemoteStoreProxy):
                        m = raylet.store.meta(oid)
                        if m is not None:
                            meta = m
                            break
            if meta is not None:
                out["meta"] = meta
            psources, pchunk, local = self._partial_sources_locked(entry, ch)
            if psources:
                seen = {tuple(a) for a in addrs}
                out["sources"] = [[a, None] for a in addrs] + [
                    s for s in psources if tuple(s[0]) not in seen]
                out["chunk"] = pchunk
            if local:
                # Someone on the caller's host is mid-pull on this very
                # object: the caller should wait for that seal instead
                # of racing the canonical segment create.
                out["local_partial"] = True
            return out
        # Directory-side spill record readable on the caller's host: the
        # owning store (node) is gone but its file survives.
        if entry.spill is not None \
                and (entry.spill_host or self.host_key) == ch:
            path, meta, size = entry.spill
            return {"kind": "spilled", "path": path, "meta": meta,
                    "size": size}
        if entry.locations and local_misses == len(entry.locations):
            # Every location was a local store that no longer has the bytes.
            entry.locations.clear()
            entry.segments.clear()
            entry.lost = True
        return None

    def _notify_object(self, oid: ObjectID):
        if self._resolve_object(oid) is None:
            return
        # Tasks parked on this arg (locality gate): schedule them now
        # that the directory knows where the bytes live — remaining
        # missing args just re-park on their own oid.
        parked = self._dep_parked.pop(oid, None)
        if parked:
            for spec in parked:
                self._schedule(spec)
        # Callbacks re-resolve per caller host (cross-host waiters need a
        # pull resolution, same-host waiters a segment attach).
        for cb in self._object_waiters.pop(oid, []):
            try:
                cb(oid)
            except Exception:
                pass

    def _object_is_referenced(self, oid: ObjectID) -> bool:
        entry = self.gcs.object_lookup(oid)
        return entry is not None and bool(entry.holders)

    def _on_object_evicted(self, oid: ObjectID, node_id: NodeID):
        entry = self.gcs.object_lookup(oid)
        if entry is not None:
            entry.locations.discard(node_id)
            entry.segments.pop(node_id, None)
            if not entry.locations and entry.inline is None:
                entry.lost = True

    def _try_reconstruct(self, oid: ObjectID, entry) -> bool:
        """Recovery for an object with no readable copy: lineage
        reconstruction first (reference: object_recovery_manager.h:41),
        then the durability plane's spill/backup record.

        Puts reconstruct too, when made INSIDE a task: a put id embeds
        its creating task id, so while that task's lineage is retained
        (its returns are still referenced) a deterministic re-execution
        re-seals the same put ids — this closes the async-durability
        window where a node dies between a put's seal and its replica
        landing.  Driver puts and actor-task puts have no retained
        lineage and fall through to the spill record."""
        from ray_tpu_torch._private.recovery import note

        task = self.gcs.get_lineage(oid.task_id())
        if task is not None and not oid.is_put():
            task.attempt += 1
            entry.lost = False
            note("objects_reconstructed")
            self._schedule(task)
            return True
        # Puts: a spill/backup record restores deterministically without
        # recompute — prefer it over re-running the creating task.
        if self._restore_from_spill(oid, entry):
            return True
        if task is None:
            return False
        ev = self.gcs.task_events.get(task.task_id)
        if ev is not None and ev.status in (
                TaskStatus.PENDING, TaskStatus.SCHEDULED,
                TaskStatus.RUNNING):
            # A live attempt (worker-death retry, or the re-run a
            # sibling put of the same task already triggered) will
            # re-seal this put: don't resubmit again.
            return True
        note("objects_reconstructed")
        task.attempt += 1
        # lost stays True until the re-run re-seals the put
        # (object_sealed clears it); if the re-run can never schedule,
        # _fail_task fails this entry typed.
        self._schedule(task)
        return True

    def _restore_from_spill(self, oid: ObjectID, entry) -> bool:
        """Re-materialize an object from its directory-side spill record
        into a surviving local store, so every caller (any host) resolves
        it again.  Only head-host files are readable here; remote spill
        files are served by their (surviving) agent instead."""
        from ray_tpu_torch._private.recovery import note

        if entry.spill is None:
            return False
        if (entry.spill_host or self.host_key) != self.host_key:
            return False  # the file lives on a host we cannot read
        path, meta, _size = entry.spill
        target_nid = target = None
        for nid, raylet in self.raylets.items():
            if not isinstance(raylet.store, RemoteStoreProxy) \
                    and not raylet.dead:
                target_nid, target = nid, raylet
                break
        if target is None:
            # No live local store to land it in: same-host readers are
            # still served straight off the file (resolution "spilled").
            entry.lost = False
            return True
        try:
            with open(path, "rb") as f:
                data = f.read()
        except OSError:
            return False
        try:
            seg = target.store.put_replica(oid, meta, data)
        except Exception:
            return False
        self.gcs.object_sealed(oid, target_nid, len(data), meta=meta,
                               segment=seg)
        entry.lost = False
        note("objects_restored")
        self._notify_object(oid)
        return True

    def _free_object(self, oid: ObjectID):
        entry = self.gcs.object_lookup(oid)
        if entry is None:
            return
        if b"task:" in {h[:5] for h in entry.holders}:
            return
        if self._arena_leases.get(oid):
            # A reader still holds a zero-copy view over the arena slot:
            # defer the free until the last lease is returned (plasma
            # semantics — never recycle memory under a client).
            self._arena_pending_free.add(oid)
            return
        self._arena_pending_free.discard(oid)
        for node_id in list(entry.locations):
            raylet = self.raylets.get(node_id)
            if raylet is not None:
                raylet.store.delete(oid)
        if entry.partials:
            for key in entry.partials:
                oids = self._partial_index.get(key)
                if oids is not None:
                    oids.discard(oid)
                    if not oids:
                        self._partial_index.pop(key, None)
        contained = entry.contained
        self.gcs.free_object(oid)
        if contained:
            # Cascade: the outer object's death releases its res: pins on
            # nested refs — freeing them too when nothing else holds them.
            holder = b"res:" + oid.binary()
            for coid in contained:
                if self.gcs.remove_reference(coid, holder):
                    self._free_object(coid)

    # ----- arena reader leases -----
    def _grant_arena_lease(self, oid: ObjectID, caller: Optional[WorkerID]):
        holder = caller.binary() if caller is not None else b"driver"
        with self._lock:
            holders = self._arena_leases[oid]
            holders[holder] = holders.get(holder, 0) + 1

    def on_arena_release(self, msg: dict):
        oid = ObjectID(msg["oid"])
        holder = msg["holder"]
        with self._lock:
            holders = self._arena_leases.get(oid)
            if holders is not None and holder in holders:
                if holders[holder] <= 1:
                    holders.pop(holder)
                else:
                    holders[holder] -= 1
                if not holders:
                    self._arena_leases.pop(oid, None)
            self._maybe_complete_deferred_free(oid)

    def _drop_arena_leases_for(self, holder: bytes):
        for oid in list(self._arena_leases.keys()):
            # .get(): a reentrant on_arena_release (GC finalizer on this
            # thread — the RLock does not exclude it) may have removed the
            # entry since the snapshot.
            holders = self._arena_leases.get(oid)
            if holders is not None and holder in holders:
                holders.pop(holder)
                if not holders:
                    self._arena_leases.pop(oid, None)
                self._maybe_complete_deferred_free(oid)

    def _maybe_complete_deferred_free(self, oid: ObjectID):
        if oid in self._arena_pending_free and not self._arena_leases.get(oid):
            self._arena_pending_free.discard(oid)
            self._free_object(oid)

    # ================= object durability =================
    def _maybe_make_durable(self, oid: ObjectID, size: int):
        """Seal-time hook (under the head lock): puts are non-
        reconstructable — queue them for async replication/backup.  One
        predicate when durability is off; never blocks the seal path."""
        if self._durability_q is not None and size >= self._durability_min \
                and oid.is_put():
            # Callers hold self._lock (seal path) — the pending counter is
            # the quiesce gate's truth, bumped before the queue put so the
            # worker's decrement can never race it below zero.
            self._durability_pending += 1
            self._durability_q.put(oid)

    _DURABILITY_ATTEMPTS = 6  # ~3s of exponential backoff, then give up

    def _durability_loop(self):
        import time as _time

        while not self._shutdown:
            item = self._durability_q.get()
            if item is None:
                return
            oid, attempt = item if isinstance(item, tuple) else (item, 0)
            ok = True
            try:
                if self._durability[0] == "replicate":
                    ok = self._replicate_one(oid, self._durability[1])
                else:
                    self._backup_one(oid)
            except Exception:
                traceback.print_exc()
                ok = False
            if ok is False and attempt + 1 < self._DURABILITY_ATTEMPTS \
                    and not self._shutdown:
                # Transient failure — the canonical case: the pull raced
                # the agent's async store_adopt of a freshly-sealed
                # segment, so the source's transfer server doesn't serve
                # the object YET.  Retry with backoff; the pending count
                # is NOT released, so durability_quiesce keeps blocking
                # until the replica truly exists (or attempts exhaust).
                _time.sleep(0.05 * (2 ** attempt))
                self._durability_q.put((oid, attempt + 1))
                continue
            with self._lock:
                self._durability_pending -= 1

    def durability_quiesce(self, timeout: float = 30.0) -> bool:
        """Wait until the async durability worker has replicated/backed up
        every put sealed so far (queue drained AND the in-flight item
        finished).  Chaos tests call this before firing a seeded node
        kill so "the replica exists" is a guarantee, not a race — the
        deterministic-counters contract of the node-loss gates.  Returns
        False on timeout; True immediately when durability is off.
        Best-effort for remote-node replica targets (their store_pull ack
        is asynchronous); copies into head-colocated stores — what the
        tier-1 gates assert on — are synchronous and fully covered."""
        import time as _time

        if self._durability_q is None:
            return True
        deadline = _time.monotonic() + timeout
        while _time.monotonic() < deadline:
            with self._lock:
                if self._durability_pending <= 0:
                    return True
            _time.sleep(0.01)
        return False

    @staticmethod
    def _read_store_bytes(store) -> "Callable[[ObjectID], tuple]":
        """Reader over a local store covering all three residences a
        sealed object can have: shm segment, native arena, spill file."""
        def read(oid: ObjectID):
            got = store.get(oid)
            if got is not None:
                meta, view = got
                return meta, bytes(view)
            lock = getattr(store, "_lock", None)
            if lock is not None:
                with lock:
                    hit = store.arena_lookup(oid)
                    if hit is not None:
                        from ray_tpu_torch._native import ArenaReader

                        view = ArenaReader.view(hit["store"], hit["offset"],
                                                hit["size"],
                                                hit["capacity"])
                        return hit["meta"], bytes(view)
            rec = store.read_spilled(oid)
            if rec is not None:
                return rec
            return None, None

        return read

    def _replicate_one(self, oid: ObjectID, k: int) -> bool:
        """Bring a put up to K holder locations: copy its bytes into
        surviving stores (direct store-to-store for in-process raylets,
        agent-side pulls for remote nodes).  Async — a node dying
        mid-replication just leaves fewer copies.  Returns False on
        TRANSIENT failures (source not readable yet — e.g. the pull
        raced the agent's async store_adopt — or a target store error)
        so the durability loop retries instead of silently leaving the
        put with no second copy; True when done or permanently moot."""
        from ray_tpu_torch._private.recovery import note

        with self._lock:
            entry = self.gcs.object_lookup(oid)
            if entry is None or entry.inline is not None or entry.lost:
                return True
            have = set(entry.locations)
            need = k - len(have)
            if need <= 0:
                return True
            size = entry.size
            # Source preference: a local store (zero-copy read) over a
            # remote pull.
            src_nid = src_raylet = None
            for nid in have:
                raylet = self.raylets.get(nid)
                if raylet is not None and not isinstance(
                        raylet.store, RemoteStoreProxy):
                    src_nid, src_raylet = nid, raylet
                    break
            src_addr = None
            if src_raylet is None:
                for nid in have:
                    addr = self.node_xfer.get(nid)
                    if addr is not None:
                        src_nid, src_addr = nid, addr
                        break
                if src_addr is None:
                    return False  # no readable source (yet) — retry
            # Targets: local stores first (replicas there survive any
            # agent death and cost no network), then remote agents.
            local_t, remote_t = [], []
            for nid, raylet in self.raylets.items():
                if nid in have or raylet.dead or raylet.max_workers <= 0:
                    continue
                if isinstance(raylet.store, RemoteStoreProxy):
                    remote_t.append((nid, raylet))
                else:
                    local_t.append((nid, raylet))
            if src_raylet is not None:
                src_raylet.store.pin(oid)  # survive eviction mid-copy
        meta = data = None
        try:
            if src_raylet is not None:
                meta, data = self._read_store_bytes(src_raylet.store)(oid)
            else:
                try:
                    meta, data = self._repl_pull(src_addr, oid)
                except Exception:
                    # Usually the seal→store_adopt race on the agent: the
                    # object exists but its store can't serve it yet.
                    return False
        finally:
            if src_raylet is not None:
                src_raylet.store.unpin(oid)
        if data is None:
            return False
        target_errors = 0
        for nid, raylet in local_t:
            if need <= 0:
                break
            try:
                seg = raylet.store.put_replica(oid, meta, data)
            except Exception:
                target_errors += 1
                continue  # store full/racing shutdown: try the next node
            with self._lock:
                if nid not in self.raylets:
                    continue  # died while we copied
                self.gcs.object_sealed(oid, nid, len(data), meta=meta,
                                       segment=seg)
            note("objects_replicated")
            need -= 1
        if need > 0:
            # Remote targets pull from the source's transfer server and
            # ack with "object_replicated" (location registered there).
            pull_addr = self.node_xfer.get(src_nid) if src_addr is None \
                else src_addr
            if pull_addr is None:
                return False
            for nid, raylet in remote_t:
                if need <= 0:
                    break
                raylet.send_agent({"type": "store_pull",
                                   "oid": oid.binary(),
                                   "addr": list(pull_addr),
                                   "size": size, "meta": meta})
                need -= 1
        # Fewer holder nodes than K is a permanent topology fact (best
        # effort, True); an erroring target store is worth another try.
        return not (need > 0 and target_errors > 0)

    def _repl_pull(self, addr, oid: ObjectID):
        if self._repl_client is None:
            from ray_tpu_torch._private.transfer import TransferClient

            self._repl_client = TransferClient(self.authkey)
        return self._repl_client.pull(tuple(addr), oid)

    def _backup_one(self, oid: ObjectID):
        """Durability spill: ensure an on-disk copy exists somewhere (the
        owning store keeps serving from memory; only loss reads the
        file).  The spill callback / object_spilled report mirrors the
        record into the directory, where it survives node death and —
        via the GCS snapshot — head restarts."""
        with self._lock:
            entry = self.gcs.object_lookup(oid)
            if entry is None or entry.inline is not None \
                    or entry.spill is not None:
                return
            target = None
            for nid in entry.locations:
                raylet = self.raylets.get(nid)
                if raylet is None:
                    continue
                if isinstance(raylet.store, RemoteStoreProxy):
                    raylet.send_agent({"type": "store_backup",
                                       "oid": oid.binary()})
                    return
                target = raylet
                break
        if target is not None:
            target.store.backup(oid)  # spill_callback records it

    # ================= shutdown =================
    def shutdown(self):
        self.log_monitor.stop()
        with self._lock:
            self._shutdown = True
            if self._durability_q is not None:
                self._durability_q.put(None)
            if self._prefetch_q is not None:
                self._prefetch_q.put(None)
            if self._repl_client is not None:
                try:
                    self._repl_client.close()
                except Exception:
                    pass
            for raylet in self.raylets.values():
                raylet.shutdown()
            self.raylets.clear()
            for srv in self._local_xfer.values():
                srv.shutdown()
            self._local_xfer.clear()
        for listener in (self._listener, self._tcp_listener):
            try:
                listener.close()
            except Exception:
                pass


def _serialize_error(error: BaseException) -> Tuple[bytes, bytes]:
    s = ser.serialize(error)
    meta, data = ser.pack(s)
    return meta, data
