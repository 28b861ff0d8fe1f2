"""Direct transports: the task/actor hot path without the head.

The reference keeps steady-state submission out of its control plane:
callers cache worker leases per scheduling class and push tasks straight
to the leased worker (core_worker/transport/direct_task_transport.h:57,
direct_task_transport.cc:380), actor calls ride a per-caller connection
to the actor's dedicated worker (direct_actor_task_submitter.h:67), and
the CALLER owns its tasks' results — holding them in an in-process
memory store (memory_store.h:43) with a borrowing protocol for refs that
travel to other processes (reference_count.h:61,520).

ray_tpu_torch equivalent, one module:

  - ``OwnedStore``     owner-authoritative in-process object table
  - ``DirectServer``   per-process listener serving exec / fetch / pin
  - ``DirectChannel``  client side of one direct connection
  - ``DirectSubmitter``lease cache + per-actor channels + borrow pins

The head stays authoritative for placement (lease grants), the actor
restart FSM, large objects (shm store + directory) and everything the
classic path still carries: non-DEFAULT scheduling strategies, placement
groups, and any submission the direct path cannot take right now — every
direct failure falls back to the classic head path, never errors out.

Ownership rules (mirroring reference_count.h):
  - The submitter owns task returns and put objects small enough to stay
    inline; entries live in its OwnedStore.
  - A ref serialized to another process carries the owner's address; the
    receiving process is a *borrower*: it registers a pin with the owner
    for as long as it holds local refs (the WaitForRefRemoved handshake
    collapses to this pin/unpin pair; a broken borrower connection drops
    its pins, like the reference's borrower-death cleanup).
  - An object whose bytes moved to the shared store (large results) or
    to the head (classic fallback) is EXTERN: resolution falls through
    to the head directory, and the owner mirrors its local refcount to
    the head so the head's lifecycle rules apply.

Copied from ``ray_tpu/_private/direct.py`` (the JAX package).
"""
from __future__ import annotations

import os
import socket
import threading
import time
from collections import deque
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FuturesTimeoutError
from typing import Any, Callable, Dict, List, Optional, Tuple

from ray_tpu_torch import exceptions as exc
from ray_tpu_torch._private import serialization as ser
from ray_tpu_torch._private.ids import ObjectID, TaskID
from ray_tpu_torch._private.task_spec import TaskSpec, TaskType

# Owned-entry states.
PENDING = 0   # task in flight; bytes not produced yet
READY = 1     # inline bytes held here
ERROR = 2     # serialized exception held here
EXTERN = 3    # bytes live in the shared store / head directory

FETCH_WAIT_S = 120.0  # safety valve on deferred fetch replies


class _Entry:
    __slots__ = ("state", "meta", "data", "refs", "pins", "waiters",
                 "promote", "linked")

    def __init__(self):
        self.state = PENDING
        self.meta: Optional[bytes] = None
        self.data: Optional[bytes] = None
        self.refs = 0               # local ObjectRef count in the owner
        self.pins: Optional[Dict[bytes, int]] = None  # token -> count
        self.waiters: Optional[List[Callable]] = None  # deferred fetch replies
        self.promote = False        # promote to head on fulfill (classic arg)
        # Contained-ref pins released when THIS entry is freed:
        # (res-token, [(oid binary, owner addr), ...]).
        self.linked = None


class OwnedStore:
    """Owner-side object table.  An entry is dropped once it has no local
    refs, no pins, and is past PENDING (a pending entry with no holders is
    kept as a tombstone until its task completes, then dropped).

    Blocking waits share one condition variable (hot path: entries are
    created per task — a per-entry Event would cost more than the entry)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._nwaiters = 0
        self._entries: Dict[ObjectID, _Entry] = {}
        # Linked-pin descriptors of freed entries, drained by the
        # submitter's maintenance loop (released OUTSIDE the store lock —
        # the release sends on channels whose locks order after ours).
        self.released_links: deque = deque()

    # ---- lifecycle ----
    def create_pending(self, oid: ObjectID) -> None:
        """Create a pending entry holding ONE submission ref: the ObjectRef
        the submit call returns adopts it (ObjectRef construction races the
        task's completion — without the pre-held ref, a fast result could be
        freed before the ref exists)."""
        with self._lock:
            if oid not in self._entries:
                e = self._entries[oid] = _Entry()
                e.refs = 1

    def put(self, oid: ObjectID, meta: bytes, data: bytes) -> None:
        with self._lock:
            e = self._entries.get(oid)
            if e is None:
                e = self._entries[oid] = _Entry()
            e.meta, e.data = meta, data
            e.state = READY  # publish AFTER the bytes (unlocked readers)
            if self._nwaiters:
                self._cond.notify_all()

    def put_with_ref(self, oid: ObjectID, meta: bytes, data: bytes) -> None:
        """put() + the first local ref in ONE lock round trip — the small-
        put hot path (the caller constructs its ObjectRef with
        skip_adding_local_ref and marks it owner-registered)."""
        with self._lock:
            e = self._entries.get(oid)
            if e is None:
                e = self._entries[oid] = _Entry()
            e.meta, e.data = meta, data
            e.refs += 1
            e.state = READY  # publish AFTER the bytes (unlocked readers)
            if self._nwaiters:
                self._cond.notify_all()

    def wait_fulfilled(self, e: _Entry, timeout: Optional[float]) -> bool:
        """Block until `e` leaves PENDING.  False on timeout."""
        with self._cond:
            if e.state != PENDING:
                return True
            self._nwaiters += 1
            try:
                return self._cond.wait_for(lambda: e.state != PENDING,
                                           timeout)
            finally:
                self._nwaiters -= 1

    def _fire(self, e: _Entry):
        if self._nwaiters:
            self._cond.notify_all()
        if not e.waiters:
            return
        waiters, e.waiters = e.waiters, None
        for cb in waiters:
            try:
                cb(e)
            except Exception:
                pass

    def fulfill_inline(self, oid: ObjectID, meta: bytes, data: bytes) -> None:
        with self._lock:
            e = self._entries.get(oid)
            if e is None:
                return
            e.meta, e.data = meta, data
            e.state = READY  # publish AFTER the bytes (unlocked readers)
            self._fire(e)
            self._maybe_free(oid, e)

    def fulfill_error(self, oid: ObjectID, meta: bytes, data: bytes) -> None:
        with self._lock:
            e = self._entries.get(oid)
            if e is None:
                return
            e.meta, e.data = meta, data
            e.state = ERROR  # publish AFTER the bytes (unlocked readers)
            self._fire(e)
            self._maybe_free(oid, e)

    def make_extern(self, oid: ObjectID) -> Tuple[bool, bool]:
        """Transition to EXTERN.  Returns (had_entry, has_local_refs) so the
        caller can mirror its refcount to the head directory."""
        with self._lock:
            e = self._entries.get(oid)
            if e is None:
                return False, False
            # Bytes are deliberately RETAINED: an unlocked reader that
            # already observed READY must still find valid meta/data (the
            # head holds an identical copy from promotion/seal).
            e.state = EXTERN
            self._fire(e)
            refs = e.refs > 0
            self._maybe_free(oid, e)
            return True, refs

    def set_promote_on_fulfill(self, oid: ObjectID) -> bool:
        """Classic-fallback submit referenced a PENDING owned object: ask the
        owner loop to promote it to the head when the bytes arrive."""
        with self._lock:
            e = self._entries.get(oid)
            if e is None or e.state != PENDING:
                return False
            e.promote = True
            return True

    def take_promote(self, oid: ObjectID) -> bool:
        with self._lock:
            e = self._entries.get(oid)
            if e is None or not e.promote:
                return False
            e.promote = False
            return True

    # ---- refs & pins ----
    def lookup(self, oid: ObjectID) -> Optional[_Entry]:
        with self._lock:
            return self._entries.get(oid)

    def contains(self, oid: ObjectID) -> bool:
        with self._lock:
            return oid in self._entries

    def add_ref(self, oid: ObjectID) -> Optional[Tuple[int, int]]:
        """Returns (new_count, state) if this process owns the entry."""
        with self._lock:
            e = self._entries.get(oid)
            if e is None:
                return None
            e.refs += 1
            return e.refs, e.state

    def remove_ref(self, oid: ObjectID) -> Optional[Tuple[int, int]]:
        with self._lock:
            e = self._entries.get(oid)
            if e is None:
                return None
            e.refs -= 1
            n, state = e.refs, e.state
            self._maybe_free(oid, e)
            return n, state

    def pin(self, oid: ObjectID, token: bytes) -> None:
        with self._lock:
            e = self._entries.get(oid)
            if e is not None:
                if e.pins is None:
                    e.pins = {}
                e.pins[token] = e.pins.get(token, 0) + 1

    def unpin(self, oid: ObjectID, token: bytes) -> None:
        with self._lock:
            e = self._entries.get(oid)
            if e is None or e.pins is None:
                return
            n = e.pins.get(token, 0) - 1
            if n <= 0:
                e.pins.pop(token, None)
            else:
                e.pins[token] = n
            self._maybe_free(oid, e)

    def set_linked(self, oid: ObjectID, linked) -> bool:
        """Attach contained-ref pins to an entry; False if already freed
        (caller releases the pins immediately)."""
        with self._lock:
            e = self._entries.get(oid)
            if e is None:
                return False
            e.linked = linked
            return True

    def _maybe_free(self, oid: ObjectID, e: _Entry) -> None:
        if e.refs <= 0 and not e.pins and e.state != PENDING \
                and not e.waiters and not e.promote:
            self._entries.pop(oid, None)
            if e.linked is not None:
                self.released_links.append(e.linked)
                e.linked = None

    # ---- fetch serving (deferred replies: reference pubsub-on-ready) ----
    def fetch_or_wait(self, oid: ObjectID, respond: Callable,
                      nowait: bool = False) -> None:
        """respond(kind, meta, data) now or when the entry is fulfilled.
        With nowait, a PENDING entry answers "pending" immediately (used by
        direct-task arg resolution, which must never block a lease queue —
        see _deps_resolved)."""
        with self._lock:
            e = self._entries.get(oid)
            if e is None:
                respond("missing", None, None)
                return
            if e.state == PENDING:
                if nowait:
                    respond("pending", None, None)
                    return
                if e.waiters is None:
                    e.waiters = []
                e.waiters.append(lambda ent: respond(
                    {READY: "bytes", ERROR: "error", EXTERN: "extern"}.get(
                        ent.state, "missing"), ent.meta, ent.data))
                return
            kind = {READY: "bytes", ERROR: "error", EXTERN: "extern"}[e.state]
            respond(kind, e.meta, e.data)

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._entries),
                    "pending": sum(1 for e in self._entries.values()
                                   if e.state == PENDING)}


# ---------------------------------------------------------------------------
# Endpoint helpers
# ---------------------------------------------------------------------------
_machine_id_cache: Optional[str] = None


def machine_id() -> str:
    """Identity of the physical machine (NOT the logical ray_tpu_torch "host":
    several node agents with distinct host keys may share one box — the
    virtual multi-host test substrate, and co-located agents in prod).
    Used to decide whether an advertised loopback TCP endpoint is
    actually reachable."""
    global _machine_id_cache
    if _machine_id_cache is None:
        try:
            with open("/proc/sys/kernel/random/boot_id") as f:
                _machine_id_cache = f.read().strip()
        except OSError:
            import uuid

            _machine_id_cache = f"node-{uuid.getnode():x}"
    return _machine_id_cache


def pick_endpoint(addr: Optional[dict], my_host_key: str) -> Optional[tuple]:
    """Choose a reachable endpoint from an advertised address dict
    {"hk": host_key, "mid": machine id, "unix": path|None,
    "tcp": (host, port)|None}.  A loopback TCP endpoint is reachable
    from a different logical host only when both live on the same
    physical machine (owner fetches from co-located node agents — e.g.
    weight-broadcast refs consumed by rollout actors on sibling nodes)."""
    if not addr:
        return None
    same_host = addr.get("hk") == my_host_key
    if same_host and addr.get("unix"):
        return ("unix", addr["unix"])
    tcp = addr.get("tcp")
    if tcp is not None:
        host = tcp[0]
        loopback = host.startswith("127.") or host in ("localhost", "::1")
        if same_host or not loopback \
                or addr.get("mid") == machine_id():
            return ("tcp", (host, int(tcp[1])))
    return None


# Pending connections a listener queues while its accept loop runs a
# handshake (multiprocessing's default is 1: a burst of clients, a gang's
# ranks fetching from one owner at once, would be refused).
LISTEN_BACKLOG = 128


def accept_next(listener, stopped: Callable[[], bool]):
    """The next authenticated connection on ``listener``, or None once it
    is closed (``stopped()`` true, or its socket gone).  A client that
    fails the handshake (it went away, timed out or gave a wrong key)
    costs only its own connection: the loop goes on accepting."""
    from multiprocessing import AuthenticationError

    while not stopped():
        try:
            return listener.accept()
        except (EOFError, ConnectionError, AuthenticationError,
                socket.timeout):
            continue  # this client's handshake failed
        except OSError:
            return None  # the listener was closed
    return None


def _connect(endpoint: tuple, authkey: bytes):
    from multiprocessing.connection import Client

    if endpoint[0] == "unix":
        return Client(endpoint[1], family="AF_UNIX", authkey=authkey)
    return Client(tuple(endpoint[1]), family="AF_INET", authkey=authkey)


# ---------------------------------------------------------------------------
# Server
# ---------------------------------------------------------------------------
class DirectServer:
    """Per-process direct listener.  Serves:
      exec   — push a TaskSpec for execution (workers only)
      fetch  — read an owned object (deferred until fulfilled)
      pin    — borrow registration (dropped when the conn dies)
      cancel — drop a queued direct task
    """

    def __init__(self, owned: OwnedStore, authkey: bytes, host_key: str,
                 session_dir: Optional[str] = None,
                 on_exec: Optional[Callable] = None,
                 tcp_bind: Optional[str] = None):
        from multiprocessing.connection import Listener

        self.owned = owned
        self.authkey = authkey
        self.on_exec = on_exec
        self.cancelled: set = set()
        self._shutdown = False
        self._listeners = []
        addr: Dict[str, Any] = {"hk": host_key, "mid": machine_id()}
        if session_dir:
            os.makedirs(session_dir, exist_ok=True)
            path = os.path.join(session_dir,
                                f"dx-{os.urandom(6).hex()}.sock")
            lsn = Listener(path, family="AF_UNIX", backlog=LISTEN_BACKLOG,
                           authkey=authkey)
            self._listeners.append(lsn)
            addr["unix"] = path
        if tcp_bind is not None:
            lsn = Listener((tcp_bind, 0), family="AF_INET",
                           backlog=LISTEN_BACKLOG, authkey=authkey)
            self._listeners.append(lsn)
            port = lsn.address[1]
            if tcp_bind in ("0.0.0.0", "::"):
                from ray_tpu_torch._private.transfer import routable_ip

                addr["tcp"] = (routable_ip(), port)
            else:
                addr["tcp"] = (tcp_bind, port)
        self.address = addr
        for lsn in self._listeners:
            threading.Thread(target=self._accept_loop, args=(lsn,),
                             name="rtpu-direct-accept", daemon=True).start()

    def _accept_loop(self, listener):
        while True:
            conn = accept_next(listener, lambda: self._shutdown)
            if conn is None:
                return
            threading.Thread(target=self._serve, args=(conn,),
                             name="rtpu-direct-conn", daemon=True).start()

    def send_on(self, conn, msg) -> bool:
        lock = getattr(conn, "_dx_lock", None)
        try:
            if lock is not None:
                with lock:
                    conn.send(msg)
            else:
                conn.send(msg)
            return True
        except Exception:
            return False

    def _serve(self, conn):
        conn._dx_lock = threading.Lock()
        conn_pins: List[Tuple[ObjectID, bytes]] = []
        try:
            while True:
                msg = conn.recv()
                t = msg.get("t")
                if t == "exec":
                    if self.on_exec is not None:
                        self.on_exec(msg["spec"], conn)
                elif t == "execb":
                    if self.on_exec is not None:
                        for spec in msg["specs"]:
                            self.on_exec(spec, conn)
                elif t == "fetch":
                    oid = ObjectID(msg["oid"])
                    mid = msg["mid"]

                    def respond(kind, meta, data, _mid=mid, _conn=conn):
                        self.send_on(_conn, {"t": "fetch_r", "mid": _mid,
                                             "k": kind, "m": meta, "d": data})

                    self.owned.fetch_or_wait(oid, respond,
                                             nowait=bool(msg.get("nw")))
                elif t == "pin":
                    oid, tok = ObjectID(msg["oid"]), msg["tok"]
                    self.owned.pin(oid, tok)
                    conn_pins.append((oid, tok))
                elif t == "unpin":
                    oid, tok = ObjectID(msg["oid"]), msg["tok"]
                    self.owned.unpin(oid, tok)
                    try:
                        conn_pins.remove((oid, tok))
                    except ValueError:
                        pass
                elif t == "cancel":
                    self.cancelled.add(TaskID(msg["task_id"]))
        except (EOFError, OSError, BrokenPipeError):
            pass
        except Exception:
            import traceback

            traceback.print_exc()
        finally:
            # Borrower died: its pins fall away (reference: borrower-death
            # cleanup in the ownership protocol).
            for oid, tok in conn_pins:
                self.owned.unpin(oid, tok)
            try:
                conn.close()
            except Exception:
                pass

    def shutdown(self):
        self._shutdown = True
        for lsn in self._listeners:
            try:
                lsn.close()
            except Exception:
                pass


# ---------------------------------------------------------------------------
# Channel (client side)
# ---------------------------------------------------------------------------
class DirectChannel:
    """Client side of one direct connection.

    Exec pushes go through a sender thread with natural micro-batching:
    whatever accumulated while the previous send was on the wire goes out
    as ONE `execb` frame (one pickle, one write) — burst submission costs
    ~1 syscall per dozen tasks with no added latency when idle (the same
    shape as the reference's batched gRPC task pushes)."""

    def __init__(self, endpoint: tuple, authkey: bytes,
                 on_done: Optional[Callable] = None,
                 on_close: Optional[Callable] = None):
        self.endpoint = endpoint
        self.conn = _connect(endpoint, authkey)
        self.alive = True
        self.on_done = on_done
        self.on_close = on_close
        self._send_lock = threading.Lock()
        self._futs: Dict[int, Future] = {}
        self._futs_lock = threading.Lock()
        self._mid = 0
        # Function blobs already shipped on this channel (keyed by hash):
        # later execs strip the blob and the worker loads from its cache
        # (reference: the function table — functions ship once per worker,
        # not once per task).
        self.sent_funcs: set = set()
        self._outq: deque = deque()
        self._out_cond = threading.Condition()
        self._close_fired = False
        self._close_lock = threading.Lock()
        self._reader = threading.Thread(target=self._read_loop,
                                        name="rtpu-direct-chan", daemon=True)
        self._reader.start()
        self._sender = threading.Thread(target=self._send_loop,
                                        name="rtpu-direct-send", daemon=True)
        self._sender.start()

    def _read_loop(self):
        try:
            while True:
                msg = self.conn.recv()
                t = msg.get("t")
                if t == "doneb":
                    if self.on_done is not None:
                        for m in msg["dones"]:
                            self.on_done(m)
                elif t == "done":
                    if self.on_done is not None:
                        self.on_done(msg)
                elif t == "fetch_r":
                    with self._futs_lock:
                        fut = self._futs.pop(msg["mid"], None)
                    if fut is not None and not fut.done():
                        fut.set_result(msg)
        except (EOFError, OSError, BrokenPipeError):
            pass
        except Exception:
            import traceback

            traceback.print_exc()
        finally:
            self._fire_close()

    def _fire_close(self):
        self.alive = False
        with self._close_lock:
            if self._close_fired:
                return
            self._close_fired = True
        with self._out_cond:
            self._out_cond.notify_all()
        with self._futs_lock:
            futs, self._futs = list(self._futs.values()), {}
        for fut in futs:
            if not fut.done():
                fut.set_exception(
                    exc.RayTpuError("direct connection closed"))
        if self.on_close is not None:
            try:
                self.on_close(self)
            except Exception:
                pass

    def _send_loop(self):
        while True:
            with self._out_cond:
                while not self._outq and self.alive:
                    self._out_cond.wait()
                if not self.alive:
                    return
                batch = []
                while self._outq and len(batch) < 128:
                    batch.append(self._outq.popleft())
            import copy as _copy

            wire = []
            for spec in batch:
                h = spec.func_hash
                if spec.func_blob is not None and h is not None:
                    if h in self.sent_funcs:
                        # Strip on a shallow COPY: the original spec may be
                        # re-pickled concurrently by a classic reroute.
                        spec = _copy.copy(spec)
                        spec.func_blob = None
                    else:
                        self.sent_funcs.add(h)
                wire.append(spec)
            msg = ({"t": "exec", "spec": wire[0]} if len(wire) == 1
                   else {"t": "execb", "specs": wire})
            if not self.send(msg):
                self._fire_close()
                return

    def send(self, msg) -> bool:
        try:
            with self._send_lock:
                self.conn.send(msg)
            return True
        except Exception:
            self.alive = False
            return False

    def exec(self, spec: TaskSpec) -> bool:
        """Queue a task push (sender thread delivers; False if the channel
        is already dead — the caller re-routes)."""
        if not self.alive:
            return False
        with self._out_cond:
            self._outq.append(spec)
            self._out_cond.notify()
        return True

    def fetch(self, oid: ObjectID, timeout: Optional[float] = None,
              nowait: bool = False):
        with self._futs_lock:
            self._mid += 1
            mid = self._mid
            fut: Future = Future()
            self._futs[mid] = fut
        msg = {"t": "fetch", "mid": mid, "oid": oid.binary()}
        if nowait:
            msg["nw"] = 1
        if not self.send(msg):
            raise exc.RayTpuError("direct connection closed")
        # timeout=None waits indefinitely: the owner ALWAYS answers a
        # deferred fetch (on fulfill, or the connection breaks on owner
        # death, which surfaces here as an exception).
        return fut.result(timeout=timeout)

    def pin(self, oid: ObjectID, token: bytes) -> bool:
        return self.send({"t": "pin", "oid": oid.binary(), "tok": token})

    def unpin(self, oid: ObjectID, token: bytes) -> bool:
        return self.send({"t": "unpin", "oid": oid.binary(), "tok": token})

    def cancel(self, task_id: TaskID) -> bool:
        return self.send({"t": "cancel", "task_id": task_id.binary()})

    def close(self):
        self.alive = False
        try:
            self.conn.close()
        except Exception:
            pass


# ---------------------------------------------------------------------------
# Submitter (caller side): leases + actor channels + borrows
# ---------------------------------------------------------------------------
class _Lease:
    __slots__ = ("worker_id", "chan", "inflight", "idle_since", "alive")

    def __init__(self, worker_id: bytes, chan: DirectChannel):
        self.worker_id = worker_id
        self.chan = chan
        self.inflight = 0
        self.idle_since = time.monotonic()
        self.alive = True


A_RESOLVING, A_UP, A_CLASSIC = 0, 1, 2


class _ActorClient:
    __slots__ = ("actor_id", "state", "chan", "queue", "inflight",
                 "worker_id")

    def __init__(self, actor_id):
        self.actor_id = actor_id
        self.state = A_RESOLVING
        self.chan: Optional[DirectChannel] = None
        self.queue: deque = deque()      # specs waiting for the channel
        self.inflight: Dict[TaskID, TaskSpec] = {}
        # The incarnation (worker id bytes) this client is connected to:
        # dead-channel reroutes carry it so the head can tell "this call
        # ran on the incarnation that died" from a fresh submission and
        # never replays a budget-exhausted call on a restarted actor.
        self.worker_id: Optional[bytes] = None


class _Inflight:
    __slots__ = ("spec", "lease", "actor", "pins")

    def __init__(self, spec, lease=None, actor=None, pins=None):
        self.spec = spec
        self.lease = lease
        self.actor = actor
        self.pins = pins or []  # list of ("owned"|"owner"|"head", oid, extra)


class DirectSubmitter:
    """Caller-side engine: keeps leases warm per scheduling class, one
    direct channel per actor, in-flight bookkeeping with client-side
    retries, and borrow pins at remote owners."""

    # A lease is considered saturated past this many queued pushes; the
    # submitter then asks for one more lease (grants arrive async).
    _GROW_AT = 2

    def __init__(self, core):
        from ray_tpu_torch._private.config import CONFIG

        self.core = core
        self.owned: OwnedStore = core._owned
        self.host_key = core.host_key
        self.authkey = core.transport.authkey
        self._lock = threading.RLock()
        self._leases: Dict[tuple, List[_Lease]] = {}
        self._lease_req: set = set()       # classes with a grant in flight
        self._lease_backoff: Dict[tuple, float] = {}  # class -> retry-at
        self._actors: Dict[Any, _ActorClient] = {}
        self._fetch_chans: Dict[tuple, DirectChannel] = {}
        self._inflight: Dict[TaskID, _Inflight] = {}
        self._cancelled: set = set()
        self._lease_idle_s = CONFIG.lease_idle_s
        self._closed = False
        self._maint = threading.Thread(target=self._maintenance,
                                       name="rtpu-direct-maint", daemon=True)
        self._maint.start()

    # ================= normal tasks =================
    def _deps_resolved(self, spec: TaskSpec) -> bool:
        """Push only tasks with NO ref dependencies (direct or contained).

        The reference resolves deps before pushing leased tasks
        (LocalDependencyResolver, direct_task_transport.h:40); here any
        dependency-shaped task takes the classic path instead — the head
        dispatches those only to idle workers (a pending dep pushed onto a
        lease queue would block the worker loop and can starve the very
        producer queued behind it), and a worker blocked resolving an arg
        releases its cpu (on_worker_blocked).  Leases carry the high-rate
        independent-task pattern, which is where the head round trip
        actually hurts."""
        for arg in list(spec.args) + list(spec.kwargs.values()):
            if arg.ref is not None or arg.contained:
                return False
        return True

    def submit_task(self, spec: TaskSpec) -> bool:
        """Try to push `spec` over a cached lease.  False → classic path."""
        if (spec.task_type != TaskType.NORMAL
                or spec.scheduling_strategy.kind != "DEFAULT"
                or spec.task_id in self._cancelled):
            return False
        if (spec.args or spec.kwargs) and not self._deps_resolved(spec):
            return False
        key = spec.scheduling_class()
        with self._lock:
            if self._closed:
                return False
            pool = [l for l in self._leases.get(key, []) if l.alive]
            lease = min(pool, key=lambda l: l.inflight, default=None)
            if lease is None or lease.inflight >= self._GROW_AT:
                self._request_lease_async(key, spec)
            if lease is None:
                return False
            pins = self._commit(spec)
            lease.inflight += 1
            self._inflight[spec.task_id.binary()] = _Inflight(
                spec, lease=lease, pins=pins)
        if not lease.chan.exec(spec):
            self._on_chan_close(lease.chan)  # re-route in-flights
        return True

    def _request_lease_async(self, key: tuple, spec: TaskSpec):
        """One outstanding grant request per scheduling class (under lock),
        with a short backoff after a refused grant — a saturated cluster
        must not pay a request thread per submission."""
        if key in self._lease_req or self._closed:
            return
        if time.monotonic() < self._lease_backoff.get(key, 0.0):
            return
        self._lease_req.add(key)
        resources = dict(spec.resources)

        def run():
            granted = None
            try:
                granted = self.core.transport.request(
                    "lease_worker", {"resources": resources})
            except Exception:
                granted = None
            try:
                if not granted:
                    with self._lock:
                        self._lease_backoff[key] = time.monotonic() + 0.05
                if granted:
                    ep = pick_endpoint(granted["addr"], self.host_key)
                    if ep is None:
                        self.core.transport.request_oneway(
                            "return_lease",
                            {"worker_id": granted["worker_id"]})
                        return
                    chan = DirectChannel(ep, self.authkey,
                                         on_done=self._on_done,
                                         on_close=self._on_chan_close)
                    lease = _Lease(granted["worker_id"], chan)
                    with self._lock:
                        if self._closed:
                            chan.close()
                            self.core.transport.request_oneway(
                                "return_lease",
                                {"worker_id": granted["worker_id"]})
                            return
                        self._leases.setdefault(key, []).append(lease)
            except Exception:
                pass
            finally:
                with self._lock:
                    self._lease_req.discard(key)

        threading.Thread(target=run, name="rtpu-lease-req",
                         daemon=True).start()

    # ================= actor tasks =================
    def submit_actor_task(self, spec: TaskSpec) -> bool:
        with self._lock:
            if self._closed:
                return False
            ac = self._actors.get(spec.actor_id)
            if ac is None:
                ac = self._actors[spec.actor_id] = _ActorClient(spec.actor_id)
                self._resolve_actor_async(ac)
            if ac.state == A_CLASSIC:
                return False
            pins = self._commit(spec)
            inf = _Inflight(spec, actor=ac, pins=pins)
            self._inflight[spec.task_id.binary()] = inf
            if ac.state == A_RESOLVING or ac.chan is None:
                ac.queue.append(spec)
                return True
            ac.inflight[spec.task_id.binary()] = spec
            chan = ac.chan
        if not chan.exec(spec):
            self._on_chan_close(chan)
        return True

    def _resolve_actor_async(self, ac: _ActorClient):
        def run():
            chan = None
            # Stale-address window: right after an actor's worker dies, the
            # head may still advertise the old address until its health
            # poll fires.  Re-resolve a few times before giving up on the
            # direct path (the addr request itself blocks while the actor
            # is pending/restarting).
            for attempt in range(20):
                try:
                    got = self.core.transport.request(
                        "actor_direct_addr", {"actor_id": ac.actor_id})
                except BaseException as e:
                    # Actor dead (or head trouble): the head is the
                    # authority — route queued calls through it for
                    # authoritative errors / restart handling.
                    self._actor_to_classic(ac, e)
                    return
                ep = pick_endpoint(got and got.get("addr"), self.host_key)
                if ep is None:
                    self._actor_to_classic(ac, None)
                    return
                ac.worker_id = got.get("worker_id")
                try:
                    chan = DirectChannel(ep, self.authkey,
                                         on_done=self._on_done,
                                         on_close=self._on_chan_close)
                    break
                except Exception:
                    chan = None
                    if self._closed:
                        return
                    time.sleep(0.25)
            if chan is None:
                self._actor_to_classic(ac, None)
                return
            dead = False
            with self._lock:
                # Publish ac.chan FIRST (state stays A_RESOLVING so
                # concurrent submits still queue): if the channel dies at
                # any point — exec returning False mid-drain, or the
                # reader's close callback racing this block —
                # _on_chan_close(chan) must match this actor and replay
                # the specs already moved into ac.inflight; with ac.chan
                # unset they would strand in A_RESOLVING forever.
                ac.chan = chan
                # Enqueue the backlog onto the channel BEFORE exposing
                # A_UP: chan.exec only appends to the sender queue, so a
                # concurrent submit observing A_UP cannot overtake queued
                # calls (per-caller actor ordering).
                while ac.queue:
                    spec = ac.queue.popleft()
                    ac.inflight[spec.task_id.binary()] = spec
                    if not chan.exec(spec):
                        dead = True
                        break
                if not dead:
                    ac.state = A_UP
            if dead:
                self._on_chan_close(chan)
                return

        threading.Thread(target=run, name="rtpu-actor-resolve",
                         daemon=True).start()

    def _actor_to_classic(self, ac: _ActorClient, _err):
        """Hand an actor's queued + future calls to the classic head path.
        Their owned entries flip EXTERN so results (including authoritative
        death errors) resolve through the head.  Drain-then-flip: new calls
        keep queueing (state stays RESOLVING) until the backlog has been
        rerouted, so the head sees them in submission order."""
        while True:
            with self._lock:
                specs = list(ac.queue) + list(ac.inflight.values())
                ac.queue.clear()
                ac.inflight.clear()
                if not specs:
                    ac.state = A_CLASSIC
                    return
            for spec in specs:
                self._reroute_classic(spec, actor=True)

    def _reroute_classic(self, spec: TaskSpec, actor: bool = False,
                         inf: Optional[_Inflight] = None,
                         dead_worker: Optional[bytes] = None):
        if inf is None:
            with self._lock:
                inf = self._inflight.pop(spec.task_id.binary(), None)
        if inf is not None:
            self._release_pins(inf)
        for oid in spec.return_ids():
            self._make_extern_mirrored(oid)
        try:
            self.core._promote_owned_args(spec)
            payload = {"spec": spec}
            if dead_worker is not None:
                # Budget-exhausted call from a dead channel: the head
                # must FAIL it if the actor's incarnation has moved on —
                # re-executing it on the restarted actor would replay a
                # possibly-fatal call the caller already gave up on.
                payload["dead_worker"] = dead_worker
            self.core.transport.request_oneway(
                "actor_call" if actor else "submit", payload)
        except Exception:
            meta, data = _pack_error(exc.RayTpuError(
                "task lost: could not reach the head for fallback"))
            for oid in spec.return_ids():
                self.owned.fulfill_error(oid, meta, data)

    def _make_extern_mirrored(self, oid: ObjectID):
        """EXTERN transition + refcount mirroring to the head directory."""
        had, has_refs = self.owned.make_extern(oid)
        if not had:
            return
        holder = self.core.worker_id.binary()
        try:
            self.core.transport.request_oneway(
                "add_ref", {"oid": oid, "holder": holder})
            if not has_refs:
                self.core.transport.request_oneway(
                    "remove_ref", {"oid": oid, "holder": holder})
        except Exception:
            pass

    # ================= completion =================
    def _on_done(self, msg: dict):
        tid = msg["task_id"]
        with self._lock:
            inf = self._inflight.pop(tid, None)
            if inf is None:
                return
            if inf.lease is not None:
                inf.lease.inflight -= 1
                inf.lease.idle_since = time.monotonic()
            if inf.actor is not None:
                inf.actor.inflight.pop(tid, None)
        spec = inf.spec
        if msg.get("unready"):
            # Worker bounced the push: a dep was still pending at its owner.
            # Re-route through the head (no attempt charge — nothing ran).
            self._reroute_classic(spec, actor=inf.actor is not None, inf=inf)
            return
        error = msg.get("error")
        if (error is not None and spec.retry_exceptions
                and spec.attempt < spec.max_retries
                and spec.task_id not in self._cancelled):
            spec.attempt += 1
            with self._lock:
                self._inflight[tid] = inf  # keep pins across the retry
                resub = False
                chan = None
                if inf.actor is not None and inf.actor.state == A_UP:
                    inf.actor.inflight[tid] = spec
                    chan = inf.actor.chan
                    resub = True
                elif inf.lease is not None and inf.lease.alive:
                    inf.lease.inflight += 1
                    chan = inf.lease.chan
                    resub = True
            if resub and chan.exec(spec):
                return
            with self._lock:
                self._inflight.pop(tid, None)
                if inf.lease is not None and resub:
                    inf.lease.inflight -= 1  # the push we just failed
                if inf.actor is not None:
                    inf.actor.inflight.pop(tid, None)
            self._reroute_classic(spec, actor=inf.actor is not None,
                                  inf=inf)
            return
        self._release_pins(inf)
        self._cancelled.discard(spec.task_id)
        results = msg.get("results") or []
        got = set()
        for res in results:
            got.add(res.object_id)
            if res.inline is not None:
                contained = getattr(res, "contained", None)
                if contained:
                    self._take_contained_pins(spec, res, contained)
                self.owned.fulfill_inline(res.object_id, res.inline[0],
                                          res.inline[1])
                if self.owned.take_promote(res.object_id):
                    # A classic-path consumer is waiting on the head for
                    # these bytes (see _promote_owned_args).
                    self.core.promote_owned_to_head(res.object_id)
            else:
                # Large result: sealed into the node store; head directory
                # learned it from the worker's seal message.
                self._make_extern_mirrored(res.object_id)
        if error is not None:
            for oid in spec.return_ids():
                if oid not in got:
                    self.owned.fulfill_error(oid, error[0], error[1])
                    if self.owned.take_promote(oid):
                        self.core.promote_owned_to_head(oid)

    def _is_self(self, owner: Optional[dict]) -> bool:
        mine = self.core.direct_addr
        if owner is None or mine is None:
            return False
        if owner is mine:
            return True
        return owner.get("unix") is not None \
            and owner.get("unix") == mine.get("unix")

    def _take_contained_pins(self, spec: TaskSpec, res, contained):
        """Contained-ref handover: register `res:` pins (tied to the
        result entry's lifetime) at each nested ref's owner, then release
        the returner's `ret:` pin — ordered on the same channel so the
        object can never be unpinned-before-pinned."""
        token = b"res:" + res.object_id.binary()
        ret_tok = b"ret:" + spec.task_id.binary()
        for oid_b, owner, prepinned in contained:
            oid = ObjectID(oid_b)
            try:
                if owner is None:
                    # Head-counted nested ref: swap the returner's ret:
                    # head ref for a res: ref tied to the result entry.
                    # Both ride OUR head conn in order, so the add lands
                    # before the release.
                    self.core.transport.request_oneway(
                        "add_ref", {"oid": oid, "holder": token})
                    self.core.transport.request_oneway(
                        "remove_ref", {"oid": oid, "holder": ret_tok})
                elif self._is_self(owner):
                    self.owned.pin(oid, token)
                    if prepinned:
                        self.owned.unpin(oid, ret_tok)
                else:
                    ch = self._fetch_chan_for(owner)
                    if ch is not None:
                        ch.pin(oid, token)
                        if prepinned:
                            ch.unpin(oid, ret_tok)
            except Exception:
                pass
        if not self.owned.set_linked(res.object_id, (token, contained)):
            # Result entry already gone (nobody holds it): release now.
            self.owned.released_links.append((token, contained))

    def _drain_released_links(self):
        while True:
            try:
                token, contained = self.owned.released_links.popleft()
            except IndexError:
                return
            for oid_b, owner, _prepinned in contained:
                oid = ObjectID(oid_b)
                try:
                    if owner is None:
                        self.core.transport.request_oneway(
                            "remove_ref", {"oid": oid, "holder": token})
                    elif self._is_self(owner):
                        self.owned.unpin(oid, token)
                    else:
                        self.unpin_at_owner(oid, owner, token)
                except Exception:
                    pass

    def _on_chan_close(self, chan: DirectChannel):
        """A direct connection died.  Leased tasks retry (budget permitting)
        via the classic path; actor tasks re-resolve the actor and replay in
        order (the reference's restart replay, task_manager.h)."""
        dead_actor: Optional[_ActorClient] = None
        to_retry: List[_Inflight] = []
        to_fail: List[_Inflight] = []
        with self._lock:
            for key, pool in list(self._leases.items()):
                for lease in list(pool):
                    if lease.chan is chan:
                        lease.alive = False
                        pool.remove(lease)
            dead_worker_id: Optional[bytes] = None
            for ac in self._actors.values():
                if ac.chan is chan:
                    dead_actor = ac
                    ac.chan = None
                    dead_worker_id = ac.worker_id
            if dead_actor is not None:
                replay: List[TaskSpec] = []
                no_budget: List[TaskSpec] = []
                for tid, spec in list(dead_actor.inflight.items()):
                    inf = self._inflight.get(tid)
                    if spec.task_id in self._cancelled:
                        self._inflight.pop(tid, None)
                        if inf is not None:
                            to_fail.append(inf)
                    elif spec.attempt < spec.max_retries:
                        spec.attempt += 1
                        replay.append(spec)
                    else:
                        # No retry budget: let the HEAD fail it — the head
                        # processes the worker death and produces the
                        # authoritative cause/ordering (our local verdict
                        # would race calls submitted before the head
                        # notices the death).
                        no_budget.append(spec)
                dead_actor.inflight.clear()
                dead_actor.queue.extendleft(reversed(replay))
                dead_actor.state = A_RESOLVING
            for tid, inf in list(self._inflight.items()):
                if inf.lease is not None and inf.lease.chan is chan:
                    self._inflight.pop(tid, None)
                    if inf.spec.attempt < inf.spec.max_retries \
                            and inf.spec.task_id not in self._cancelled:
                        inf.spec.attempt += 1
                        to_retry.append(inf)
                    else:
                        to_fail.append(inf)
        for inf in to_fail:
            self._release_pins(inf)
            cancelled = inf.spec.task_id in self._cancelled
            self._cancelled.discard(inf.spec.task_id)
            err = (exc.RayTpuError("task cancelled") if cancelled
                   else (exc.ActorDiedError("actor worker died")
                         if inf.actor is not None
                         else exc.WorkerCrashedError(
                             "worker died executing a direct task")))
            meta, data = _pack_error(err)
            for oid in inf.spec.return_ids():
                self.owned.fulfill_error(oid, meta, data)
        for inf in to_retry:
            self._release_pins(inf)
            if not self.submit_task(inf.spec):
                self._reroute_classic(inf.spec)
        if dead_actor is not None:
            for spec in no_budget:
                self._reroute_classic(spec, actor=True,
                                      dead_worker=dead_worker_id)
            if not self._closed:
                self._resolve_actor_async(dead_actor)

    # ================= cancel =================
    def cancel(self, task_id: TaskID) -> bool:
        """True if this submitter knows the task (direct in-flight)."""
        with self._lock:
            inf = self._inflight.get(task_id.binary())
            if inf is None:
                return False
            self._cancelled.add(task_id)
            chan = (inf.lease.chan if inf.lease is not None
                    else inf.actor.chan if inf.actor is not None else None)
            wid = inf.lease.worker_id if inf.lease is not None else None
        if chan is not None:
            chan.cancel(task_id)  # drops it if still queued worker-side
        if wid is not None:
            # Running normal task: match the classic coarse-cancel (kill the
            # worker; the channel-close path fails the task as cancelled).
            try:
                self.core.transport.request_oneway("kill_worker",
                                                   {"worker_id": wid})
            except Exception:
                pass
        return True

    # ================= pins / borrows =================
    def _commit(self, spec: TaskSpec) -> list:
        """Create owned entries for returns; pin ref args for the task's
        lifetime (owner-side arg pinning — the reference pins at the head
        via dependency_manager.h; here the *owner* of each arg pins)."""
        for oid in spec.return_ids():
            self.owned.create_pending(oid)
        if not spec.args and not spec.kwargs:
            return None
        token = b"task:" + spec.task_id.binary()
        pins = []
        for arg in list(spec.args) + list(spec.kwargs.values()):
            oids = ([arg.ref] if arg.ref is not None else []) + arg.contained
            owners = dict(getattr(arg, "contained_owners", None) or {})
            if arg.ref is not None and getattr(arg, "owner", None):
                owners[arg.ref.binary()] = arg.owner
            for oid in oids:
                if self.owned.contains(oid):
                    self.owned.pin(oid, token)
                    pins.append(("owned", oid, None))
                    continue
                owner = owners.get(oid.binary())
                if owner:
                    ch = self._fetch_chan_for(owner)
                    if ch is not None:
                        ch.pin(oid, token)
                        pins.append(("owner", oid, owner))
                        continue
                self.core.transport.request_oneway(
                    "add_ref", {"oid": oid, "holder": token})
                pins.append(("head", oid, None))
        return pins

    def _release_pins(self, inf: _Inflight):
        token = b"task:" + inf.spec.task_id.binary()
        for kind, oid, extra in inf.pins:
            try:
                if kind == "owned":
                    self.owned.unpin(oid, token)
                elif kind == "owner":
                    ch = self._fetch_chan_for(extra)
                    if ch is not None:
                        ch.unpin(oid, token)
                else:
                    self.core.transport.request_oneway(
                        "remove_ref", {"oid": oid, "holder": token})
            except Exception:
                pass
        inf.pins = []

    def _fetch_chan_for(self, addr: Optional[dict]) -> Optional[DirectChannel]:
        ep = pick_endpoint(addr, self.host_key)
        if ep is None:
            return None
        key = (ep[0], tuple(ep[1]) if isinstance(ep[1], (list, tuple))
               else ep[1])
        with self._lock:
            ch = self._fetch_chans.get(key)
            if ch is not None and ch.alive:
                return ch
            try:
                ch = DirectChannel(ep, self.authkey, on_done=self._on_done,
                                   on_close=self._on_chan_close)
            except Exception:
                return None
            self._fetch_chans[key] = ch
            return ch

    def fetch_from_owner(self, oid: ObjectID, owner: dict,
                         timeout: Optional[float],
                         nowait: bool = False) -> Optional[dict]:
        """Fetch an object's bytes from its owner.  Returns the fetch_r
        message, or None if the owner is unreachable."""
        ch = self._fetch_chan_for(owner)
        if ch is None:
            return None
        try:
            return ch.fetch(oid, timeout, nowait=nowait)
        except FuturesTimeoutError:
            raise exc.GetTimeoutError(f"get({oid}) timed out")
        except Exception:
            return None

    def pin_at_owner(self, oid: ObjectID, owner: dict, token: bytes) -> bool:
        ch = self._fetch_chan_for(owner)
        return ch is not None and ch.pin(oid, token)

    def unpin_at_owner(self, oid: ObjectID, owner: dict, token: bytes):
        ch = self._fetch_chan_for(owner)
        if ch is not None:
            ch.unpin(oid, token)

    # ================= maintenance =================
    def _maintenance(self):
        while not self._closed:
            time.sleep(0.2)
            self._drain_released_links()
            drop: List[Tuple[tuple, _Lease]] = []
            now = time.monotonic()
            with self._lock:
                for key, pool in self._leases.items():
                    for lease in list(pool):
                        if not lease.alive or (
                                lease.inflight == 0
                                and now - lease.idle_since
                                > self._lease_idle_s):
                            pool.remove(lease)
                            drop.append((key, lease))
            for _key, lease in drop:
                lease.alive = False
                try:
                    lease.chan.close()
                except Exception:
                    pass
                try:
                    self.core.transport.request_oneway(
                        "return_lease", {"worker_id": lease.worker_id})
                except Exception:
                    pass

    def shutdown(self):
        with self._lock:
            self._closed = True
            leases = [l for pool in self._leases.values() for l in pool]
            self._leases.clear()
            chans = list(self._fetch_chans.values())
            self._fetch_chans.clear()
            actors = list(self._actors.values())
            self._actors.clear()
        for lease in leases:
            try:
                lease.chan.close()
            except Exception:
                pass
            try:
                self.core.transport.request_oneway(
                    "return_lease", {"worker_id": lease.worker_id})
            except Exception:
                pass
        for ac in actors:
            if ac.chan is not None:
                try:
                    ac.chan.close()
                except Exception:
                    pass
        for ch in chans:
            try:
                ch.close()
            except Exception:
                pass


def _pack_error(error: BaseException) -> Tuple[bytes, bytes]:
    return ser.pack(ser.serialize(error))
