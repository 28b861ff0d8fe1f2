"""CoreWorker: per-process runtime — object put/get/wait, task submission,
task execution.  Used by the driver (direct in-process transport to the Head)
and by subprocess workers (socket transport).

Reference equivalents: CoreWorker (src/ray/core_worker/core_worker.h:278),
the in-process memory store (store_provider/memory_store/memory_store.h:43),
the plasma provider (store_provider/plasma_store_provider.h:88) and the
Python-side execute_task loop (python/ray/_raylet.pyx:701).

Copied from ``ray_tpu/_private/worker.py`` (the JAX package).
"""
from __future__ import annotations

import contextlib
import hashlib
import threading
import traceback
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FuturesTimeoutError
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import cloudpickle

from ray_tpu_torch import exceptions as exc
from ray_tpu_torch import object_ref as object_ref_mod
from ray_tpu_torch._private import object_store as store_mod
from ray_tpu_torch._private import serialization as ser
from ray_tpu_torch._private.ids import ActorID, JobID, NodeID, ObjectID, TaskID, WorkerID
from ray_tpu_torch._private.object_store import INLINE_OBJECT_THRESHOLD
from ray_tpu_torch._private.task_spec import (
    ArgKind,
    TaskArg,
    TaskResult,
    TaskSpec,
    TaskType,
)
from ray_tpu_torch.object_ref import ObjectRef


_tracing_mod = None


def _tracing():
    """Lazy tracing-module accessor: imported at first use, not module
    scope (ray_tpu_torch.util imports back into ray_tpu_torch during bootstrap)."""
    global _tracing_mod
    if _tracing_mod is None:
        from ray_tpu_torch.util import tracing as _t

        _tracing_mod = _t
    return _tracing_mod


_obs_mod = None


def _obs():
    """Lazy observability-module accessor (same bootstrap constraint)."""
    global _obs_mod
    if _obs_mod is None:
        from ray_tpu_torch import observability as _o

        _obs_mod = _o
    return _obs_mod


# ---------------------------------------------------------------------------
# Transports
# ---------------------------------------------------------------------------
def _reraise_reply_error(fut: Future) -> None:
    """Raise the error a reply carried, when the future holds one.
    ``concurrent.futures.TimeoutError`` is the builtin ``TimeoutError``, so
    ``except FuturesTimeoutError`` also catches a reply's own
    ``GetTimeoutError`` (a ``TimeoutError``); that is the head's answer, not
    a lost reply, and must reach the caller as it is."""
    if fut.done() and fut.exception() is not None:
        raise fut.exception()


class DirectTransport:
    """Driver-side transport: function calls straight into the Head."""

    def __init__(self, head, worker_id: WorkerID):
        import itertools
        import os as _os

        self.head = head
        self.worker_id = worker_id
        self.authkey = head.authkey
        # Idempotency-key namespace: used only while a net-fault schedule
        # is active (in-process calls cannot be lost otherwise).
        self._key_prefix = _os.urandom(8)
        self._key_counter = itertools.count(1)

    def _net_schedule(self):
        from ray_tpu_torch._private.chaos import net_schedule

        return net_schedule()

    def request(self, op: str, payload: dict, timeout: Optional[float] = None):
        import time as _time

        sched = self._net_schedule()
        if sched is not None:
            return self._request_faulted(sched, op, payload, timeout)
        fut: Future = Future()

        def reply(value=None, error=None):
            if error is not None:
                if not fut.done():
                    fut.set_exception(error)
            elif not fut.done():
                fut.set_result(value)

        start = _time.monotonic()
        self.head.handle_request(op, payload, reply, self.worker_id)
        try:
            # timeout=None keeps blocking semantics (in-process calls
            # cannot lose their reply); a given timeout is enforced.
            return fut.result(timeout=timeout)
        except FuturesTimeoutError:
            _reraise_reply_error(fut)
            raise exc.RpcTimeoutError(
                op=op, elapsed=_time.monotonic() - start, timeout=timeout)

    def _request_faulted(self, sched, op: str, payload: dict,
                         timeout: Optional[float]):
        """Chaos path: the schedule may drop/dup/delay the request or its
        reply, so the call runs a keyed retry loop — resends carry the
        same idempotency key and the head's reply cache applies the op
        exactly once, replaying the recorded reply to late attempts."""
        import time as _time

        from ray_tpu_torch._private import retry as retry_mod
        from ray_tpu_torch._private.chaos import net_request_label

        default_total, attempt_iv = retry_mod.rpc_defaults()
        deadline = retry_mod.Deadline(
            timeout if timeout is not None else default_total)
        key = self._key_prefix + next(self._key_counter).to_bytes(8, "little")
        label = net_request_label(op, payload)
        fut: Future = Future()

        def reply(value=None, error=None):
            act = sched.fault(f"reply:{label}")
            kind = act[0] if act is not None else None
            if kind in ("drop", "sever"):
                return
            if kind == "delay":
                _time.sleep(act[1] / 1000.0)
            if error is not None:
                if not fut.done():
                    fut.set_exception(error)
            elif not fut.done():
                fut.set_result(value)

        attempts = 0
        while True:
            act = sched.fault(f"request:{label}")
            kind = act[0] if act is not None else None
            if kind == "delay":
                _time.sleep(act[1] / 1000.0)
            if kind not in ("drop", "sever"):
                for _ in range(2 if kind == "dup" else 1):
                    self.head.handle_request_keyed(op, payload, reply,
                                                   self.worker_id, key)
            attempts += 1
            try:
                return fut.result(
                    timeout=max(0.001, deadline.bound(attempt_iv)))
            except FuturesTimeoutError:
                _reraise_reply_error(fut)
            if deadline.expired():
                retry_mod.note("timeouts")
                raise exc.RpcTimeoutError(op=op, elapsed=deadline.elapsed(),
                                          timeout=deadline.timeout,
                                          attempts=attempts)
            retry_mod.note("retries")

    def request_oneway(self, op: str, payload: dict):
        """Fire-and-forget request — the reply (always just an ack on these
        ops) is dropped; errors surface through the task result path.
        Under an active net-fault schedule the op rides the acked, keyed
        request path instead, so a dropped frame is retried and a
        duplicated one applied exactly once."""
        if self._net_schedule() is not None:
            self.request(op, payload)
            return
        self.head.handle_request(op, payload, lambda *a, **k: None,
                                 self.worker_id)

    def notify(self, msg: dict):
        if self._net_schedule() is not None:
            self.request("notify_msg", {"msg": msg})
            return
        t = msg["type"]
        if t == "seal":
            self.head.on_seal(msg)
        elif t == "put_inline":
            self.head.on_put_inline(msg)
        elif t == "seal_batch":
            self.head.on_seal_batch(msg)
        elif t == "put_inline_batch":
            self.head.on_put_inline_batch(msg)
        elif t == "task_done":
            self.head.on_task_done(msg)
        elif t == "arena_sealed":
            self.head.on_arena_sealed(msg)
        elif t == "arena_release":
            self.head.on_arena_release(msg)
        elif t == "object_partial":
            self.head.on_object_partial(msg, self.head.host_key)
        elif t == "object_partial_drop":
            self.head.on_object_partial_drop(msg)

    def store_for(self, node_id):
        """In-process fast path: the driver writes straight into the head
        raylet's store — the native arena when present, pooled shm
        segments otherwise (zero IPC either way)."""
        raylet = self.head.raylets.get(node_id)
        return raylet.store if raylet is not None else None

    def close(self):
        pass


class _Rpc:
    """One logical RPC on a ConnTransport: a single msg_id + idempotency
    key for its whole lifetime — retries resend the *identical* frame, so
    replies to any attempt resolve the same record and the head's reply
    cache applies the op exactly once."""

    __slots__ = ("fut", "op", "frame", "key", "deadline", "started",
                 "last_send", "attempts", "mode", "thread_id", "dumped")

    def __init__(self, fut, op: str, frame: dict, key: bytes, deadline,
                 mode: str):
        import time as _time

        self.fut = fut
        self.op = op
        self.frame = frame
        self.key = key
        self.deadline = deadline
        now = _time.monotonic()
        self.started = now
        self.last_send = now
        self.attempts = 0
        self.mode = mode  # "call" (blocking) | "async" (acked one-way)
        self.thread_id = threading.get_ident()
        self.dumped = False


class ConnTransport:
    """Subprocess-worker transport over a multiprocessing Connection.

    A reader thread (owned by default_worker) routes replies into
    self._pending; sends are serialized by a lock.

    Deadlines + retries: every ``request`` frame carries an idempotency
    key.  A blocking request waits ``rpc_attempt_timeout`` for its reply
    and then resends the same frame (exponentially paced), bounded by the
    caller's timeout (or RAY_TPU_TORCH_RPC_TIMEOUT when set) — on expiry it
    raises :class:`RpcTimeoutError` instead of blocking forever.  Under
    ``rpc_acked_ops`` (auto-on while a net-fault schedule is active),
    one-way ops (submits, seal/put notifies, task_done) also ride keyed
    request frames; a keeper thread resends the unacked ones, and the
    head's reply cache makes any resend/duplicate exactly-once.  On head
    failover ``replace_conn`` keeps unacked requests registered so they
    are *resent* on the new connection instead of erroring.  The keeper
    doubles as the hung-call watchdog: in-flight ages feed
    retry.rpc_inflight_stats() and calls older than ``rpc_hang_dump_s``
    get their waiting thread's stack dumped to stderr."""

    def __init__(self, conn, authkey: Optional[bytes] = None):
        import os

        from ray_tpu_torch._private import chaos as chaos_mod
        from ray_tpu_torch._private import retry as retry_mod

        self.conn = chaos_mod.wrap_net_faults(conn)
        self.authkey = authkey
        if self.authkey is None:
            hexkey = os.environ.get("RAY_TPU_TORCH_AUTHKEY")
            self.authkey = bytes.fromhex(hexkey) if hexkey else None
        self._send_lock = threading.Lock()
        self._pending: Dict[int, _Rpc] = {}
        self._msg_counter = 0
        self._futures_lock = threading.Lock()
        self._key_prefix = os.urandom(8)
        self._closed = False
        # Cleared while a reconnect handshake is in flight so resends
        # don't race ahead of re-registration on the fresh conn.
        self._resume_evt = threading.Event()
        self._resume_evt.set()
        self._keeper: Optional[threading.Thread] = None
        retry_mod.register_transport(self)

    # ---- config / chaos accessors ----
    def _acked_ops(self) -> bool:
        from ray_tpu_torch._private.chaos import net_schedule

        if net_schedule() is not None:
            return True
        from ray_tpu_torch._private.config import CONFIG

        return bool(CONFIG.rpc_acked_ops)

    def pending_rpcs(self) -> List[_Rpc]:
        with self._futures_lock:
            return list(self._pending.values())

    def _register(self, op: str, payload: dict, deadline, mode: str) -> _Rpc:
        with self._futures_lock:
            if self._closed:
                raise exc.RayTpuError("connection closed")
            self._msg_counter += 1
            msg_id = self._msg_counter
            key = self._key_prefix + msg_id.to_bytes(8, "little")
            frame = {"type": "request", "msg_id": msg_id, "op": op,
                     "payload": payload, "rpc_key": key}
            if _tracing().tracing_enabled():
                tc = _obs().get_context()
                if tc is not None:
                    frame["tc"] = tc
            rec = _Rpc(Future(), op, frame, key, deadline, mode)
            self._pending[msg_id] = rec
        self._ensure_keeper()
        return rec

    def _deregister(self, rec: _Rpc) -> None:
        with self._futures_lock:
            self._pending.pop(rec.frame["msg_id"], None)

    def request(self, op: str, payload: dict, timeout: Optional[float] = None):
        import time as _time

        from ray_tpu_torch._private import retry as retry_mod

        default_total, attempt_iv = retry_mod.rpc_defaults()
        deadline = retry_mod.Deadline(
            timeout if timeout is not None else default_total)
        rec = self._register(op, payload, deadline, "call")
        fut = rec.fut
        attempt_wait = attempt_iv
        try:
            while True:
                # Held only during a reconnect handshake; set otherwise.
                self._resume_evt.wait(timeout=deadline.bound(attempt_iv))
                try:
                    self.send(rec.frame)
                except (OSError, EOFError, BrokenPipeError):
                    pass  # conn breaking/being replaced: paced retry below
                rec.attempts += 1
                rec.last_send = _time.monotonic()
                try:
                    return fut.result(
                        timeout=max(0.001, deadline.bound(attempt_wait)))
                except FuturesTimeoutError:
                    _reraise_reply_error(fut)
                if self._closed:
                    raise exc.RayTpuError("connection closed")
                if deadline.expired():
                    retry_mod.note("timeouts")
                    raise exc.RpcTimeoutError(
                        op=op, elapsed=deadline.elapsed(),
                        timeout=deadline.timeout, attempts=rec.attempts)
                retry_mod.note("retries")
                attempt_wait = min(attempt_wait * 1.5, max(attempt_iv, 60.0))
        finally:
            self._deregister(rec)

    def _request_async(self, op: str, payload: dict) -> None:
        """Acked one-way op: one keyed request frame, no blocked thread.
        The keeper thread resends it until the reply lands (or a bounded
        deadline passes); the key makes resends exactly-once."""
        from ray_tpu_torch._private import retry as retry_mod

        default_total, _ = retry_mod.rpc_defaults()
        deadline = retry_mod.Deadline(
            default_total if default_total is not None else 60.0)
        try:
            rec = self._register(op, payload, deadline, "async")
        except exc.RayTpuError:
            return  # closed: matches one-way best-effort semantics
        try:
            self.send(rec.frame)
            rec.attempts += 1
        except (OSError, EOFError, BrokenPipeError):
            pass  # keeper resends

    def on_reply(self, msg: dict):
        with self._futures_lock:
            rec = self._pending.pop(msg["msg_id"], None)
        if rec is None:
            return
        fut = rec.fut
        if fut.done():
            return
        if msg["ok"]:
            fut.set_result(msg["value"])
        else:
            fut.set_exception(msg["error"])

    def notify(self, msg: dict):
        if _tracing().tracing_enabled() and "tc" not in msg:
            tc = _obs().get_context()
            if tc is not None:
                msg["tc"] = tc
        if self._acked_ops():
            self._request_async("notify_msg", {"msg": msg})
        else:
            self.send(msg)

    def request_oneway(self, op: str, payload: dict):
        """Fire-and-forget request: one send, no reply frame, no round
        trip.  Used for acked-only ops on the submission hot path.  In
        acked mode (chaos / rpc_acked_ops) the frame is keyed and
        keeper-retried instead, so a dropped submit cannot strand its
        caller."""
        if self._acked_ops():
            self._request_async(op, payload)
        else:
            frame = {"type": "notify", "op": op, "payload": payload}
            if _tracing().tracing_enabled():
                tc = _obs().get_context()
                if tc is not None:
                    frame["tc"] = tc
            self.send(frame)

    def send(self, msg: dict):
        with self._send_lock:
            self.conn.send(msg)

    # ---- keeper: async resends + hung-call watchdog ----
    def _ensure_keeper(self):
        if self._keeper is not None:
            return
        with self._futures_lock:
            if self._keeper is not None or self._closed:
                return
            t = threading.Thread(target=self._keeper_loop,
                                 name="rtpu-rpc-keeper", daemon=True)
            self._keeper = t
        t.start()

    def _keeper_loop(self):
        import time as _time

        from ray_tpu_torch._private import retry as retry_mod
        from ray_tpu_torch._private.config import CONFIG

        while not self._closed:
            _, attempt_iv = retry_mod.rpc_defaults()
            interval = min(CONFIG.rpc_watchdog_interval_s,
                           max(attempt_iv / 3.0, 0.02))
            _time.sleep(max(0.02, interval))
            hang_s = CONFIG.rpc_hang_dump_s
            now = _time.monotonic()
            with self._futures_lock:
                recs = list(self._pending.items())
            for msg_id, rec in recs:
                if rec.mode == "async":
                    if rec.deadline.expired():
                        with self._futures_lock:
                            self._pending.pop(msg_id, None)
                        retry_mod.note("async_dropped")
                        continue
                    if (now - rec.last_send >= attempt_iv
                            and self._resume_evt.is_set()):
                        try:
                            self.send(rec.frame)
                        except Exception:
                            continue
                        rec.attempts += 1
                        rec.last_send = _time.monotonic()
                        retry_mod.note("async_retries")
                if hang_s and not rec.dumped and now - rec.started > hang_s:
                    rec.dumped = True
                    retry_mod.dump_blocked_rpc(
                        rec, reason=f"in flight > {hang_s:.0f}s")

    # ---- failover ----
    def replace_conn(self, conn, hold_resend: bool = False):
        """Head failover: swap in a fresh control connection.  Unacked
        requests STAY registered — their idempotency keys make a resend
        exactly-once, so in-flight calls ride the new conn (resent by
        their blocked caller / the keeper) instead of erroring.  With
        ``hold_resend`` resends are gated until :meth:`release_resend`,
        so the re-registration handshake goes first on the new conn.
        Swap is atomic under both locks (request() never nests them)."""
        from ray_tpu_torch._private.chaos import wrap_net_faults

        conn = wrap_net_faults(conn)
        with self._send_lock:
            with self._futures_lock:
                if hold_resend:
                    self._resume_evt.clear()
                old, self.conn = self.conn, conn
        try:
            old.close()
        except Exception:
            pass

    def release_resend(self):
        """Reconnect handshake done: resume (and immediately perform) the
        resend of every still-pending request on the new conn."""
        import time as _time

        self._resume_evt.set()
        with self._futures_lock:
            recs = list(self._pending.values())
        for rec in recs:
            try:
                self.send(rec.frame)
                rec.attempts += 1
                rec.last_send = _time.monotonic()
            except Exception:
                break

    def close(self):
        with self._futures_lock:
            self._closed = True
            pending, self._pending = dict(self._pending), {}
        try:
            self.conn.close()
        except Exception:
            pass
        err = exc.RayTpuError("connection closed")
        for rec in pending.values():
            if not rec.fut.done():
                rec.fut.set_exception(err)
        # Release any caller gated on a reconnect handshake so it can
        # observe _closed instead of sleeping out its deadline.
        self._resume_evt.set()


class _EnvOverlay:
    """Refcounted runtime-env env-var overlay for pooled workers.

    Concurrent execute_task threads (async/threaded actors) mutate the
    process-global os.environ; a naive per-task save/restore can permanently
    install another task's injected value.  Instead the *pristine* value of
    each key is recorded once (while any override is active) and restored
    when the last overriding task finishes."""

    def __init__(self):
        self._lock = threading.Lock()
        self._orig: Dict[str, Optional[str]] = {}
        self._counts: Dict[str, int] = {}

    def apply(self, env_vars: Dict[str, Any]):
        import os

        with self._lock:
            for k, v in env_vars.items():
                k = str(k)
                if self._counts.get(k, 0) == 0:
                    self._orig[k] = os.environ.get(k)
                self._counts[k] = self._counts.get(k, 0) + 1
                os.environ[k] = str(v)

    def restore(self, env_vars: Dict[str, Any]):
        import os

        with self._lock:
            for k in env_vars:
                k = str(k)
                n = self._counts.get(k, 0)
                if n <= 1:
                    self._counts.pop(k, None)
                    old = self._orig.pop(k, None)
                    if old is None:
                        os.environ.pop(k, None)
                    else:
                        os.environ[k] = old
                else:
                    self._counts[k] = n - 1

    def adopt(self, env_vars: Dict[str, Any]):
        """Make the current overrides permanent (actor-creation: the worker
        is dedicated to the actor from here on)."""
        with self._lock:
            for k in env_vars:
                k = str(k)
                self._counts.pop(k, None)
                self._orig.pop(k, None)


_env_overlay = _EnvOverlay()


class _WorkingDirOverlay:
    """runtime_env working_dir (reference: the working_dir plugin,
    python/ray/_private/runtime_env/working_dir.py — there the dir is
    uploaded to GCS and extracted per node; on this single-host plane the
    path is already local, so the overlay is chdir + sys.path).  Refcounted
    like _EnvOverlay: concurrent tasks with the same working_dir share one
    activation; mismatched concurrent dirs raise (one process, one cwd)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._active: Optional[str] = None
        self._count = 0
        self._orig_cwd: Optional[str] = None

    def apply(self, working_dir: str):
        import os
        import sys

        with self._lock:
            path = os.path.abspath(working_dir)
            if not os.path.isdir(path):
                raise FileNotFoundError(
                    f"runtime_env working_dir {working_dir!r} does not "
                    "exist on this node")
            if self._count and self._active != path:
                raise RuntimeError(
                    "concurrent tasks with different working_dirs on one "
                    f"worker ({self._active} vs {path}); use separate "
                    "actors or max_concurrency=1")
            if self._count == 0:
                self._orig_cwd = os.getcwd()
                os.chdir(path)
                sys.path.insert(0, path)
                self._active = path
            self._count += 1

    def restore(self):
        import os
        import sys

        with self._lock:
            if self._count == 0:
                return
            self._count -= 1
            if self._count == 0:
                try:
                    sys.path.remove(self._active)
                except ValueError:
                    pass
                # Evict modules imported FROM the working_dir: a later task
                # (same pooled worker, different dir) must not hit a stale
                # sys.modules cache for a same-named module.
                prefix = self._active + os.sep
                for name, mod in list(sys.modules.items()):
                    mod_file = getattr(mod, "__file__", None) or ""
                    if mod_file.startswith(prefix):
                        sys.modules.pop(name, None)
                try:
                    os.chdir(self._orig_cwd)
                except OSError:
                    pass
                self._active = None

    def adopt(self):
        """Actor-creation: the working_dir stays for the actor's life —
        leave cwd/sys.path as applied, drop the refcount bookkeeping."""
        with self._lock:
            self._count = max(self._count - 1, 0)
            if self._count == 0:
                self._active = None
                self._orig_cwd = None


_workdir_overlay = _WorkingDirOverlay()

from ray_tpu_torch._private.runtime_env_pkg import PyModulesOverlay  # noqa: E402

_pymods_overlay = PyModulesOverlay()


def _arena_lease_releaser(transport, oid_bin: bytes, holder_bin: bytes):
    """Standalone finalizer (must not capture the buffer owner) that returns
    this process's reader lease on an arena object to the head."""

    def release():
        try:
            transport.notify({"type": "arena_release", "oid": oid_bin,
                              "holder": holder_bin})
        except Exception:
            pass

    return release


# Sentinel: _put_object_deferred consumed the put AND its first local ref
# (owner-resident fast path) — no notify, no ObjectRef-side add_ref.
_OWNED_WITH_REF = {"type": "_owned_with_ref"}


# ---------------------------------------------------------------------------
# CoreWorker
# ---------------------------------------------------------------------------
class _DepsUnready(BaseException):
    """Raised during DIRECT-task arg resolution when a dependency is still
    pending at its owner: the worker bounces the task back to the submitter
    (who re-routes it through the head) rather than blocking the lease
    queue — the pending producer may be queued right behind this task.
    BaseException so user-level `except Exception` can't swallow it."""

    def __init__(self, oid):
        self.oid = oid


class TaskContext(threading.local):
    def __init__(self):
        self.task_id: Optional[TaskID] = None
        self.put_counter = 0
        self.task_name = ""
        self.direct_exec = False   # executing a direct-pushed task
        self.bounce_ok = False     # NORMAL direct task: may bounce deps
        self.arg_resolve = False   # inside execute_task arg resolution


class CoreWorker:
    def __init__(self, worker_id: WorkerID, node_id: NodeID, job_id: JobID,
                 transport, mode: str):
        self.worker_id = worker_id
        self.node_id = node_id
        self.job_id = job_id
        self.transport = transport
        self.mode = mode  # "driver" | "worker" | "local"
        try:
            _obs().set_identity(f"{mode}:{worker_id.hex()[:8]}",
                                node_id.hex())
        except Exception:
            pass
        # Ownership plane (reference: in-process memory store +
        # reference_count.h).  _owned always exists; the direct submitter +
        # server are attached by enable_direct() when the process supports
        # the direct transport (see _private/direct.py).
        from ray_tpu_torch._private.direct import OwnedStore

        self._owned = OwnedStore()
        self._direct = None
        self._direct_server = None
        self.direct_addr: Optional[dict] = None
        self.host_key: str = ""
        self._borrowed: Dict[ObjectID, list] = {}  # oid -> [owner_addr, count]
        # Job-level defaults (reference: JobConfig — ray_namespace +
        # runtime_env applied to every task/actor the driver submits
        # unless per-call options override them).  Drivers get these set
        # at connect; pooled workers adopt them per executed task from
        # the task's job (see execute_task), cached per job id.
        self.namespace = "default"
        self.default_runtime_env: Optional[dict] = None
        self._job_config_cache: Dict[JobID, dict] = {}
        self.ctx = TaskContext()
        self.driver_task_id = TaskID.for_driver(job_id)
        # Out-of-task puts (driver threads): itertools.count.__next__ is
        # atomic at the C level, so no lock on the put hot path.
        import itertools

        self._put_counter = itertools.count(1)
        # Blocked-in-get depth (process-wide): while a worker blocks
        # waiting for an object it tells the head, which releases the
        # worker's cpu so dependency producers can schedule (reference:
        # NotifyDirectCallTaskBlocked, core_worker.cc).
        self._block_depth = 0
        self._block_lock = threading.Lock()
        self._local_refs: Dict[ObjectID, int] = {}
        self._refs_lock = threading.Lock()
        # In-process caches (memory store): resolved values + attached
        # segments.  Bounded LRU — long-lived pooled workers would otherwise
        # retain every object they ever resolved.
        from collections import OrderedDict

        self._value_cache: "OrderedDict[ObjectID, Any]" = OrderedDict()
        self._value_cache_cap = 256
        self._shm_registry: Dict[ObjectID, Any] = {}
        # Same-oid pull coalescing (thread level): oid -> (Event, leader
        # thread id).  Followers wait on the leader's seal instead of
        # racing the canonical segment create / duplicating wire bytes.
        self._pulls_inflight: Dict[ObjectID, tuple] = {}
        self._pulls_lock = threading.Lock()
        # Cooperative-broadcast peer server: serves ranges of objects
        # THIS process is still pulling (lazily started on first striped
        # pull with transfer_coop_broadcast on).
        self._peer_srv = None
        self._func_cache: Dict[bytes, Callable] = {}
        self._func_blobs: Dict[bytes, bytes] = {}
        self.actors: Dict[ActorID, Any] = {}
        self._closed = False
        # __del__ deferral: ObjectRef finalizers fire at arbitrary points —
        # notably inside transport.send's pickling while _send_lock is held
        # (a ref dropped by the pickler re-enters send → self-deadlock on
        # the non-reentrant lock) — so a dropped ref is queued here and a
        # drainer thread does the transport I/O.
        from collections import deque

        self._ref_gc_queue: "deque" = deque()
        self._ref_gc_wake = threading.Event()
        self._ref_gc_thread = threading.Thread(
            target=self._ref_gc_loop, name="rtpu-ref-gc", daemon=True)
        self._ref_gc_thread.start()

    # ---- reference counting ----
    def enable_direct(self, server, host_key: str):
        """Attach the direct transport: this process's listener (serving
        fetch/pin + optionally exec) and the caller-side submitter."""
        from ray_tpu_torch._private.direct import DirectSubmitter

        self._direct_server = server
        self.direct_addr = server.address
        self.host_key = host_key
        self._direct = DirectSubmitter(self)

    def add_local_ref(self, oid: ObjectID, owner_addr: Optional[dict] = None):
        if self._closed:
            return
        # Owner path: this process holds the entry — count locally, never
        # talk to the head (EXTERN entries already mirror one holder there).
        if self._owned.add_ref(oid) is not None:
            return
        # Borrower path: register the borrow with the owner (reference:
        # borrow registration, reference_count.h:520) instead of the head.
        if owner_addr is not None and self._direct is not None:
            # rec = [owner_addr, count, pinned?]; the pin itself happens
            # OUTSIDE the refs lock (it can open a connection).  Ordering
            # (pin-before-unpin at the owner) comes from the handshake:
            # the unpin is deferred to whichever thread holds/reaches the
            # pinned state last (see remove_local_ref).
            with self._refs_lock:
                rec = self._borrowed.get(oid)
                if rec is None:
                    rec = self._borrowed[oid] = [owner_addr, 1, False]
                    register = True
                else:
                    rec[1] += 1
                    register = False
            if register:
                self._direct.pin_at_owner(
                    oid, owner_addr, b"bor:" + self.worker_id.binary())
                with self._refs_lock:
                    rec[2] = True
                    dead = rec[1] <= 0
                    if dead:
                        self._borrowed.pop(oid, None)
                if dead:  # every ref dropped while we were registering
                    self._direct.unpin_at_owner(
                        oid, owner_addr, b"bor:" + self.worker_id.binary())
            return
        with self._refs_lock:
            n = self._local_refs.get(oid, 0)
            self._local_refs[oid] = n + 1
            first = n == 0
        if first:
            # Fire-and-forget: the reply is a bare ack, and a blocking
            # round trip here can deadlock — refs are unpickled on
            # transport reader threads (conn.recv), which must never wait
            # on a reply only they can deliver.  Same-connection ordering
            # keeps add_ref ahead of any later remove_ref.
            try:
                self.transport.request_oneway(
                    "add_ref", {"oid": oid, "holder": self.worker_id.binary()})
            except Exception:
                pass

    def remove_local_ref_deferred(self, oid: ObjectID,
                                  owner_addr: Optional[dict] = None):
        """ObjectRef.__del__ entry point: no I/O on the caller's thread.

        Transition-based wakeup: the event is set only when the queue
        goes empty -> non-empty (one set per drain cycle, so the drainer
        can sleep long while idle) — a set per drop would hand the GIL
        to the drainer on every ObjectRef death (measured 4x slower
        small-put throughput)."""
        if self._closed:
            return
        q = self._ref_gc_queue
        q.append((oid, owner_addr))
        if len(q) == 1 or len(q) >= 4096:
            self._ref_gc_wake.set()

    def _drain_ref_gc_queue(self):
        # Head-side removals are coalesced: a burst of K dropped refs
        # costs one remove_ref_batch message instead of K remove_refs
        # (owner/borrow removals stay per-ref — they are local or ride
        # dedicated owner channels).
        batch: List[bytes] = []
        while self._ref_gc_queue:
            try:
                oid, owner_addr = self._ref_gc_queue.popleft()
            except IndexError:
                break
            try:
                self.remove_local_ref(oid, owner_addr, head_batch=batch)
            except Exception:
                pass
            if len(batch) >= 4096:
                self._send_remove_ref_batch(batch)
                batch = []
        if batch:
            self._send_remove_ref_batch(batch)

    def _send_remove_ref_batch(self, oids: List[bytes]):
        try:
            if len(oids) == 1:
                self.transport.request_oneway(
                    "remove_ref", {"oid": ObjectID(oids[0]),
                                   "holder": self.worker_id.binary()})
            else:
                self.transport.request_oneway(
                    "remove_ref_batch",
                    {"oids": oids, "holder": self.worker_id.binary()})
        except Exception:
            pass

    def _ref_gc_loop(self):
        while not self._closed:
            self._ref_gc_wake.wait(timeout=0.5)
            self._ref_gc_wake.clear()
            # Short settle: let a burst of drops batch before draining
            # (the wake fired on the FIRST drop of the batch).
            if self._ref_gc_queue:
                import time as _time

                _time.sleep(0.002)
            self._drain_ref_gc_queue()

    def remove_local_ref(self, oid: ObjectID, owner_addr: Optional[dict] = None,
                         head_batch: Optional[List[bytes]] = None):
        """Drop one local ref.  When ``head_batch`` is given, head-side
        removals are appended to it instead of sent (the ref-gc drainer
        flushes them as one remove_ref_batch)."""
        if self._closed:
            return

        def head_remove():
            if head_batch is not None:
                head_batch.append(oid.binary())
                return
            try:
                self.transport.request_oneway(
                    "remove_ref",
                    {"oid": oid, "holder": self.worker_id.binary()})
            except Exception:
                pass

        from ray_tpu_torch._private.direct import EXTERN

        r = self._owned.remove_ref(oid)
        if r is not None:
            n, state = r
            if n <= 0:
                self._value_cache.pop(oid, None)
                self._drop_local_shm(oid)
                if state == EXTERN:
                    # Drop the mirrored holder in the head directory.
                    head_remove()
            return
        with self._refs_lock:
            rec = self._borrowed.get(oid)
            if rec is not None:
                rec[1] -= 1
                last_borrow = rec[1] <= 0 and rec[2]
                if last_borrow:
                    # Pin already registered: this thread sends the unpin.
                    # If the registering thread is still mid-pin (rec[2]
                    # False), IT will observe count<=0 and unpin.
                    self._borrowed.pop(oid, None)
            else:
                last_borrow = None
        if rec is not None:
            if last_borrow:
                self._value_cache.pop(oid, None)
                self._drop_local_shm(oid)
                if self._direct is not None:
                    self._direct.unpin_at_owner(
                        oid, rec[0], b"bor:" + self.worker_id.binary())
            return
        with self._refs_lock:
            n = self._local_refs.get(oid, 0) - 1
            if n <= 0:
                self._local_refs.pop(oid, None)
            else:
                self._local_refs[oid] = n
            last = n <= 0
        if last:
            self._value_cache.pop(oid, None)
            self._drop_local_shm(oid)
            head_remove()

    # ---- put ----
    def current_task_id(self) -> TaskID:
        return self.ctx.task_id or self.driver_task_id

    def put(self, value: Any) -> ObjectRef:
        if _tracing().tracing_enabled():
            _obs().ensure_context()
        if self.ctx.task_id is None:
            # Outside task execution the put id hangs off the SHARED
            # driver task id, but put_counter is thread-local — two driver
            # threads would both count 1, 2, ... and silently alias each
            # other's objects (e.g. a StepPipeline submitting from a
            # worker thread).  Use the process-wide atomic counter.
            put_index = next(self._put_counter)
        else:
            self.ctx.put_counter += 1
            put_index = self.ctx.put_counter
        oid = ObjectID.for_put(self.current_task_id(), put_index)
        msg = self._put_object_deferred(oid, value, with_ref=True)
        if msg is _OWNED_WITH_REF:
            r = ObjectRef(oid, skip_adding_local_ref=True)
            r._owner_registered = True
            return r
        if msg is not None:
            self.transport.notify(msg)
        return ObjectRef(oid)

    def _next_put_id(self) -> ObjectID:
        if self.ctx.task_id is None:
            put_index = next(self._put_counter)
        else:
            self.ctx.put_counter += 1
            put_index = self.ctx.put_counter
        return ObjectID.for_put(self.current_task_id(), put_index)

    def put_many(self, values: Sequence[Any]) -> List[ObjectRef]:
        """Put a burst of K objects with O(1) control-plane messages.

        Bytes move exactly as in put() (owner store / arena / pooled shm
        segments), but the per-object ``seal``/``put_inline`` notifies are
        coalesced into one ``seal_batch``/``put_inline_batch`` message, and
        the head registers this process as holder of every store-resident
        object in the same message — so a K-put burst costs at most two
        head messages instead of up to 2K.  Item order inside each batch
        is submission order (the head applies them in order under one
        lock)."""
        plan: List[Tuple[ObjectID, str]] = []
        inline_items: List[dict] = []
        seal_items: List[dict] = []
        for value in values:
            oid = self._next_put_id()
            msg = self._put_object_deferred(oid, value, with_ref=True)
            if msg is _OWNED_WITH_REF:
                plan.append((oid, "seal"))  # ref pre-taken, like seal
                continue
            if msg is None:
                plan.append((oid, "owned"))
                continue
            t = msg.pop("type")
            if t == "put_inline":
                inline_items.append(msg)
                plan.append((oid, "inline"))
            elif t == "seal":
                # Holder rides the batch: pre-register the local ref and
                # let the head's batch handler record it, instead of one
                # add_ref message per object.
                seal_items.append(msg)
                with self._refs_lock:
                    self._local_refs[oid] = self._local_refs.get(oid, 0) + 1
                plan.append((oid, "seal"))
            else:  # arena_sealed — rare; keep its dedicated handler
                msg["type"] = t
                self.transport.notify(msg)
                plan.append((oid, "inline"))
        if inline_items:
            self.transport.notify({"type": "put_inline_batch",
                                   "items": inline_items})
        if seal_items:
            self.transport.notify({"type": "seal_batch",
                                   "items": seal_items,
                                   "holder": self.worker_id.binary()})
        refs: List[ObjectRef] = []
        for oid, kind in plan:
            if kind == "seal":
                r = ObjectRef(oid, skip_adding_local_ref=True)
                r._owner_registered = True
                refs.append(r)
            else:
                refs.append(ObjectRef(oid))
        return refs

    def put_object(self, oid: ObjectID, value: Any,
                   lineage_task: Optional[TaskID] = None):
        msg = self._put_object_deferred(oid, value, lineage_task)
        if msg is not None and msg is not _OWNED_WITH_REF:
            self.transport.notify(msg)

    def _put_object_deferred(self, oid: ObjectID, value: Any,
                             lineage_task: Optional[TaskID] = None,
                             with_ref: bool = False) -> Optional[dict]:
        """Write the object's bytes; return the control-plane notify (or
        None when no head message is needed) so callers batching a burst
        of puts (put_many) can coalesce K notifies into one.  With
        ``with_ref`` an owner-resident put also takes the first local ref
        inside the same store lock (returns _OWNED_WITH_REF)."""
        s = ser.serialize(value)
        size = ser.packed_size(s)
        # Refs nested in the put value must outlive this process's own
        # refs to them: the head pins them under the put's lifetime
        # (res:<oid> holders).  The notify rides this conn BEFORE any
        # later ref-gc drop, so the pin can never lose the race.
        contained = ([c.binary() for c in s.contained_refs]
                     if s.contained_refs else None)
        if size <= INLINE_OBJECT_THRESHOLD:
            meta, data = ser.pack(s)
            if self._direct is not None:
                # Owner-resident put: zero head traffic (reference: puts
                # land in the owner's in-process store, memory_store.h:43;
                # other processes fetch from the owner).
                if with_ref:
                    self._owned.put_with_ref(oid, meta, data)
                    self._cache_value(oid, value)
                    return _OWNED_WITH_REF
                self._owned.put(oid, meta, data)
                self._cache_value(oid, value)
                return None
            self._cache_value(oid, value)
            return {"type": "put_inline", "oid": oid.binary(),
                    "meta": meta, "data": data, "contained": contained,
                    "lineage_task": lineage_task}
        store = getattr(self.transport, "store_for",
                        lambda n: None)(self.node_id)
        if store is not None:
            view = store.arena_write(oid, size)
            if view is not None:
                try:
                    meta = ser.pack_into(s, view)
                finally:
                    view.release()
                store.arena_seal(oid, meta)
                self._cache_value(oid, value)
                return {"type": "arena_sealed", "oid": oid.binary(),
                        "node_id": self.node_id.binary(), "size": size,
                        "contained": contained,
                        "lineage_task": lineage_task}
            # In-process pooled path: allocate from the node store (a
            # recycled, already-faulted pool segment in steady state —
            # no shm_open, no kernel page-zeroing), pack straight in.
            buf = store.create(oid, size, overcommit=True)
            try:
                meta = ser.pack_into(s, buf)
                store.seal(oid, meta)
            except BaseException:
                store.delete(oid)
                raise
            self._cache_value(oid, value)
            return {"type": "seal", "oid": oid.binary(),
                    "node_id": self.node_id.binary(), "size": size,
                    "meta": meta, "segment": store.segment_of(oid),
                    "contained": contained,
                    "lineage_task": lineage_task}
        meta, segment = self._write_to_store(oid, s, size)
        self._cache_value(oid, value)
        return {"type": "seal", "oid": oid.binary(),
                "node_id": self.node_id.binary(),
                "size": size, "meta": meta, "segment": segment,
                "contained": contained,
                "lineage_task": lineage_task}

    def _write_to_store(self, oid: ObjectID, s: ser.SerializedObject,
                        size: int) -> Tuple[bytes, Optional[str]]:
        """Create the shared-memory segment directly (zero round trips) and
        hand ownership to the raylet via the seal notification.  Returns
        (meta, segment): segment is None for the canonical per-object
        name, or the unique fallback name used when the canonical one is
        taken on this machine — a retried/reconstructed task re-creating
        an output whose original segment still exists (dead virtual node
        mid-teardown, co-hosted agent) must not fail or unlink a segment
        another store may still serve."""
        import os as _os

        from multiprocessing import shared_memory

        segment = None
        try:
            shm = shared_memory.SharedMemory(
                name=store_mod._segment_name(oid), create=True,
                size=max(1, size))
        except FileExistsError:
            segment = (store_mod._segment_name(oid) + "_r"
                       + _os.urandom(4).hex())
            shm = shared_memory.SharedMemory(
                name=segment, create=True, size=max(1, size))
        store_mod.untrack(shm)
        store_mod.track_for_exit(shm)
        view = shm.buf[:size]
        try:
            meta = ser.pack_into(s, view)
        finally:
            view.release()
        shm.close()
        return meta, segment

    # ---- get ----
    def get(self, refs, timeout: Optional[float] = None):
        if _tracing().tracing_enabled():
            _obs().ensure_context()
        single = isinstance(refs, ObjectRef)
        if not single and not isinstance(refs, (list, tuple)):
            raise TypeError(
                f"get() expects an ObjectRef or a list of ObjectRefs, "
                f"got {type(refs).__name__}")
        ref_list = [refs] if single else list(refs)
        for r in ref_list:
            if not isinstance(r, ObjectRef):
                raise TypeError(f"get() expects ObjectRef(s), got {type(r)}")
        resolved: dict = {}
        if len(ref_list) > 1:
            # One round trip resolves everything already available; only
            # the stragglers take the blocking per-object path.
            # Dedup: a repeated ref must not be granted two arena leases
            # when only one materialize (and lease release) will happen.
            # Owner-resident (non-EXTERN) refs never go to the head.
            from ray_tpu_torch._private.direct import EXTERN

            def _head_resident(oid: ObjectID) -> bool:
                e = self._owned.lookup(oid)
                return e is None or e.state == EXTERN

            missing = list(dict.fromkeys(
                r.id for r in ref_list if r.id not in self._value_cache
                and _head_resident(r.id)))
            if missing:
                batch = self.transport.request("resolve_batch",
                                               {"oids": missing})
                resolved = dict(batch or {})
        out = []
        value_cache = self._value_cache
        owned_lookup = self._owned.lookup
        from ray_tpu_torch._private.direct import READY

        try:
            for r in ref_list:
                oid = r.id
                msg = resolved.pop(oid.binary(), None)
                if msg is not None and oid not in value_cache:
                    out.append(self._materialize(oid, msg))
                    continue
                if msg is not None and msg.get("kind") == "arena":
                    # Batch granted a lease but the cache won: give the
                    # lease back instead of dropping it on the floor.
                    self._release_arena_lease(oid)
                # Fast path: cached value or owner-resident READY bytes
                # (the common case for direct-task results).
                v = value_cache.get(oid, value_cache)
                if v is not value_cache:
                    out.append(v)
                    continue
                e = owned_lookup(oid)
                if e is not None and e.state == READY:
                    value, _ = ser.unpack(e.meta, memoryview(e.data))
                    self._cache_value(oid, value)
                    out.append(value)
                    continue
                out.append(self._get_one(oid, timeout,
                                         getattr(r, "owner_addr", None)))
        finally:
            # If an earlier ref's materialization raised, release the
            # leases of every unconsumed arena resolution — otherwise the
            # slots stay pinned until the driver disconnects.
            for oid_bin, msg in resolved.items():
                if msg.get("kind") == "arena":
                    try:
                        self._release_arena_lease(ObjectID(oid_bin))
                    except Exception:
                        pass
        return out[0] if single else out

    def get_many(self, refs: Sequence[ObjectRef],
                 timeout: Optional[float] = None) -> List[Any]:
        """Batch get: one resolve_batch round trip covers every object
        already available; stragglers fall back to the blocking path.
        Each wire pull picks its holder least-loaded-first (in-flight
        stream counts + observed per-peer bandwidth, see
        TransferClient.rank_sources) so a gather burst spreads across
        replicas instead of draining the first-listed holder.
        Semantically identical to get(list) — the name documents intent
        at call sites that gather bursts (SampleBatch gathers, dataset
        block fetches)."""
        return self.get(list(refs), timeout)

    def _prime_resolutions(self, oids: List[ObjectID]) -> None:
        """One resolve_batch request materializes every already-available
        head-resident object into the value cache, so a task with K ref
        args costs one head round trip instead of K (stragglers keep the
        per-object blocking path)."""
        from ray_tpu_torch._private.direct import EXTERN

        def _head_resident(oid: ObjectID) -> bool:
            e = self._owned.lookup(oid)
            return e is None or e.state == EXTERN

        missing = list(dict.fromkeys(
            o for o in oids if o not in self._value_cache
            and _head_resident(o)))
        if len(missing) < 2:
            return
        try:
            batch = self.transport.request("resolve_batch",
                                           {"oids": missing})
        except Exception:
            return
        for oid_bin, msg in (batch or {}).items():
            oid = ObjectID(oid_bin)
            if oid in self._value_cache:
                if msg.get("kind") == "arena":
                    self._release_arena_lease(oid)
                continue
            try:
                self._materialize(oid, msg)
            except Exception:
                pass  # the per-arg path re-raises with proper context
                # (arena failure paths inside _materialize already
                # released their lease)

    def _cache_value(self, oid: ObjectID, value):
        self._value_cache[oid] = value
        self._value_cache.move_to_end(oid)
        while len(self._value_cache) > self._value_cache_cap:
            old, _ = self._value_cache.popitem(last=False)
            self._drop_local_shm(old)

    def _drop_local_shm(self, oid: ObjectID) -> None:
        """Deterministically free this process's mapping for ``oid``:
        drop any cooperative-transfer partial record still holding the
        buffer, then defuse the segment handle through the weak-registry
        path (object_store.defuse_shm) so a consumer-held numpy/arrow
        view never surfaces a BufferError from SharedMemory.__del__."""
        h = self._shm_registry.pop(oid, None)
        if self._peer_srv is not None:
            try:
                if self._peer_srv.drop_partial(oid):
                    # Retract the directory advertisement so pullers stop
                    # being pointed at a source that no longer serves.
                    self.transport.notify({
                        "type": "object_partial_drop",
                        "oid": oid.binary(),
                        "key": self.worker_id.binary()})
            except Exception:
                pass
        if h is None:
            return
        from multiprocessing import shared_memory

        if isinstance(h, shared_memory.SharedMemory):
            store_mod.defuse_shm(h)
        else:
            try:
                h.close()  # mmap over a spill file
            except (BufferError, ValueError, OSError):
                pass

    @contextlib.contextmanager
    def _blocked_in_get(self):
        """Tell the head this worker is blocked waiting for an object so
        its cpu can serve dependency producers meanwhile (reference:
        NotifyDirectCallTaskBlocked/Unblocked; raylet releases and later
        re-acquires the cpu, local_task_manager.cc).  No-op off-worker."""
        if self.mode != "worker":
            yield
            return
        with self._block_lock:
            self._block_depth += 1
            notify = self._block_depth == 1
        if notify:
            try:
                self.transport.notify({"type": "worker_blocked",
                                       "worker_id": self.worker_id.binary()})
            except Exception:
                pass
        try:
            yield
        finally:
            with self._block_lock:
                self._block_depth -= 1
                notify = self._block_depth == 0
            if notify:
                try:
                    self.transport.notify({
                        "type": "worker_unblocked",
                        "worker_id": self.worker_id.binary()})
                except Exception:
                    pass

    def _get_one(self, oid: ObjectID, timeout: Optional[float],
                 owner_addr: Optional[dict] = None):
        if oid in self._value_cache:
            self._value_cache.move_to_end(oid)
            return self._value_cache[oid]
        from ray_tpu_torch._private.direct import ERROR, EXTERN, PENDING, READY

        entry = self._owned.lookup(oid)
        if entry is not None:
            if entry.state == PENDING:
                with self._blocked_in_get():
                    if not self._owned.wait_fulfilled(entry, timeout):
                        raise exc.GetTimeoutError(f"get({oid}) timed out")
            state, meta, data = entry.state, entry.meta, entry.data
            if state == READY:
                value, _ = ser.unpack(meta, memoryview(data))
                self._cache_value(oid, value)
                return value
            if state == ERROR:
                err, _ = ser.unpack(meta, memoryview(data))
                if isinstance(err, BaseException):
                    raise err
                raise exc.RayTpuError(str(err))
            # EXTERN: bytes live in the shared store / head — fall through.
        elif owner_addr is not None and self._direct is not None:
            nowait = self.ctx.bounce_ok and self.ctx.arg_resolve
            if nowait:
                msg = self._direct.fetch_from_owner(oid, owner_addr, timeout,
                                                    nowait=True)
            else:
                with self._blocked_in_get():
                    msg = self._direct.fetch_from_owner(oid, owner_addr,
                                                        timeout)
            if msg is not None:
                k = msg["k"]
                if k == "pending":
                    raise _DepsUnready(oid)
                if k == "bytes":
                    value, _ = ser.unpack(msg["m"], memoryview(msg["d"]))
                    self._cache_value(oid, value)
                    return value
                if k == "error":
                    err, _ = ser.unpack(msg["m"], memoryview(msg["d"]))
                    if isinstance(err, BaseException):
                        raise err
                    raise exc.RayTpuError(str(err))
                if k == "missing":
                    # The owner no longer holds it and never externalized
                    # it: unless the head knows the object, it is gone.
                    if not self.transport.request("object_info",
                                                  {"oid": oid}):
                        raise exc.ObjectLostError(
                            f"object {oid} was freed by its owner")
                # k == "extern" (or missing-but-head-knows): head path.
            else:
                # Owner unreachable (process died): the head may still hold
                # an externalized copy; otherwise the object died with its
                # owner (reference: owner failure => ObjectLostError).
                if not self.transport.request("object_info", {"oid": oid}):
                    raise exc.ObjectLostError(
                        f"object {oid} lost: its owner is gone")
        with self._blocked_in_get():
            msg = self.transport.request("get_locations",
                                         {"oid": oid, "timeout": timeout})
        return self._materialize(oid, msg)

    def _materialize(self, oid: ObjectID, msg: dict,
                     pull_failovers: int = 2):
        kind = msg["kind"]
        if kind == "inline":
            value, _ = ser.unpack(msg["meta"], memoryview(msg["data"]))
            self._cache_value(oid, value)
            return value
        if kind == "store":
            try:
                shm = store_mod.attach(oid, msg.get("segment"))
            except FileNotFoundError:
                raise exc.ObjectLostError(f"object {oid} vanished from the store")
            value, _ = ser.unpack(msg["meta"], shm.buf)
            self._cache_value(oid, value)
            self._shm_registry[oid] = shm  # keep mapping alive for zero-copy views
            return value
        if kind == "arena":
            import weakref

            import numpy as np

            from ray_tpu_torch._native import ArenaReader

            # The head granted this process a reader lease on the arena slot
            # when it handed out this resolution; the slot will not be
            # recycled until we release it (plasma in-use-count semantics).
            try:
                view = ArenaReader.view(msg["store"], msg["offset"],
                                        msg["size"], msg["capacity"])
            except FileNotFoundError:
                self._release_arena_lease(oid)
                raise exc.ObjectLostError(f"arena object {oid} vanished")
            try:
                # Wrap the raw view in a weakref-able carrier: every
                # zero-copy array deserialized out of this object keeps a
                # buffer chain back to `owner`, so its finalizer fires
                # exactly when the last view is garbage-collected.
                owner = np.frombuffer(view, dtype=np.uint8)
                value, _ = ser.unpack(msg["meta"], memoryview(owner))
            except BaseException:
                self._release_arena_lease(oid)
                raise
            if ser.num_oob_buffers(msg["meta"]):
                weakref.finalize(
                    owner, _arena_lease_releaser(
                        self.transport, oid.binary(),
                        self.worker_id.binary()))
            else:
                # Nothing in `value` views the arena (in-band pickle only).
                self._release_arena_lease(oid)
            self._cache_value(oid, value)
            return value
        if kind == "spilled":
            # Same-host spill file: zero-copy mmap read (reference:
            # restore-on-get, spilled_object_reader.h).
            import mmap

            try:
                with open(msg["path"], "rb") as f:
                    if msg["size"] > 0:
                        buf = mmap.mmap(f.fileno(), 0,
                                        access=mmap.ACCESS_READ)
                    else:
                        buf = f.read()
            except (FileNotFoundError, ValueError):
                raise exc.ObjectLostError(
                    f"spilled object {oid} vanished from disk")
            value, _ = ser.unpack(msg["meta"], memoryview(buf))
            self._cache_value(oid, value)
            self._shm_registry[oid] = buf  # keep the mapping alive
            return value
        if kind == "pull":
            return self._pull_and_materialize(oid, msg,
                                              _failovers=pull_failovers)
        if kind == "error":
            err, _ = ser.unpack(msg["meta"], memoryview(msg["data"]))
            if isinstance(err, BaseException):
                raise err
            raise exc.RayTpuError(str(err))
        raise exc.RayTpuError(f"bad resolution kind {kind}")

    def _transfer_client(self):
        if getattr(self, "_xfer_client", None) is None:
            from ray_tpu_torch._private.transfer import TransferClient

            self._xfer_client = TransferClient(self.transport.authkey)
        return self._xfer_client

    def _pull_and_materialize(self, oid: ObjectID, msg: dict,
                              _failovers: int = 2):
        """Cross-host read with location failover: try every holder the
        directory named; when ALL of them fail (the serving node died
        mid-pull), re-resolve through the head — which by then has run
        its node-death protocol and points at a replica, a spill restore,
        or a reconstruction — instead of erroring on the first sever.
        Reference: pull_manager.h:52 retrying against updated locations.

        Concurrent same-oid pulls in THIS process coalesce: one leader
        thread lands the bytes (one segment, one wire stream), followers
        wait on its seal and read the cached value."""
        if not msg.get("_rechecked"):
            # Prefetch race: the scheduler may have landed these bytes in
            # THIS host's store after the resolution was handed out — one
            # control round trip can turn a wire pull into a segment
            # attach (and refreshes stale holder addresses either way).
            try:
                fresh = self.transport.request(
                    "get_locations", {"oid": oid, "recheck": True})
            except Exception:
                fresh = None
            if fresh and fresh.get("kind") != "pull":
                return self._materialize(oid, fresh,
                                         pull_failovers=_failovers)
            if fresh:
                fresh["_rechecked"] = True
                msg = fresh
        from ray_tpu_torch._private import transfer as transfer_mod

        cur = threading.get_ident()
        while True:
            with self._pulls_lock:
                rec = self._pulls_inflight.get(oid)
                if rec is None:
                    ev = threading.Event()
                    self._pulls_inflight[oid] = (ev, cur)
                    break
                if rec[1] == cur:
                    # The leader's own failover hop (re-resolve path
                    # recursing through _materialize): stay leader.
                    return self._pull_resolved(oid, msg, _failovers)
                ev = rec[0]
            transfer_mod._stat_add("coalesced_pulls")
            from ray_tpu_torch._private.config import CONFIG

            ev.wait(float(CONFIG.transfer_timeout_s) + 30.0)
            if oid in self._value_cache:
                self._value_cache.move_to_end(oid)
                return self._value_cache[oid]
            # Leader failed (its caller got the error) or we timed out:
            # loop to take leadership and pull ourselves.
        try:
            return self._pull_resolved(oid, msg, _failovers)
        finally:
            with self._pulls_lock:
                self._pulls_inflight.pop(oid, None)
            ev.set()

    def _pull_resolved(self, oid: ObjectID, msg: dict, _failovers: int):
        ok, value = self._try_striped_pull(oid, msg)
        if ok:
            return value
        last_err: Optional[BaseException] = None
        addr_list = list(msg.get("addrs") or [msg["addr"]])
        if len(addr_list) > 1:
            # Least-loaded holder first (per-peer stream counts + EWMA
            # bandwidth): batched get_many gathers spread across
            # replicas instead of all draining the first-listed one.
            addr_list = self._transfer_client().rank_sources(addr_list)
        for addr in addr_list:
            try:
                return self._pull_once(oid, tuple(addr), msg["size"],
                                       local_partial=bool(
                                           msg.get("local_partial")))
            except (KeyError, EOFError, OSError, BrokenPipeError) as e:
                last_err = e  # dead/stale holder: try the next one
        if _failovers <= 0:
            raise exc.ObjectLostError(
                f"object {oid} could not be pulled from any holder: "
                f"{last_err}")
        # Every named holder failed.  Give the head a beat to notice the
        # death, then re-resolve (blocking like get): the reply is the
        # recovered resolution or the object's typed loss error.
        import time as _time

        _time.sleep(0.2)
        fresh = self.transport.request("get_locations", {"oid": oid})
        return self._materialize(oid, fresh, pull_failovers=_failovers - 1)

    def _peer_server(self):
        """This process's cooperative transfer server: store-less, serves
        only the ranges of objects we are mid-pull on (or just sealed)."""
        if self._peer_srv is None:
            from ray_tpu_torch._private.transfer import ObjectTransferServer

            self._peer_srv = ObjectTransferServer(
                None, self.transport.authkey)
        return self._peer_srv

    def _try_striped_pull(self, oid: ObjectID, msg: dict):
        """Multi-source chunk-range pull into the canonical destination
        segment, re-serving landed ranges to concurrent pullers
        (cooperative broadcast).  Returns (True, value) when this path
        landed the object; (False, None) when it does not apply or
        failed — the caller's single-stream holder loop + head
        re-resolution remains the correctness path."""
        from ray_tpu_torch._private import transfer as transfer_mod
        from ray_tpu_torch._private.config import CONFIG

        size = int(msg.get("size") or 0)
        if size < int(CONFIG.transfer_stripe_min_bytes):
            return False, None
        coop = bool(CONFIG.transfer_coop_broadcast)
        addrs = [tuple(a) for a in (msg.get("addrs") or [msg["addr"]])]
        if not (coop or len(addrs) > 1 or msg.get("sources")):
            return False, None
        shm = membuf = None
        try:
            from multiprocessing import shared_memory

            shm = shared_memory.SharedMemory(
                name=store_mod._segment_name(oid), create=True, size=size)
            store_mod.untrack(shm)
            store_mod.track_for_exit(shm)
        except FileExistsError:
            if msg.get("local_partial") and coop:
                # A same-host striped pull owns the canonical segment:
                # wait for its seal instead of pulling the bytes twice
                # (_pull_once's local_partial path).
                return False, None
            # The name is taken by a puller we cannot wait on (another
            # host's worker on a shared-/dev/shm test box, or a stale
            # leak): stripe into an anonymous buffer — multi-source
            # scheduling and partial serving still apply, only the
            # zero-copy local seal is lost.
            membuf = bytearray(size)
        except Exception:
            return False, None  # shm unavailable: plain path falls back
        chunkb = int(msg.get("chunk") or CONFIG.transfer_chunk_bytes) \
            or transfer_mod.CHUNK
        nchunks = max(1, (size + chunkb - 1) // chunkb)
        src_list = [(tuple(a), set(c) if c is not None else None)
                    for a, c in (msg.get("sources") or [])] \
            or [(a, None) for a in addrs]
        peer = own_addr = None
        if coop:
            try:
                peer = self._peer_server()
                own_addr = tuple(peer.address)
                src_list = [s for s in src_list if s[0] != own_addr]
            except Exception:
                peer = None
        key = self.worker_id.binary()

        def progress(off, ln):
            # A landed range becomes servable + advertised: concurrent
            # pullers of this object stripe off us from here on.
            if peer is None:
                return
            fresh = peer.mark_range(oid, off, ln)
            if fresh:
                try:
                    self.transport.notify({
                        "type": "object_partial", "oid": oid.binary(),
                        "key": key, "addr": list(own_addr),
                        "chunk": chunkb, "total": nchunks,
                        "chunks": fresh, "size": size})
                except Exception:
                    pass

        def refresh():
            # Mid-pull source discovery: the directory may have gained
            # partial holders (other receivers of the same broadcast)
            # since our resolution was handed out.
            try:
                fresh = self.transport.request(
                    "get_locations", {"oid": oid, "recheck": True})
            except Exception:
                return None
            if not fresh or fresh.get("kind") != "pull":
                return None
            out = []
            for a, c in (fresh.get("sources")
                         or [[a, None] for a in (fresh.get("addrs")
                                                 or [])]):
                t = tuple(a)
                if own_addr is None or t != own_addr:
                    out.append((t, set(c) if c is not None else None))
            return out

        import time as _time

        tc = None
        try:
            from ray_tpu_torch.util.tracing import tracing_enabled

            if tracing_enabled():
                tc = _obs().get_context()
        except Exception:
            pass
        if peer is not None:
            peer.register_partial(
                oid, shm.buf if shm is not None else membuf, size, chunkb)
        view = shm.buf[:size] if shm is not None else memoryview(membuf)
        t0 = _time.time()
        pulled = False
        try:
            meta, stats = transfer_mod.pull_striped(
                self._transfer_client(), oid, size, src_list, view,
                meta_hint=msg.get("meta"), chunk=chunkb, tc=tc,
                refresh=refresh if coop else None, progress=progress)
            if meta is None:
                raise OSError(f"striped pull of {oid}: no source knew "
                              "the serialization meta")
            pulled = True
            if peer is not None:
                # On success the partial advertisement stays: for a
                # sealed segment it is redundant with the full-holder
                # entry but keeps serving already-connected pullers; for
                # the anonymous-buffer mode it IS this process's serve
                # surface (dropped when the object is freed).
                peer.complete_partial(oid, meta)
            if shm is not None:
                self.transport.notify({
                    "type": "seal", "oid": oid.binary(),
                    "node_id": self.node_id.binary(), "size": size,
                    "meta": meta})
            if tc is not None:
                # Puller-side stripe span for the PR 19 timeline: how
                # many sources fed this pull and how many bytes striped.
                try:
                    _obs().record(
                        "transfer.pull", t0, _time.time(), ctx=tc,
                        oid=oid.hex(), striped_bytes=size,
                        sources=len(stats["bytes_from"]),
                        partial_ranges=stats["partial_ranges"])
                except Exception:
                    pass
            value, _ = ser.unpack(
                meta, shm.buf[:size] if shm is not None
                else memoryview(membuf))
            self._cache_value(oid, value)
            if shm is not None:
                self._shm_registry[oid] = shm
            return True, value
        except BaseException:  # noqa: BLE001 — clean up, then decide
            if peer is not None:
                peer.drop_partial(oid)
                try:
                    self.transport.notify({
                        "type": "object_partial_drop",
                        "oid": oid.binary(), "key": key})
                except Exception:
                    pass
            if shm is not None:
                try:
                    store_mod.retrack(shm)  # unlink() re-unregisters
                    shm.unlink()
                    shm.close()
                except Exception:
                    pass
            if pulled:
                raise  # bytes landed but seal/unpack failed: a real error
            return False, None  # wire failure: single-stream failover
        finally:
            try:
                view.release()
            except BufferError:
                pass  # a serve thread still drains a range slice

    def _pull_once(self, oid: ObjectID, addr: tuple, size: int,
                   local_partial: bool = False):
        """One pull attempt against one holder: stream the object into
        THIS node's store, seal the local replica (so the directory
        learns the new location and neighbors read locally), then
        materialize zero-copy from the local segment.  Reference:
        pull_manager.h:52 + chunked push push_manager.h:29."""
        client = self._transfer_client()
        shm = None
        try:
            from multiprocessing import shared_memory

            shm = shared_memory.SharedMemory(
                name=store_mod._segment_name(oid), create=True,
                size=max(1, size))
            store_mod.untrack(shm)
            store_mod.track_for_exit(shm)
        except FileExistsError:
            # Another local reader is already landing this object.  When
            # the directory said a SAME-HOST striped pull is in progress
            # ("local_partial"), briefly wait for its seal: attaching the
            # one canonical segment beats a redundant in-memory wire pull
            # of the same bytes.  Otherwise keep the old immediate
            # in-memory fallback (the creator may be another process we
            # know nothing about — or long dead, leaking the name).
            shm = None
            if local_partial:
                from ray_tpu_torch._private.config import CONFIG

                if CONFIG.transfer_coop_broadcast:
                    got = self._await_local_seal(oid)
                    if got is not None:
                        return got
        except Exception:
            shm = None
        try:
            if shm is not None:
                view = shm.buf[:size]
                try:
                    meta, _ = client.pull(addr, oid, sink=view)
                finally:
                    view.release()
                self.transport.notify({
                    "type": "seal", "oid": oid.binary(),
                    "node_id": self.node_id.binary(), "size": size,
                    "meta": meta})
                value, _ = ser.unpack(meta, shm.buf[:size])
                self._cache_value(oid, value)
                self._shm_registry[oid] = shm
                return value
            meta, data = client.pull(addr, oid)
            value, _ = ser.unpack(meta, memoryview(data))
            self._cache_value(oid, value)
            return value
        except BaseException:
            # ANY failure before the seal (missing object, transport death
            # mid-stream, unpack error) must unlink the pre-created segment:
            # nothing owns it yet, and a leaked name permanently poisons the
            # zero-copy pull path for this object on this host.
            if shm is not None:
                try:
                    store_mod.retrack(shm)  # unlink() re-unregisters
                    shm.unlink()
                    shm.close()
                except Exception:
                    pass
            # KeyError ("not in this store") propagates as-is: the caller
            # fails over to the next holder / a fresh head resolution.
            raise

    def _await_local_seal(self, oid: ObjectID):
        """Bounded wait for a same-host in-progress pull to seal, then
        materialize from its resolution (usually a local segment attach).
        Returns None when the leader vanishes or the wait times out —
        the caller falls back to its own in-memory pull."""
        import time as _time

        from ray_tpu_torch._private.config import CONFIG

        deadline = _time.time() + min(15.0, float(CONFIG.transfer_timeout_s))
        while _time.time() < deadline:
            _time.sleep(0.05)
            try:
                fresh = self.transport.request(
                    "get_locations", {"oid": oid, "recheck": True})
            except Exception:
                return None
            if not fresh:
                return None
            if fresh.get("kind") not in ("pull", None):
                return self._materialize(oid, fresh)
            if fresh.get("kind") == "pull" \
                    and not fresh.get("local_partial"):
                return None  # leader failed/vanished: pull it ourselves
        return None

    def _release_arena_lease(self, oid: ObjectID):
        try:
            self.transport.notify({"type": "arena_release",
                                   "oid": oid.binary(),
                                   "holder": self.worker_id.binary()})
        except Exception:
            pass

    def get_async(self, ref: ObjectRef) -> Future:
        fut: Future = Future()
        owner = getattr(ref, "owner_addr", None)

        def run():
            try:
                fut.set_result(self._get_one(ref.id, None, owner))
            except BaseException as e:  # noqa: BLE001
                fut.set_exception(e)

        threading.Thread(target=run, daemon=True).start()
        return fut

    # ---- wait ----
    def wait(self, refs: Sequence[ObjectRef], num_returns: int = 1,
             timeout: Optional[float] = None,
             fetch_local: bool = True) -> Tuple[List[ObjectRef], List[ObjectRef]]:
        if num_returns > len(refs):
            raise ValueError("num_returns > len(refs)")
        from ray_tpu_torch._private.direct import ERROR, EXTERN, READY

        def _is_owner_local(r) -> bool:
            e = self._owned.lookup(r.id)
            if e is not None and e.state != EXTERN:
                return True
            # Borrowed refs resolve at their owner, which the head never
            # hears about — they must poll the owner, not the head.
            return e is None and getattr(r, "owner_addr", None) is not None

        if any(_is_owner_local(r) for r in refs):
            # Mixed owner-resident + head refs: short-poll both planes
            # (owner-side readiness is a local check; the head side is one
            # immediate-reply request per poll).
            import time as _time

            deadline = (None if timeout is None
                        else _time.monotonic() + timeout)
            # Poll interval backs off exponentially: a long wait on slow
            # tasks must not spin the head (one wait_ready RPC per round)
            # or the owner connections at ~300 rounds/s forever.
            interval = 0.002
            with self._blocked_in_get():
                while True:
                    ready_bin = set()
                    head_side = []
                    for r in refs:
                        e = self._owned.lookup(r.id)
                        owner = getattr(r, "owner_addr", None)
                        if e is not None and e.state in (READY, ERROR):
                            ready_bin.add(r.id.binary())
                        elif r.id in self._value_cache:
                            ready_bin.add(r.id.binary())
                        elif e is None and owner is not None \
                                and self._direct is not None:
                            got = self._direct.fetch_from_owner(
                                r.id, owner, None, nowait=True)
                            if got is not None and got["k"] == "bytes":
                                # Keep the fetched value: later poll
                                # rounds hit the cache, and the get() is
                                # free (no refetch of big payloads).
                                value, _ = ser.unpack(
                                    got["m"], memoryview(got["d"]))
                                self._cache_value(r.id, value)
                                ready_bin.add(r.id.binary())
                            elif got is None or got["k"] != "pending":
                                # error/extern/missing: get() will
                                # resolve (or raise) promptly => ready.
                                ready_bin.add(r.id.binary())
                        elif e is None or e.state == EXTERN:
                            head_side.append(r)
                    if head_side and len(ready_bin) < num_returns:
                        got = self.transport.request(
                            "wait_ready",
                            {"oids": [r.id for r in head_side],
                             "num_returns": len(head_side), "timeout": 0.0})
                        ready_bin.update(got)
                    if len(ready_bin) >= num_returns or (
                            deadline is not None
                            and _time.monotonic() >= deadline):
                        break
                    sleep_for = interval
                    if deadline is not None:
                        sleep_for = min(sleep_for,
                                        max(0.0, deadline - _time.monotonic()))
                    _time.sleep(sleep_for)
                    interval = min(interval * 1.5, 0.1)
            ready, not_ready = [], []
            for r in refs:
                (ready if r.id.binary() in ready_bin
                 and len(ready) < num_returns else not_ready).append(r)
            return ready, not_ready
        with self._blocked_in_get():
            ready_bins = self.transport.request(
                "wait_ready",
                {"oids": [r.id for r in refs], "num_returns": num_returns,
                 "timeout": timeout})
        ready_set = set(ready_bins)
        ready, not_ready = [], []
        for r in refs:
            (ready if r.id.binary() in ready_set and len(ready) < num_returns
             else not_ready).append(r)
        return ready, not_ready

    # ---- task submission ----
    def make_args(self, args: Sequence[Any], kwargs: Dict[str, Any],
                  holds: Optional[list] = None
                  ) -> Tuple[List[TaskArg], Dict[str, TaskArg]]:
        def conv(v) -> TaskArg:
            if isinstance(v, ObjectRef):
                return TaskArg(ArgKind.REF, ref=v.id,
                               owner=v._effective_owner())
            s = ser.serialize(v)
            if ser.packed_size(s) > INLINE_OBJECT_THRESHOLD:
                # Large literal arg: promote to a put object, pass by ref
                # (reference inlines <100KB, else plasma: dependency_resolver).
                # The ObjectRef MUST outlive submission (callers stash
                # `holds` on the result ref / actor handle): dropping it
                # here lets the ref-gc drainer free the object in the
                # window before the executing worker resolves it — the
                # drop and the submit ride different threads, so conn
                # ordering cannot save us.
                ref = self.put(v)
                if holds is not None:
                    holds.append(ref)
                return TaskArg(ArgKind.REF, ref=ref.id,
                               owner=ref._effective_owner())
            return TaskArg(ArgKind.VALUE, value=ser.pack(s),
                           contained=list(s.contained_refs),
                           contained_owners=(s.contained_owners or None))
        return [conv(a) for a in args], {k: conv(v) for k, v in kwargs.items()}

    def _promote_owned_args(self, spec: TaskSpec):
        """Classic-path submit referencing owner-resident objects: push the
        bytes to the head directory first (ordered ahead of the submit on
        the same transport) so the head's arg pinning and the executing
        worker's resolution see them.  PENDING entries promote when their
        bytes arrive (the head's get_locations defers until then)."""
        from ray_tpu_torch._private.direct import ERROR, PENDING, READY

        for arg in list(spec.args) + list(spec.kwargs.values()):
            for oid in ([arg.ref] if arg.ref is not None else []) + arg.contained:
                entry = self._owned.lookup(oid)
                if entry is None:
                    continue
                if entry.state == PENDING:
                    self._owned.set_promote_on_fulfill(oid)
                elif entry.state in (READY, ERROR):
                    self.promote_owned_to_head(oid)

    def promote_owned_to_head(self, oid: ObjectID) -> None:
        """Move an owner-resident inline object into the head directory and
        flip the local entry EXTERN (with refcount mirroring)."""
        from ray_tpu_torch._private.direct import ERROR, EXTERN, READY
        from ray_tpu_torch._private.task_spec import ERROR_META

        entry = self._owned.lookup(oid)
        if entry is None or entry.state not in (READY, ERROR):
            return
        meta = entry.meta if entry.state == READY else ERROR_META + entry.meta
        try:
            self.transport.notify({"type": "put_inline", "oid": oid.binary(),
                                   "meta": meta, "data": entry.data})
        except Exception:
            return
        had, has_refs = self._owned.make_extern(oid)
        if had and has_refs:
            try:
                self.transport.request_oneway(
                    "add_ref",
                    {"oid": oid, "holder": self.worker_id.binary()})
            except Exception:
                pass

    def _adopt_return_refs(self, spec: TaskSpec) -> List[ObjectRef]:
        """ObjectRefs for a direct submission: each adopts the submission
        ref pre-held by the owned entry (see OwnedStore.create_pending)."""
        refs = []
        for oid in spec.return_ids():
            r = ObjectRef(oid, skip_adding_local_ref=True)
            r._owner_registered = True
            refs.append(r)
        return refs

    def submit_task(self, spec: TaskSpec) -> List[ObjectRef]:
        spec.owner_worker_id = self.worker_id
        spec.parent_task_id = self.current_task_id()
        if _tracing().tracing_enabled():
            spec.trace_ctx = _obs().context_for_outbound()
        if self._direct is not None and self._direct.submit_task(spec):
            return self._adopt_return_refs(spec)
        self._promote_owned_args(spec)
        refs = [ObjectRef(oid) for oid in spec.return_ids()]
        tr = _tracing()
        with (tr.span("task.submit", task_name=spec.name)
              if tr.tracing_enabled() else contextlib.nullcontext()):
            if tr.tracing_enabled():
                # Re-parent to the submit span (recorded, driver-side) so
                # the worker's execute spans anchor a cross-process edge.
                spec.trace_ctx = _obs().context_for_outbound()
            self.transport.request_oneway("submit", {"spec": spec})
        return refs

    def submit_actor_task(self, spec: TaskSpec) -> List[ObjectRef]:
        spec.owner_worker_id = self.worker_id
        spec.parent_task_id = self.current_task_id()
        if _tracing().tracing_enabled():
            spec.trace_ctx = _obs().context_for_outbound()
        if self._direct is not None and self._direct.submit_actor_task(spec):
            return self._adopt_return_refs(spec)
        self._promote_owned_args(spec)
        refs = [ObjectRef(oid) for oid in spec.return_ids()]
        tr = _tracing()
        with (tr.span("actor_task.submit", task_name=spec.name)
              if tr.tracing_enabled() else contextlib.nullcontext()):
            if tr.tracing_enabled():
                # Re-parent to the submit span (recorded, driver-side) so
                # the actor's execute spans anchor a cross-process edge.
                spec.trace_ctx = _obs().context_for_outbound()
            self.transport.request_oneway("actor_call", {"spec": spec})
        return refs

    # ---- function resolution ----
    def register_func_blob(self, func_hash: bytes, blob: bytes) -> None:
        """Record a function blob at message-receive time so stripped
        re-sends (see DirectChannel.exec) can always resolve, even when
        concurrent actor threads execute out of order."""
        self._func_blobs.setdefault(func_hash, blob)

    def load_function(self, blob: Optional[bytes],
                      func_hash: Optional[bytes]) -> Callable:
        key = func_hash or hashlib.sha256(blob).digest()
        fn = self._func_cache.get(key)
        if fn is None:
            if blob is None:
                blob = self._func_blobs.get(key)
                if blob is None:
                    raise exc.RayTpuError(
                        "function blob missing for a stripped task spec")
            fn = cloudpickle.loads(blob)
            self._func_cache[key] = fn
        return fn

    # ---- task execution ----
    def _job_config(self, job_id: JobID) -> dict:
        """Fetch-and-cache the job's config so nested submissions and
        named-actor lookups inside workers see the job's namespace and
        runtime_env defaults (reference: JobConfig propagation)."""
        cfg = self._job_config_cache.get(job_id)
        if cfg is None:
            try:
                cfg = self.transport.request(
                    "job_config", {"job_id": job_id.binary()}) or {}
            except Exception:
                # Transient head trouble: fall back for THIS task but do
                # not cache — caching {} would silently strip the job's
                # namespace/runtime_env for the rest of the worker's life.
                return {}
            self._job_config_cache[job_id] = cfg
        return cfg

    def execute_task(self, spec: TaskSpec) -> dict:
        """Run a task and build the task_done message (does not send it)."""
        import time as _time

        self.ctx.task_id = spec.task_id
        self.ctx.task_name = spec.name
        self.ctx.put_counter = 0
        saved_trace_ctx = None
        tracing_on = _tracing().tracing_enabled()
        if tracing_on:
            obs = _obs()
            # Execute inside the submitter's trace, and flush a begin
            # marker BEFORE running: if this process is SIGKILLed
            # mid-task, the head already holds evidence of what died.
            saved_trace_ctx = obs.adopt_spec_context(spec)
            obs.record_instant("task.begin", task_name=spec.name,
                              task_id=spec.task_id.hex())
            if self.mode == "worker":
                obs.flush(self.transport)
        # Adopt the submitting job's defaults for the task's duration
        # (pooled workers serve many jobs; restored in the finally).
        saved_job_defaults = (self.namespace, self.default_runtime_env)
        job_cfg = self._job_config(spec.job_id) if self.mode == "worker" \
            else {}
        if job_cfg:
            if job_cfg.get("namespace"):
                self.namespace = job_cfg["namespace"]
            if job_cfg.get("runtime_env"):
                self.default_runtime_env = job_cfg["runtime_env"]
        start_ts = _time.time()
        error = None
        error_str = None
        results: List[TaskResult] = []
        env_vars: Dict[str, Any] = {}
        workdir_applied = False
        pymods_applied = False
        renv = spec.runtime_env
        try:
            if renv:
                # Runtime env (lite): per-task/actor env vars (reference:
                # python/ray/_private/runtime_env/ plugin architecture).
                # Pooled workers execute many tasks: overlay the keys and
                # restore the pristine values afterwards so one task's env
                # does not leak into the next (the reference instead
                # dedicates workers to a runtime env).
                env_vars = renv.get("env_vars") or {}
                if env_vars:
                    _env_overlay.apply(env_vars)
                working_dir = renv.get("working_dir")
                if working_dir:
                    _workdir_overlay.apply(working_dir)
                    workdir_applied = True
                py_modules = renv.get("py_modules")
                if py_modules:
                    from ray_tpu_torch._private.runtime_env_pkg import ensure_local

                    roots = [ensure_local(u, self.transport)
                             for u in py_modules]
                    _pymods_overlay.apply(roots)
                    pymods_applied = True
                unsupported = set(renv) - {"env_vars", "working_dir",
                                           "py_modules"}
                if unsupported:
                    raise exc.RayTpuError(
                        f"runtime_env fields {sorted(unsupported)} are not "
                        "supported (pip/conda need package egress; this "
                        "environment has none)")
            if spec.args or spec.kwargs:
                self.ctx.arg_resolve = True
                try:
                    ref_oids = [a.ref for a in
                                list(spec.args) + list(spec.kwargs.values())
                                if a.kind == ArgKind.REF]
                    if len(ref_oids) > 1:
                        # Coalesced resolution: one head round trip for
                        # every already-available ref arg instead of one
                        # get_locations per arg.
                        self._prime_resolutions(ref_oids)
                    args = [self._resolve_arg(a) for a in spec.args]
                    kwargs = {k: self._resolve_arg(a)
                              for k, a in spec.kwargs.items()}
                finally:
                    self.ctx.arg_resolve = False
            else:
                args, kwargs = [], {}
            tr = _tracing()
            span = (tr.span("task.execute", task_name=spec.name,
                            task_type=spec.task_type.name,
                            task_id=spec.task_id.hex())
                    if tr.tracing_enabled() else None)
            try:
                if span is not None:
                    span.__enter__()
                if spec.task_type == TaskType.ACTOR_TASK:
                    instance = self.actors.get(spec.actor_id)
                    if instance is None:
                        raise exc.ActorDiedError(
                            "actor instance not found on worker")
                    method = getattr(instance, spec.method_name)
                    out = method(*args, **kwargs)
                    if _is_coroutine(out):
                        out = _run_coroutine(out)
                elif spec.task_type == TaskType.NORMAL:
                    fn = self.load_function(spec.func_blob, spec.func_hash)
                    out = fn(*args, **kwargs)
                elif spec.task_type == TaskType.ACTOR_CREATION:
                    cls = self.load_function(spec.func_blob, spec.func_hash)
                    self.actors[spec.actor_id] = cls(*args, **kwargs)
                    out = None
                else:
                    raise exc.RayTpuError(f"bad task type {spec.task_type}")
            finally:
                if span is not None:
                    span.__exit__(None, None, None)
            results = self._store_returns(spec, out)
        except _DepsUnready:
            raise  # bounced to the submitter by the worker loop
        except BaseException as e:  # noqa: BLE001 — errors are task results
            error_str = traceback.format_exc()
            terr = exc.TaskError(type(e).__name__, None, error_str, spec.name)
            s = ser.serialize(terr)
            error = ser.pack(s)
        finally:
            # Actor-creation env vars stay: the worker is dedicated to the
            # actor from here on (matching the reference's dedicated-worker
            # runtime-env model).
            if env_vars:
                if spec.task_type == TaskType.ACTOR_CREATION:
                    _env_overlay.adopt(env_vars)
                else:
                    _env_overlay.restore(env_vars)
            if workdir_applied:
                # Only rebalance if apply() actually incremented the
                # count — a failed apply must not decrement a concurrent
                # holder's activation.
                if spec.task_type == TaskType.ACTOR_CREATION:
                    _workdir_overlay.adopt()
                else:
                    _workdir_overlay.restore()
            if pymods_applied:
                if spec.task_type == TaskType.ACTOR_CREATION:
                    _pymods_overlay.adopt()
                else:
                    _pymods_overlay.restore()
            # Actor creation keeps the adopted defaults: the worker is
            # dedicated to this actor's job from here on.
            if spec.task_type != TaskType.ACTOR_CREATION:
                self.namespace, self.default_runtime_env = saved_job_defaults
            self.ctx.task_id = None
            if tracing_on:
                obs = _obs()
                if self.mode == "worker":
                    obs.flush(self.transport)
                obs.set_context(saved_trace_ctx)
        return {
            "type": "task_done",
            "task_id": spec.task_id.binary(),
            "worker_id": self.worker_id.binary(),
            "spec": spec,
            "results": results,
            "error": error,
            "error_str": error_str,
            "crashed": False,
            "start": start_ts,
            "end": _time.time(),
        }

    def _resolve_arg(self, arg: TaskArg):
        if arg.kind == ArgKind.REF:
            return self._get_one(arg.ref, None, getattr(arg, "owner", None))
        meta, data = arg.value
        value, _ = ser.unpack(meta, memoryview(data))
        return value

    def _store_returns(self, spec: TaskSpec, out) -> List[TaskResult]:
        if spec.num_returns == 0:
            return []
        values = [out] if spec.num_returns == 1 else list(out)
        if len(values) != spec.num_returns:
            raise ValueError(
                f"task {spec.name} declared num_returns={spec.num_returns} "
                f"but returned {len(values)} values")
        results = []
        for i, value in enumerate(values):
            oid = ObjectID.for_task_return(spec.task_id, i)
            s = ser.serialize(value)
            size = ser.packed_size(s)
            if size <= INLINE_OBJECT_THRESHOLD:
                contained = None
                if s.contained_refs and self.ctx.direct_exec:
                    # Contained-ref handover (reference_count.h:543): for
                    # SELF-owned refs, hold a `ret:` pin locally until the
                    # caller registers its `res:` pin (_on_done) — the pin
                    # is set before the done ships, so it cannot race.
                    # Refs this worker merely BORROWS are listed without a
                    # pre-pin: a remote `ret:` pin rides a different
                    # channel than the done and could arrive after the
                    # caller's unpin (leaking), so the caller just
                    # registers its `res:` pin promptly and the borrow
                    # chain's own pins cover the (small) window.
                    token = b"ret:" + spec.task_id.binary()
                    contained = []
                    for coid in s.contained_refs:
                        if self._owned.contains(coid):
                            self._owned.pin(coid, token)
                            contained.append((coid.binary(),
                                              self.direct_addr, True))
                        else:
                            owner = s.contained_owners.get(coid.binary())
                            if owner is not None and self._direct is not None:
                                contained.append((coid.binary(), owner,
                                                  False))
                            else:
                                # Head-counted nested ref (e.g. a shm-
                                # sealed put): hold a head-side ret: ref,
                                # ordered on this conn BEFORE our own
                                # ref-gc drop can arrive; the caller
                                # swaps it for a res: ref tied to the
                                # result entry (_take_contained_pins).
                                self.transport.request_oneway(
                                    "add_ref", {"oid": coid,
                                                "holder": token})
                                contained.append((coid.binary(), None,
                                                  False))
                elif s.contained_refs:
                    # Classic-path result: nested owner-resident refs must
                    # outlive this worker's local refs — promote them into
                    # the head directory, then let the head pin every
                    # nested ref under the result entry's lifetime
                    # (res:<result oid> holders, added when it records
                    # this result — ordered before our ref-gc drop).
                    contained = []
                    for coid in s.contained_refs:
                        if self._owned.contains(coid):
                            self.promote_owned_to_head(coid)
                        contained.append((coid.binary(), None, False))
                results.append(TaskResult(oid, inline=ser.pack(s),
                                          contained=contained))
            else:
                meta, segment = self._write_to_store(oid, s, size)
                self.transport.notify({
                    "type": "seal", "oid": oid.binary(),
                    "node_id": self.node_id.binary(), "size": size,
                    "meta": meta, "segment": segment,
                    "lineage_task": spec.task_id,
                    "contained": ([c.binary() for c in s.contained_refs]
                                  if s.contained_refs else None)})
                results.append(TaskResult(oid, in_store=True, size=size, meta=meta))
        return results

    def cancel_task(self, task_id: TaskID):
        """ray.cancel: direct in-flight tasks are cancelled by their owner
        (this process); everything else goes through the head."""
        if self._direct is not None and self._direct.cancel(task_id):
            return
        self.transport.request("cancel", {"task_id": task_id})

    def shutdown(self):
        # Drain deferred ref drops BEFORE closing: a ref dropped just
        # before shutdown must still send its remove_ref/unpin (the
        # synchronous __del__ path used to guarantee this).
        self._drain_ref_gc_queue()
        self._closed = True
        if self._direct is not None:
            try:
                self._direct.shutdown()
            except Exception:
                pass
        if self._direct_server is not None:
            try:
                self._direct_server.shutdown()
            except Exception:
                pass
        self.transport.close()


def _is_coroutine(obj) -> bool:
    import inspect

    return inspect.iscoroutine(obj)


def _run_coroutine(coro):
    import asyncio

    return asyncio.run(coro)


# ---------------------------------------------------------------------------
# Global worker plumbing
# ---------------------------------------------------------------------------
global_worker: Optional[CoreWorker] = None


def set_global_worker(w: Optional[CoreWorker]):
    global global_worker
    global_worker = w


object_ref_mod._get_global_worker = lambda: global_worker
