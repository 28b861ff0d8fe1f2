"""Worker process entry point (reference: python/ray/_private/workers/
default_worker.py + CoreWorkerProcess::RunTaskExecutionLoop,
src/ray/core_worker/core_worker_process.cc:63).

Two ingress paths feed one execution queue:
  - the head connection (classic dispatch, request replies), and
  - the worker's own direct listener (leased task pushes and actor calls
    from other workers/drivers — reference: the direct task/actor
    transports, core_worker/transport/).
Completions reply on the path the task arrived on: head tasks report
task_done to the head; direct tasks answer the submitting caller, which
owns the results.

Copied from ``ray_tpu/_private/default_worker.py`` (the JAX package).
"""
from __future__ import annotations

import os
import queue
import sys
import threading
from multiprocessing.connection import Client

from ray_tpu_torch._private.ids import JobID, NodeID, WorkerID
from ray_tpu_torch._private.task_spec import ArgKind, TaskSpec, TaskType
from ray_tpu_torch._private.worker import ConnTransport, CoreWorker, set_global_worker


def _has_ref_args(spec: TaskSpec) -> bool:
    """True when any task argument is an object ref — executing it may
    block the main loop waiting on another task's (possibly buffered)
    completion."""
    return any(a.kind == ArgKind.REF
               for a in list(spec.args) + list(spec.kwargs.values()))


def main():
    import faulthandler
    import signal

    # SIGUSR1 dumps all thread stacks to stderr (lands in the worker's
    # captured log) — the debugging hook for stuck workers.
    try:
        faulthandler.register(signal.SIGUSR1)
    except Exception:
        pass
    authkey = bytes.fromhex(os.environ["RAY_TPU_TORCH_AUTHKEY"])
    node_id = NodeID.from_hex(os.environ["RAY_TPU_TORCH_NODE_ID"])
    worker_id = WorkerID.from_hex(os.environ["RAY_TPU_TORCH_WORKER_ID"])

    head_addr = os.environ.get("RAY_TPU_TORCH_HEAD_ADDR")
    if head_addr:  # worker on a remote node: TCP to the head
        host, port = head_addr.rsplit(":", 1)
        conn = Client((host, int(port)), family="AF_INET", authkey=authkey)
    else:
        socket_path = os.environ["RAY_TPU_TORCH_HEAD_SOCKET"]
        conn = Client(socket_path, family="AF_UNIX", authkey=authkey)
    transport = ConnTransport(conn, authkey)
    worker = CoreWorker(worker_id, node_id, JobID.nil(), transport, mode="worker")
    set_global_worker(worker)

    # SimpleQueue: C-implemented, ~5x cheaper per op than queue.Queue on
    # the per-task hot path.
    task_queue: "queue.SimpleQueue" = queue.SimpleQueue()
    stop = threading.Event()

    # Direct listener: leased pushes, actor calls, borrow fetch/pin
    # (reference: the core worker's gRPC server, core_worker.h:278).
    from ray_tpu_torch._private.config import CONFIG

    server = None
    if CONFIG.direct_transport:
        from ray_tpu_torch._private.direct import DirectServer

        host_key = os.environ.get("RAY_TPU_TORCH_HOST_KEY", "")
        session_dir = os.environ.get("RAY_TPU_TORCH_SESSION_DIR")
        # Remote-node workers must be reachable cross-host; local workers
        # mirror the head's bind posture (loopback unless configured).
        tcp_bind = "0.0.0.0" if head_addr else CONFIG.tcp_host
        def on_exec(spec, c):
            if spec.func_blob is not None and spec.func_hash is not None:
                worker.register_func_blob(spec.func_hash, spec.func_blob)
            task_queue.put((spec, c))

        server = DirectServer(
            worker._owned, authkey, host_key,
            session_dir=session_dir,
            on_exec=on_exec,
            tcp_bind=tcp_bind)
        worker.enable_direct(server, host_key)

    def register():
        transport.send({"type": "register", "worker_id": worker_id.binary(),
                        "node_id": node_id.binary(), "pid": os.getpid(),
                        "direct_addr": server.address if server else None})

    def reconnect() -> bool:
        """Remote workers outlive a restarting head: retry the control
        connection within the reconnect window and re-register (the
        worker's actor/task state lives HERE, so surviving the outage is
        what preserves actors across head failover)."""
        if not head_addr:
            return False  # local workers die with the head process
        import time as _time

        from ray_tpu_torch._private.config import CONFIG

        host, port = head_addr.rsplit(":", 1)
        deadline = _time.monotonic() + CONFIG.reconnect_window_s
        while _time.monotonic() < deadline:
            _time.sleep(1.0)
            try:
                newconn = Client((host, int(port)), family="AF_INET",
                                 authkey=authkey)
            except Exception:
                continue
            # Resends are held until registration completes on the new
            # conn, then every unacked in-flight request is resent (its
            # idempotency key makes the resend exactly-once at the head).
            transport.replace_conn(newconn, hold_resend=True)
            try:
                register()
            except Exception:
                continue  # head died again mid-handshake: keep retrying
            transport.release_resend()
            return True
        return False

    def reader():
        while True:
            try:
                msg = transport.conn.recv()
            except (EOFError, OSError):
                if not reconnect():
                    stop.set()
                    task_queue.put(None)
                    return
                continue
            t = msg.get("type")
            if t == "reply":
                transport.on_reply(msg)
            elif t == "execute":
                task_queue.put((msg["spec"], None))
            elif t == "shutdown":
                stop.set()
                task_queue.put(None)
                return

    threading.Thread(target=reader, name="rtpu-reader", daemon=True).start()
    register()

    # Tracing plane: direct-path tasks reply to their caller, bypassing
    # the head — a periodic flusher ships their spans on the node-stats
    # cadence so they still assemble (execute_task also flushes at task
    # start/end; this catches spans between tasks and long-running ones).
    from ray_tpu_torch.util.tracing import tracing_enabled

    if tracing_enabled():
        from ray_tpu_torch import observability as obs

        def span_flusher():
            import time as _time

            while not stop.is_set():
                _time.sleep(max(0.25, CONFIG.node_stats_period_s))
                try:
                    obs.flush(transport)
                except Exception:
                    pass

        threading.Thread(target=span_flusher, name="rtpu-span-flush",
                         daemon=True).start()

    def make_done(spec: TaskSpec):
        if server is not None and spec.task_id in server.cancelled:
            server.cancelled.discard(spec.task_id)
            from ray_tpu_torch import exceptions as exc
            from ray_tpu_torch._private import serialization as ser

            err = ser.pack(ser.serialize(exc.RayTpuError("task cancelled")))
            return {"t": "done", "task_id": spec.task_id.binary(),
                    "results": [], "error": err,
                    "error_str": "task cancelled"}
        from ray_tpu_torch._private.worker import _DepsUnready

        # Bounce-on-pending applies only to leased NORMAL tasks; actor
        # calls must keep per-caller submission order, so they block
        # (their producers are never queued behind them on this channel).
        worker.ctx.direct_exec = True
        worker.ctx.bounce_ok = spec.task_type == TaskType.NORMAL
        try:
            msg = worker.execute_task(spec)
        except _DepsUnready:
            # A dependency is still pending at its owner: bounce the task
            # back to the submitter, who re-routes it through the head
            # (never block the lease queue — the producer may be queued
            # right behind us).
            return {"t": "done", "task_id": spec.task_id.binary(),
                    "unready": True, "results": [], "error": None,
                    "error_str": None}
        finally:
            worker.ctx.direct_exec = False
            worker.ctx.bounce_ok = False
        return {"t": "done", "task_id": msg["task_id"],
                "results": msg["results"], "error": msg["error"],
                "error_str": msg["error_str"]}

    # Batched completions from actor pool threads funnel through one reply
    # queue; the flusher groups whatever accumulated per caller connection
    # into a single frame (mirrors the exec batching on the submit side).
    # Main-loop tasks batch directly (no queue hop).
    reply_q: "queue.SimpleQueue" = queue.SimpleQueue()

    def reply_flusher():
        while True:
            item = reply_q.get()
            if item is None:
                return
            batch = [item]
            while len(batch) < 64:
                try:
                    nxt = reply_q.get_nowait()
                except queue.Empty:
                    break
                if nxt is None:
                    return
                batch.append(nxt)
            by_conn: dict = {}
            for c, done in batch:
                by_conn.setdefault(id(c), (c, []))[1].append(done)
            for _cid, (c, dones) in by_conn.items():
                server.send_on(c, dones[0] if len(dones) == 1
                               else {"t": "doneb", "dones": dones})

    if server is not None:
        threading.Thread(target=reply_flusher, name="rtpu-reply-flush",
                         daemon=True).start()

    # Lightweight actor pool (max_concurrency > 1): N threads over a
    # SimpleQueue — the ThreadPoolExecutor submit path costs more than a
    # short actor method.
    actor_q: "queue.SimpleQueue" = queue.SimpleQueue()
    pool_started = 0

    def _fallback_error(cause: BaseException):
        """Serialized stand-in error for a reply whose construction raised
        (e.g. a result-serialization double fault)."""
        from ray_tpu_torch import exceptions as exc
        from ray_tpu_torch._private import serialization as ser

        error_str = f"worker failed to build task reply: {cause!r}"
        try:
            err = ser.pack(ser.serialize(exc.RayTpuError(error_str)))
        except BaseException:
            err = None
        return err, error_str

    def _run_and_reply(spec: TaskSpec, reply_conn) -> None:
        """Execute + reply, with the invariant that the caller ALWAYS
        receives a completion message: a swallowed reply (a raise between
        task completion and the send, as a result-serialization double
        fault used to do) leaves the driver blocked on a future that can
        never resolve, which reads as a gang hang."""
        import time as _time

        if reply_conn is None:
            try:
                msg = worker.execute_task(spec)
            except BaseException as e:  # noqa: BLE001 — reply must flow
                err, error_str = _fallback_error(e)
                now = _time.time()
                msg = {"type": "task_done",
                       "task_id": spec.task_id.binary(),
                       "worker_id": worker.worker_id.binary(),
                       "spec": spec, "results": [], "error": err,
                       "error_str": error_str, "crashed": False,
                       "start": now, "end": now}
            # notify() (not raw send): in acked mode a dropped task_done
            # is retried instead of stranding the driver on its future.
            transport.notify(msg)
        else:
            try:
                done = make_done(spec)
            except BaseException as e:  # noqa: BLE001 — reply must flow
                err, error_str = _fallback_error(e)
                done = {"t": "done", "task_id": spec.task_id.binary(),
                        "results": [], "error": err,
                        "error_str": error_str}
            reply_q.put((reply_conn, done))

    def pool_worker():
        while True:
            item = actor_q.get()
            if item is None:
                return
            spec, reply_conn = item
            _run_and_reply(spec, reply_conn)

    def run_one(spec: TaskSpec, reply_conn=None):
        _run_and_reply(spec, reply_conn)

    done_buf: dict = {}

    def flush_done_buf():
        for _cid, (c, dones) in done_buf.items():
            server.send_on(c, dones[0] if len(dones) == 1
                           else {"t": "doneb", "dones": dones})
        done_buf.clear()

    while not stop.is_set():
        if done_buf:
            # Never block with unsent completions buffered (the next item
            # may take a branch that doesn't touch the buffer).
            try:
                item = task_queue.get_nowait()
            except queue.Empty:
                flush_done_buf()
                item = task_queue.get()
        else:
            item = task_queue.get()
        if item is None:
            break
        spec, reply_conn = item
        if spec.task_type == TaskType.ACTOR_CREATION and spec.max_concurrency > 1:
            for _ in range(spec.max_concurrency):
                threading.Thread(target=pool_worker, name="rtpu-actor",
                                 daemon=True).start()
            pool_started = spec.max_concurrency
        if pool_started and spec.task_type == TaskType.ACTOR_TASK:
            actor_q.put((spec, reply_conn))
        elif reply_conn is None:
            if done_buf:
                flush_done_buf()  # classic task may block for a long time
            run_one(spec, None)
        else:
            if done_buf and _has_ref_args(spec):
                # A task with ref args can BLOCK in arg resolution — and
                # a completion still sitting in this worker's done buffer
                # may be (transitively) the producer of one of those
                # refs.  Holding it while blocking deadlocks any
                # cross-actor dependency chain (the MPMD pipeline's 1F1B
                # ref wiring hits this on every step): flush first.
                flush_done_buf()
            try:
                done = make_done(spec)
            except BaseException as e:  # noqa: BLE001 — reply must flow
                err, error_str = _fallback_error(e)
                done = {"t": "done", "task_id": spec.task_id.binary(),
                        "results": [], "error": err,
                        "error_str": error_str}
            dones = done_buf.setdefault(id(reply_conn), (reply_conn, []))[1]
            dones.append(done)
            if len(dones) >= 32 or task_queue.empty():
                flush_done_buf()

    try:
        conn.close()
    except Exception:
        pass
    sys.exit(0)


if __name__ == "__main__":
    main()
