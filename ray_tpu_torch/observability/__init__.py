"""The tracing plane — cluster-wide trace context + span collection.

Reference: Ray's task-event pipeline (core worker task event buffer →
GCS task events → `ray.timeline()` / the state API) fused with
OpenTelemetry-style context propagation.  Four pieces live here:

1. **Trace context** — a compact ``(trace_id, parent_span_id)`` pair of
   hex strings, minted at driver API boundaries (``remote()``, ``put``,
   ``get``, ``generate_many``, pipeline step dispatch) and carried on
   every RPC frame, task spec, seal notify, and transfer pull.  The
   active context is thread-local; ``util.tracing.span`` and
   ``_private.profiling.record_span`` stamp it so a span recorded in a
   worker three hops away still lands in the caller's trace.
2. **SpanRing** — the shared bounded ring-buffer primitive: drop-oldest
   with a dropped counter, zero allocation while tracing is off.  One
   process-wide ring collects every completed span.
3. **Flush path** — ``flush(transport)`` drains the ring into a
   ``span_batch`` one-way request to the head; workers flush at task
   start/end and on the node-stats cadence, node agents relay their
   ring inside ``node_stats`` frames, the head drains its own ring
   in-process.  The head stores batches in a byte-budgeted TraceStore
   (see :mod:`ray_tpu_torch.observability.trace_store`).
4. **Flight recorder** — the same rings double as the crash black box:
   see :mod:`ray_tpu_torch.observability.flight_recorder`.

Everything here must be safe to import during bootstrap (no jax, no
eager config reads at module scope) and free when tracing is off: the
fast path out of every function is one cached-bool check.

Copied from ``ray_tpu/observability/__init__.py`` (the JAX package).
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

TraceContext = Tuple[str, str]  # (trace_id, span_id) — both 16-char hex

_tl = threading.local()
_identity_lock = threading.Lock()
_proc_label: Optional[str] = None
_node_hex: Optional[str] = None


def _enabled() -> bool:
    from ray_tpu_torch.util.tracing import tracing_enabled

    return tracing_enabled()


def enabled() -> bool:
    """True when the tracing plane is on (``tracing_enabled`` flag)."""
    return _enabled()


def new_id() -> str:
    return os.urandom(8).hex()


# ---------------------------------------------------------------------------
# identity: who this process is in the assembled timeline
# ---------------------------------------------------------------------------
def set_identity(proc: str, node: Optional[str] = None) -> None:
    """Label this process's spans (e.g. ``worker:ab12cd34`` on node X).
    Called once from CoreWorker / node agent / head bootstrap."""
    global _proc_label, _node_hex
    with _identity_lock:
        _proc_label = proc
        if node is not None:
            _node_hex = node


def identity() -> Tuple[str, Optional[str]]:
    return (_proc_label or f"pid:{os.getpid()}", _node_hex)


# ---------------------------------------------------------------------------
# trace context (thread-local)
# ---------------------------------------------------------------------------
def get_context() -> Optional[TraceContext]:
    """The active (trace_id, span_id) pair, or None."""
    return getattr(_tl, "ctx", None)


def set_context(ctx: Optional[TraceContext]) -> Optional[TraceContext]:
    """Install ``ctx`` as the active context; returns the previous one."""
    old = getattr(_tl, "ctx", None)
    _tl.ctx = ctx
    return old


@contextlib.contextmanager
def use_context(ctx: Optional[TraceContext]):
    old = set_context(ctx)
    try:
        yield ctx
    finally:
        set_context(old)


def mint_context() -> TraceContext:
    """A fresh root context: new trace_id, new root span id."""
    return (new_id(), new_id())


def clear_context() -> None:
    """Drop this thread's active context.  Called at session boundaries
    (``disable_tracing``, ``ray_tpu_torch.shutdown``): an implicit context
    installed by ``ensure_context`` must not outlive the session that
    minted it, or every later operation on this thread silently joins
    one stale, rootless trace."""
    _tl.ctx = None


def ensure_context() -> Optional[TraceContext]:
    """Driver API boundary helper: the active context, minting a new
    trace root if none is active.  None while tracing is off."""
    if not _enabled():
        return None
    ctx = get_context()
    if ctx is None:
        ctx = mint_context()
        _tl.ctx = ctx
    return ctx


def context_for_outbound() -> Optional[TraceContext]:
    """Context to stamp on an outbound task spec / RPC frame."""
    return ensure_context()


# ---------------------------------------------------------------------------
# SpanRing: the shared bounded span buffer
# ---------------------------------------------------------------------------
class SpanRing:
    """Bounded span buffer: drop-oldest with a dropped counter.

    The primitive behind both the cluster flush path (the process ring
    below) and ``util.tracing``'s local buffer — replaces the silent
    10k-truncation list that predated the tracing plane."""

    def __init__(self, capacity: int = 4096):
        self.capacity = max(16, int(capacity))
        self._items: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self.dropped_total = 0

    def append(self, item: Dict[str, Any]) -> None:
        with self._lock:
            if len(self._items) >= self.capacity:
                self.dropped_total += 1
            self._items.append(item)

    def drain(self) -> List[Dict[str, Any]]:
        with self._lock:
            out, self._items = list(self._items), deque(maxlen=self.capacity)
            return out

    def snapshot(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._items)

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)


_ring: Optional[SpanRing] = None
_ring_lock = threading.Lock()


def ring() -> SpanRing:
    """The process-wide span ring (lazily sized from config)."""
    global _ring
    if _ring is None:
        with _ring_lock:
            if _ring is None:
                try:
                    from ray_tpu_torch._private.config import CONFIG

                    cap = int(CONFIG.tracing_buffer_size)
                except Exception:
                    cap = 4096
                _ring = SpanRing(cap)
    return _ring


def spans_dropped_total() -> int:
    r = _ring
    return r.dropped_total if r is not None else 0


# ---------------------------------------------------------------------------
# recording
# ---------------------------------------------------------------------------
def record(name: str, start: float, end: float,
           ctx: Optional[TraceContext] = None,
           parent_id: Optional[str] = None,
           span_id: Optional[str] = None,
           **args) -> Optional[str]:
    """Record one completed span (wall-clock timestamps) into the
    process ring.  ``ctx`` defaults to the active context; when a
    context is live the span joins its trace with ``parent_id``
    defaulting to the context's span id.  Free when tracing is off."""
    if not _enabled():
        return None
    if ctx is None:
        ctx = get_context()
    trace_id = ctx[0] if ctx else None
    if parent_id is None and ctx is not None:
        parent_id = ctx[1]
    sid = span_id or new_id()
    if parent_id == sid:
        parent_id = None  # a root span is not its own parent
    proc, node = identity()
    ring().append({
        "name": name, "start": float(start), "end": float(end),
        "trace_id": trace_id, "span_id": sid, "parent_id": parent_id,
        "proc": proc, "node": node, "os_pid": os.getpid(),
        "args": dict(args) if args else {},
    })
    return sid


def record_instant(name: str, **args) -> Optional[str]:
    """Zero-duration marker span (e.g. ``task.begin`` — flushed before
    execution so a SIGKILLed worker's last act is on record)."""
    now = time.time()
    return record(name, now, now, **args)


# ---------------------------------------------------------------------------
# flush path
# ---------------------------------------------------------------------------
def drain_spans() -> List[Dict[str, Any]]:
    """Drain the process ring, feeding the drop counter to util.metrics
    (``tracing_spans_dropped_total``) best-effort along the way."""
    r = _ring
    if r is None:
        return []
    spans = r.drain()
    _export_dropped(r)
    return spans


_dropped_exported = 0


def _export_dropped(r: SpanRing) -> None:
    """Publish the drop counter delta through util.metrics.  Off the hot
    path (flush cadence only) and best-effort: no live driver, no KV."""
    global _dropped_exported
    delta = r.dropped_total - _dropped_exported
    if delta <= 0:
        return
    try:
        from ray_tpu_torch.util.metrics import Counter

        Counter("tracing_spans_dropped_total",
                "spans dropped by full ring buffers").inc(delta)
        _dropped_exported += delta
    except Exception:
        pass


def flush(transport) -> int:
    """Drain the ring and ship the batch to the head as a one-way
    ``span_batch`` request.  Returns the number of spans shipped."""
    if not _enabled():
        return 0
    spans = drain_spans()
    if not spans:
        return 0
    try:
        transport.request_oneway("span_batch", {"spans": spans})
    except Exception:
        # Head restarting / conn mid-replace: spans are droppable
        # telemetry, never worth failing the caller for.
        return 0
    return len(spans)


def flight_record(reason: str) -> None:
    """Driver-side trigger: ask the head to snapshot a postmortem bundle
    (gang restarts, MeshGroupError handlers).  No-op unless a flight
    record dir is configured."""
    from ray_tpu_torch.observability.flight_recorder import flight_record_dir

    if flight_record_dir() is None:
        return
    try:
        from ray_tpu_torch._private.worker import global_worker

        if global_worker is None:
            return
        flush(global_worker.transport)
        global_worker.transport.request_oneway(
            "flight_record", {"reason": reason})
    except Exception:
        pass


# ---------------------------------------------------------------------------
# task-spec adoption (executor side)
# ---------------------------------------------------------------------------
def adopt_spec_context(spec) -> Optional[TraceContext]:
    """Install a task spec's carried context as this thread's active
    context for the task's duration; returns the previous context (pass
    it back to :func:`set_context` in the caller's finally)."""
    tc = getattr(spec, "trace_ctx", None)
    return set_context(tuple(tc) if tc else None)
