"""OpenTelemetry tracing integration.

Reference: python/ray/util/tracing/tracing_helper.py — the runtime is
instrumented against the opentelemetry *API* (present in this image);
span data goes wherever the application's TracerProvider sends it, so
wiring an SDK/exporter is the user's call exactly as in the reference
(`ray.init(_tracing_startup_hook=...)`).  Without a provider the API's
no-op tracer makes every span free.

Surface:
- ``enable_tracing()`` / ``tracing_enabled()`` — process-local switch
  (also on via the ``tracing_enabled`` config flag / RAY_TPU_TRACING_ENABLED).
- ``span(name, **attrs)`` — context manager used at the runtime's
  instrumentation points (task submit, task execute, actor calls).
  Each span joins the active distributed trace context
  (ray_tpu_torch.observability) and becomes the active parent for anything
  submitted inside it, so cross-process timelines assemble.
- Spans ALSO land in a process-local ring (``pop_local_spans``) so
  `ray_tpu_torch.timeline()`-style tooling sees them even with no SDK.  The
  ring is the shared drop-oldest primitive (observability.SpanRing) —
  overflow is counted, not silently truncated, and the counter is
  exported as ``tracing_spans_dropped_total`` through util.metrics.

Copied from ``ray_tpu/util/tracing.py`` (the JAX package).
"""
from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, List, Optional

_enabled: Optional[bool] = None
_local_ring = None  # observability.SpanRing, created on first span


def enable_tracing():
    global _enabled
    _enabled = True


def disable_tracing():
    global _enabled
    _enabled = False
    # The tracing session's implicit driver context dies with it:
    # obs.ensure_context() installs one on this thread at API boundaries,
    # and a leftover would absorb the next session's spans into a stale
    # rootless trace.
    from ray_tpu_torch import observability as _obs

    _obs.clear_context()


def tracing_enabled() -> bool:
    global _enabled
    if _enabled is None:
        from ray_tpu_torch._private.config import CONFIG

        _enabled = bool(CONFIG.tracing_enabled)
    return _enabled


def _tracer():
    try:
        from opentelemetry import trace

        return trace.get_tracer("ray_tpu_torch")
    except Exception:
        return None


def _ring():
    global _local_ring
    if _local_ring is None:
        from ray_tpu_torch import observability as obs

        _local_ring = obs.SpanRing(10_000)
    return _local_ring


def spans_dropped_total() -> int:
    """Local-buffer drops (the process ring counts its own separately)."""
    return _local_ring.dropped_total if _local_ring is not None else 0


@contextlib.contextmanager
def span(name: str, **attributes):
    """Instrumentation point: otel span (no-op without a provider) plus a
    local record for timeline tooling.  Joins the active trace context
    and is the active parent for nested work while open."""
    if not tracing_enabled():
        yield
        return
    from ray_tpu_torch import observability as obs

    t0 = time.time()
    tracer = _tracer()
    otel = (tracer.start_as_current_span(name, attributes=attributes)
            if tracer is not None else contextlib.nullcontext())
    parent = obs.get_context()
    trace_id = parent[0] if parent else obs.new_id()
    parent_id = parent[1] if parent else None
    sid = obs.new_id()
    old = obs.set_context((trace_id, sid))
    try:
        with otel:
            yield
    finally:
        obs.set_context(old)
        end = time.time()
        _ring().append({"name": name, "start": t0, "end": end,
                        "trace_id": trace_id, "span_id": sid,
                        "parent_id": parent_id, "attributes": attributes})
        obs.record(name, t0, end, ctx=(trace_id, sid), parent_id=parent_id,
                   span_id=sid, **attributes)


def pop_local_spans() -> List[Dict[str, Any]]:
    r = _local_ring
    if r is None:
        return []
    spans = r.drain()
    _export_dropped(r)
    return spans


_dropped_exported = 0


def _export_dropped(r) -> None:
    """Ship the drop-counter delta into util.metrics, off the hot path
    (drain cadence only) and best-effort (needs a live driver KV)."""
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
