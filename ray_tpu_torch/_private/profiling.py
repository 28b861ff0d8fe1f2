"""Chrome-trace timeline export (reference: ray.timeline() →
chrome_tracing_dump, python/ray/_private/profiling.py:43 over core-worker
profile events, src/ray/core_worker/profile_event.h) plus an in-process
span recorder for driver-side hot-path instrumentation (pipeline dispatch
and drain spans from ray_tpu_torch.parallel.mesh_group.StepPipeline, device
prefetch spans from ray_tpu_torch.data.prefetch).

The recorder is deliberately dumb and allocation-cheap: a bounded deque of
dicts behind one lock, no I/O, no KV round trips — it must be safe to call
once per training step without perturbing the thing it measures.  Readers
(tools/perf_smoke.py, tests) pull spans with ``recorded_spans``; the chrome
trace export merges them as one extra lane so overlap is visible in
chrome://tracing next to the task timeline.

When the tracing plane is on (ray_tpu_torch.observability), every recorded
span is ALSO stamped with the active (or explicitly passed) trace
context and mirrored into the cluster span ring, so the
``mpmd_stage_*`` / ``rollout_*`` / ``flow_*`` / ``replay_*`` families
assemble into cross-process traces instead of staying anonymous.
perf_counter timestamps are rebased to wall clock at record time so
they merge with task events from other processes.

Copied from ``ray_tpu/_private/profiling.py`` (the JAX package).
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import List, Optional

# Bounded: a forgotten long-running pipeline must not grow driver memory.
_MAX_RECORDED_SPANS = 8192
_recorded: "deque" = deque(maxlen=_MAX_RECORDED_SPANS)
_recorded_lock = threading.Lock()


def record_span(name: str, start: float, end: float,
                _trace_ctx=None, _root=False, **args) -> None:
    """Record one completed span (timestamps from time.perf_counter()).

    Used by the step pipeline ("pipeline_dispatch"/"pipeline_drain", with
    step=<idx>) and the device prefetcher ("prefetch_h2d").  Thread-safe;
    never raises.  ``_trace_ctx`` pins the span to an explicit
    (trace_id, parent_span_id) pair for emitters that run off the
    submitting thread (flow stage workers); otherwise the thread's
    active context is stamped.  ``_root=True`` records the span AS the
    context's root (span_id = ctx[1]) — the mint point uses it once per
    trace so children parented to the root id resolve to a real span
    and cross-process flow arrows have an anchor."""
    try:
        with _recorded_lock:
            _recorded.append({"name": name, "start": float(start),
                              "end": float(end), "args": dict(args)})
        from ray_tpu_torch.util.tracing import tracing_enabled

        if tracing_enabled():
            from ray_tpu_torch import observability as obs

            # perf_counter → wall clock, rebased at record time.
            offset = time.time() - time.perf_counter()
            kw = {}
            if _root and _trace_ctx is not None:
                kw = {"span_id": _trace_ctx[1], "parent_id": None}
            obs.record(name, float(start) + offset, float(end) + offset,
                       ctx=_trace_ctx, **kw, **args)
    except Exception:
        pass


def recorded_spans(name: Optional[str] = None,
                   clear: bool = False) -> List[dict]:
    """Snapshot recorded spans (optionally filtered by name), oldest first."""
    with _recorded_lock:
        spans = list(_recorded)
        if clear:
            _recorded.clear()
    if name is not None:
        spans = [s for s in spans if s["name"] == name]
    return spans


def clear_recorded_spans() -> None:
    with _recorded_lock:
        _recorded.clear()


def chrome_tracing_dump(task_events: List[dict],
                        filename: Optional[str] = None,
                        include_recorded: bool = False,
                        spans: Optional[List[dict]] = None) -> List[dict]:
    """Convert the state API's task list into chrome://tracing events.

    ``spans`` (TraceStore records) merge in with per-node pid lanes,
    per-process tid lanes, and cross-process flow arrows — see
    ray_tpu_torch.observability.timeline.  ``include_recorded=True`` appends
    the in-process span recorder's entries as a separate lane so
    pipeline dispatch/drain overlap shows up against the task timeline."""
    from ray_tpu_torch.observability.timeline import build_chrome_trace

    extra = None
    if include_recorded:
        extra = [{
            "name": s["name"],
            "cat": "SPAN",
            "ph": "X",
            "ts": s["start"] * 1e6,
            "dur": (s["end"] - s["start"]) * 1e6,
            "pid": "ray_tpu_torch",
            "tid": "spans",
            "args": s["args"],
        } for s in recorded_spans()]
    events = build_chrome_trace(task_events, spans or [],
                                extra_events=extra)
    if filename:
        with open(filename, "w") as f:
            json.dump(events, f)
    return events
