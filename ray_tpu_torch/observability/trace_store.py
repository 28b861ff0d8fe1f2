"""Head-side span storage: traces indexed by trace_id under byte budgets.

Reference: the GCS task-event table (gcs_table_storage.h) — but spans are
higher-volume telemetry, so the store is budgeted two ways: a per-trace
byte cap (one pathological trace cannot evict everything else) and a
global cap (LRU eviction of whole traces by last-update time).  Spans
arriving with no trace_id (tracing was on but the emitter ran outside
any propagated context) pool under the ``UNTRACED`` key so full-cluster
timelines still show them.

Copied from ``ray_tpu/observability/trace_store.py`` (the JAX package).
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional

UNTRACED = "untraced"


def _span_cost(span: Dict[str, Any]) -> int:
    """Cheap byte estimate: fixed record overhead + variable payloads."""
    cost = 160 + len(span.get("name") or "")
    args = span.get("args")
    if args:
        for k, v in args.items():
            cost += len(k) + len(str(v))
    return cost


class _Trace:
    __slots__ = ("spans", "bytes", "dropped", "first_ts", "last_update")

    def __init__(self):
        self.spans: List[Dict[str, Any]] = []
        self.bytes = 0
        self.dropped = 0
        self.first_ts: Optional[float] = None
        self.last_update = time.monotonic()


class TraceStore:
    """Capped span store indexed by trace_id.  Thread-safe."""

    def __init__(self, max_bytes: int = 32 * 1024 * 1024,
                 per_trace_bytes: int = 2 * 1024 * 1024):
        self.max_bytes = int(max_bytes)
        self.per_trace_bytes = int(per_trace_bytes)
        self._lock = threading.Lock()
        self._traces: "OrderedDict[str, _Trace]" = OrderedDict()
        self.total_bytes = 0
        self.spans_ingested = 0
        self.spans_dropped = 0
        self.traces_evicted = 0
        self.ring_dropped = 0  # emitter-side ring drops, relayed in batches

    def ingest(self, spans: List[Dict[str, Any]]) -> None:
        if not spans:
            return
        with self._lock:
            for span in spans:
                tid = span.get("trace_id") or UNTRACED
                tr = self._traces.get(tid)
                if tr is None:
                    tr = self._traces[tid] = _Trace()
                cost = _span_cost(span)
                if tr.bytes + cost > self.per_trace_bytes:
                    tr.dropped += 1
                    self.spans_dropped += 1
                    continue
                tr.spans.append(span)
                tr.bytes += cost
                tr.last_update = time.monotonic()
                start = span.get("start")
                if start is not None and (tr.first_ts is None
                                          or start < tr.first_ts):
                    tr.first_ts = start
                self._traces.move_to_end(tid)
                self.total_bytes += cost
                self.spans_ingested += 1
            # Global budget: evict least-recently-updated whole traces.
            while self.total_bytes > self.max_bytes and len(self._traces) > 1:
                _tid, victim = self._traces.popitem(last=False)
                self.total_bytes -= victim.bytes
                self.traces_evicted += 1

    def note_ring_dropped(self, n: int) -> None:
        if n > 0:
            with self._lock:
                self.ring_dropped += n

    def spans(self, trace_id: Optional[str] = None) -> List[Dict[str, Any]]:
        with self._lock:
            if trace_id is not None:
                tr = self._traces.get(trace_id)
                return list(tr.spans) if tr is not None else []
            out: List[Dict[str, Any]] = []
            for tr in self._traces.values():
                out.extend(tr.spans)
            return out

    def list_traces(self, limit: int = 50) -> List[Dict[str, Any]]:
        """Trace index rows, slowest (longest wall span) first."""
        with self._lock:
            rows = []
            for tid, tr in self._traces.items():
                if not tr.spans:
                    continue
                start = min(s["start"] for s in tr.spans)
                end = max(s["end"] for s in tr.spans)
                rows.append({
                    "trace_id": tid,
                    "spans": len(tr.spans),
                    "bytes": tr.bytes,
                    "dropped": tr.dropped,
                    "start": start,
                    "duration": end - start,
                    "procs": len({s.get("proc") for s in tr.spans}),
                    "nodes": len({s.get("node") for s in tr.spans
                                  if s.get("node")}),
                })
        rows.sort(key=lambda r: -r["duration"])
        return rows[: max(1, int(limit))]

    def summary(self) -> Dict[str, Any]:
        """Per-span-family stats (count / total seconds) — the per-plane
        breakdown behind ``python -m ray_tpu_torch traces``."""
        with self._lock:
            fam: Dict[str, Dict[str, float]] = {}
            for tr in self._traces.values():
                for s in tr.spans:
                    f = fam.setdefault(s["name"], {"count": 0, "seconds": 0.0})
                    f["count"] += 1
                    f["seconds"] += max(0.0, s["end"] - s["start"])
            return {
                "families": fam,
                "traces": len(self._traces),
                "total_bytes": self.total_bytes,
                "spans_ingested": self.spans_ingested,
                "spans_dropped": self.spans_dropped,
                "traces_evicted": self.traces_evicted,
                "ring_dropped": self.ring_dropped,
            }
