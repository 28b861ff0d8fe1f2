"""Timeline assembly: task events + cluster spans → one chrome trace.

Extends the original ``profiling.chrome_tracing_dump`` shape with the
cluster dimension: every event lands in a ``pid`` lane per (virtual)
node and a ``tid`` lane per process (worker / driver / agent), and
cross-process parent→child span edges are stitched with chrome flow
arrows (``ph: "s"`` at the parent, ``ph: "f"`` at the child) so one
training step or serve request reads as a connected graph in
chrome://tracing rather than disjoint bars.

Copied from ``ray_tpu/observability/timeline.py`` (the JAX package).
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional


def _node_lane(node_hex: Optional[str]) -> str:
    return f"node:{node_hex[:8]}" if node_hex else "cluster"


def build_chrome_trace(tasks: List[dict], spans: List[dict],
                       filename: Optional[str] = None,
                       extra_events: Optional[List[dict]] = None
                       ) -> List[dict]:
    """Merge state-API task rows and TraceStore spans into chrome
    events.  Returns the event list (and writes it when ``filename``)."""
    events: List[dict] = []
    for t in tasks or []:
        if t.get("start") is None or t.get("end") is None:
            continue
        events.append({
            "name": t["name"],
            "cat": t.get("type", "TASK"),
            "ph": "X",
            "ts": t["start"] * 1e6,
            "dur": (t["end"] - t["start"]) * 1e6,
            "pid": _node_lane(t.get("node_id")),
            "tid": (t.get("worker_id") or "driver")[:12],
            "args": {"task_id": t["task_id"], "attempt": t.get("attempt", 0),
                     "status": t.get("status"),
                     "trace_id": t.get("trace_id")},
        })
    by_id: Dict[str, dict] = {}
    for s in spans or []:
        sid = s.get("span_id")
        if sid:
            by_id[sid] = s
        args = dict(s.get("args") or {})
        if s.get("trace_id"):
            args["trace_id"] = s["trace_id"]
        events.append({
            "name": s["name"],
            "cat": "SPAN",
            "ph": "X",
            "ts": s["start"] * 1e6,
            "dur": max(0.0, (s["end"] - s["start"]) * 1e6),
            "pid": _node_lane(s.get("node")),
            "tid": s.get("proc") or "spans",
            "args": args,
        })
    events.extend(_flow_edges(spans or [], by_id))
    events.extend(_lane_metadata(events))
    if extra_events:
        events.extend(extra_events)
    if filename:
        with open(filename, "w") as f:
            json.dump(events, f)
    return events


def _lane_metadata(events: List[dict]) -> List[dict]:
    """Chrome ``M`` metadata naming the lanes: one ``process_name`` per
    node pid and one ``thread_name`` per process tid, so the viewer
    shows 'node:ab12cd34 / worker:1f00' instead of bare hashes."""
    meta: List[dict] = []
    pids = {}
    tids = set()
    for e in events:
        pid = e.get("pid")
        if pid is None:
            continue
        pids.setdefault(pid, None)
        tid = e.get("tid")
        if tid is not None:
            tids.add((pid, tid))
    for pid in pids:
        meta.append({"name": "process_name", "ph": "M", "pid": pid,
                     "args": {"name": pid}})
    for pid, tid in sorted(tids):
        meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                     "tid": tid, "args": {"name": str(tid)}})
    return meta


def _flow_edges(spans: List[dict], by_id: Dict[str, dict]) -> List[dict]:
    """Flow arrows for parent→child edges that cross a process boundary
    (same-process nesting is already visible as stacked bars)."""
    edges: List[dict] = []
    eid = 0
    for child in spans:
        pid = child.get("parent_id")
        parent = by_id.get(pid) if pid else None
        if parent is None or parent is child:
            continue
        if (parent.get("proc"), parent.get("node")) == \
                (child.get("proc"), child.get("node")):
            continue
        eid += 1
        # The flow start must sit inside the parent slice; clamp the
        # child-start timestamp into the parent's [start, end] window.
        start_ts = min(max(child["start"], parent["start"]), parent["end"])
        edges.append({
            "name": "trace", "cat": "flow", "ph": "s", "id": eid,
            "ts": start_ts * 1e6,
            "pid": _node_lane(parent.get("node")),
            "tid": parent.get("proc") or "spans",
        })
        edges.append({
            "name": "trace", "cat": "flow", "ph": "f", "bp": "e", "id": eid,
            "ts": max(child["start"], start_ts) * 1e6,
            "pid": _node_lane(child.get("node")),
            "tid": child.get("proc") or "spans",
        })
    return edges


def trace_stats(events: List[dict]) -> Dict[str, Any]:
    """Quick shape summary of an assembled chrome dump (used by tests
    and the perf smoke to assert the cross-process acceptance bar)."""
    slices = [e for e in events if e.get("ph") == "X"]
    spans = [e for e in slices if e.get("cat") == "SPAN"]
    return {
        "events": len(events),
        "slices": len(slices),
        "span_slices": len(spans),
        "procs": len({e["tid"] for e in spans}),
        "nodes": len({e["pid"] for e in slices}),
        "flow_edges": sum(1 for e in events if e.get("ph") == "s"),
    }
