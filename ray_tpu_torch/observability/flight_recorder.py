"""Crash flight recorder: snapshot the tracing rings into a postmortem
bundle when something dies.

The span rings are always collecting while tracing is on; this module
turns them into a black box.  On a death signal — ``remove_node`` (any
cause: agent EOF, lease expiry, chaos SIGKILL), ``kill_node``, a gang
restart, a MeshGroupError handler — the head writes one bundle dir:

    $RAY_TPU_TORCH_FLIGHT_RECORD_DIR/<millis>_<reason>/
        meta.json     reason, wall time, trigger details
        spans.json    TraceStore snapshot (incl. the victim's last
                      flushed spans — workers flush at task START, so a
                      SIGKILL mid-task still leaves the task.begin
                      marker and everything before it)
        tasks.json    state-API task rows at snapshot time
        events.json   the head's recent event log (node joins/deaths)

Disabled unless a directory is configured (``flight_record_dir`` config
flag / RAY_TPU_TORCH_FLIGHT_RECORD_DIR env) — chaos suites that don't opt in
pay nothing.  Bundle count is capped (oldest deleted) so a crash loop
cannot fill a disk.

Copied from ``ray_tpu/observability/flight_recorder.py`` (the JAX package).
"""
from __future__ import annotations

import json
import os
import re
import shutil
import time
from typing import Any, Dict, List, Optional


def flight_record_dir() -> Optional[str]:
    """The configured bundle root, or None when recording is off."""
    path = os.environ.get("RAY_TPU_TORCH_FLIGHT_RECORD_DIR")
    if not path:
        try:
            from ray_tpu_torch._private.config import CONFIG

            path = CONFIG.flight_record_dir
        except Exception:
            path = ""
    return path or None


def _max_bundles() -> int:
    try:
        from ray_tpu_torch._private.config import CONFIG

        return max(1, int(CONFIG.flight_record_max))
    except Exception:
        return 16


def _sanitize(reason: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]+", "_", reason)[:64] or "unknown"


def write_bundle(reason: str, *,
                 spans: List[Dict[str, Any]],
                 tasks: Optional[List[dict]] = None,
                 events: Optional[List[dict]] = None,
                 extra: Optional[Dict[str, Any]] = None,
                 root: Optional[str] = None) -> Optional[str]:
    """Write one postmortem bundle; returns its path (None when
    recording is disabled or the write fails — never raises into the
    death path that triggered it)."""
    root = root or flight_record_dir()
    if root is None:
        return None
    try:
        os.makedirs(root, exist_ok=True)
        name = f"{int(time.time() * 1000)}_{_sanitize(reason)}"
        path = os.path.join(root, name)
        os.makedirs(path, exist_ok=True)
        meta = {"reason": reason, "wall_time": time.time(),
                "spans": len(spans)}
        if extra:
            meta.update(extra)
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(meta, f, indent=2)
        with open(os.path.join(path, "spans.json"), "w") as f:
            json.dump(spans, f, default=str)
        with open(os.path.join(path, "tasks.json"), "w") as f:
            json.dump(tasks or [], f, default=str)
        with open(os.path.join(path, "events.json"), "w") as f:
            json.dump(events or [], f, default=str)
        _prune(root)
        return path
    except Exception:
        return None


def _prune(root: str) -> None:
    """Keep the newest ``flight_record_max`` bundles."""
    try:
        bundles = sorted(
            d for d in os.listdir(root)
            if os.path.isdir(os.path.join(root, d)))
        for stale in bundles[: max(0, len(bundles) - _max_bundles())]:
            shutil.rmtree(os.path.join(root, stale), ignore_errors=True)
    except Exception:
        pass


def read_bundle(path: str) -> Dict[str, Any]:
    """Load one bundle back (postmortem tooling / tests)."""
    out: Dict[str, Any] = {}
    for part in ("meta", "spans", "tasks", "events"):
        fp = os.path.join(path, f"{part}.json")
        try:
            with open(fp) as f:
                out[part] = json.load(f)
        except Exception:
            out[part] = None
    return out
