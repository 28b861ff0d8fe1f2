"""Per-node resource-usage snapshots (reference: the dashboard reporter
agent collecting cpu/gpu/mem per node, python/ray/_private/metrics_agent.py
:375 + dashboard/modules/reporter/) — here a plain function the head's
monitor loop (local nodes) and each node agent (remote nodes) call on a
period, with results stored on the GCS node table and exported as
Prometheus gauges by the dashboard.

Copied from ``ray_tpu/_private/node_stats.py`` (the JAX package).
"""
from __future__ import annotations

import time
from typing import Optional


def host_snapshot() -> dict:
    """One host-level cpu/mem snapshot.  cpu_percent uses psutil's
    since-last-call accounting (first call returns 0.0), so call this
    ONCE per tick and share the result across co-hosted nodes —
    back-to-back calls measure a microsecond interval and return
    meaningless values."""
    import psutil

    vm = psutil.virtual_memory()
    return {
        "cpu_percent": float(psutil.cpu_percent(interval=None)),
        "mem_total_bytes": int(vm.total),
        "mem_used_bytes": int(vm.total - vm.available),
        "ts": time.time(),
    }


def collect_node_stats(store=None, num_workers: Optional[int] = None,
                       host_base: Optional[dict] = None) -> dict:
    """Per-node snapshot: host stats (taken fresh, or shared via
    `host_base` when several nodes live on one host) plus the node's own
    store usage and worker count."""
    stats = dict(host_base) if host_base is not None else host_snapshot()
    if num_workers is not None:
        stats["num_workers"] = int(num_workers)
    if store is not None:
        try:
            s = store.stats() or {}
            for k in ("capacity_bytes", "used_bytes", "num_objects",
                      "num_pinned"):
                if k in s:
                    stats[f"store_{k}"] = s[k]
        except Exception:
            pass
    return stats
