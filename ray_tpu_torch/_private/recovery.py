"""Cluster-recovery counters: the observable surface of the node-loss plane.

Reference: Ray's fault-tolerance story (arxiv 1712.05889) is lineage
reconstruction plus surviving whole-node loss; the operator-facing proof
that recovery *happened* (rather than silently degraded results) is a
counter surface — the reference exports object_manager/reconstruction
metrics through the reporter agent.  Same pattern as the RPC plane's
``retry.RPC_STATS``: per-process plain-dict increments under one lock,
asserted on by chaos tests and merged into the head node's stats snapshot
(``node_stats`` → GCS node table → dashboard ``/metrics`` gauges).

Counters:

- ``node_deaths``            — nodes the head declared dead (exactly once
  per node: conn EOF, lease expiry, or explicit kill).
- ``objects_lost``           — objects whose last copy died with a node and
  that had NO recovery path (callers see ``ObjectLostError``).
- ``objects_reconstructed``  — lineage reconstructions resubmitted for
  task outputs lost with a node/eviction.
- ``objects_replicated``     — durable-put replicas written by the
  ``object_durability=replicate:K`` plane.
- ``objects_restored``       — objects that survived a holder-node death
  through a surviving replica location or a spill-file restore.
- ``oom_worker_kills``       — workers killed by a memory monitor (head or
  node agent) whose death surfaced as a typed ``OutOfMemoryError`` mark.

Copied from ``ray_tpu/_private/recovery.py`` (the JAX package).
"""
from __future__ import annotations

import threading
from typing import Dict

_lock = threading.Lock()

RECOVERY_STATS: Dict[str, int] = {
    "node_deaths": 0,
    "objects_lost": 0,
    "objects_reconstructed": 0,
    "objects_replicated": 0,
    "objects_restored": 0,
    "oom_worker_kills": 0,
}


def note(counter: str, n: int = 1) -> None:
    with _lock:
        RECOVERY_STATS[counter] = RECOVERY_STATS.get(counter, 0) + n


def recovery_stats() -> Dict[str, int]:
    with _lock:
        return dict(RECOVERY_STATS)


def reset_recovery_stats() -> None:
    with _lock:
        for k in RECOVERY_STATS:
            RECOVERY_STATS[k] = 0
