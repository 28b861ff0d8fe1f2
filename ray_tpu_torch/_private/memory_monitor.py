"""Host memory-pressure monitor + OOM worker-killing policies.

Equivalent of the reference's ``MemoryMonitor``
(src/ray/common/memory_monitor.h:52) and the raylet's pluggable
``WorkerKillingPolicy`` (src/ray/raylet/worker_killing_policy.h:33,
group-by-owner variant worker_killing_policy_group_by_owner.h:85): when
host (or cgroup) memory usage crosses a threshold, the node kills a
carefully-chosen worker instead of letting the kernel OOM-killer take
down the raylet/head — the victim's task is retried if it has retry
budget, else failed with :class:`~ray_tpu_torch.exceptions.OutOfMemoryError`.

Policy choice (``worker_killing_policy`` flag):

- ``retriable_lifo`` (default, matching the reference's default,
  ray_config_def.h:103): newest retriable task first, then newest
  non-retriable (LIFO preserves the most accumulated work).
- ``group_by_owner``: group running workers by the owner that submitted
  their task; prefer the group with retriable tasks and the most members
  (killing there frees memory while leaving every owner some forward
  progress), newest task first within the group.

Usage is read from cgroup v2 (``memory.current``/``memory.max``) when
the process is inside a limited cgroup, else from ``/proc/meminfo``
(1 - MemAvailable/MemTotal) — the same dual sourcing as the reference's
``GetMemoryBytes``.  Tests inject pressure through the
``memory_monitor_test_file`` flag (a file holding a float fraction),
mirroring the reference's fake-memory test hook.

Copied from ``ray_tpu/_private/memory_monitor.py`` (the JAX package).
"""
from __future__ import annotations

import time
from typing import Callable, List, Optional, Tuple

_CGROUP_CURRENT = "/sys/fs/cgroup/memory.current"
_CGROUP_MAX = "/sys/fs/cgroup/memory.max"
_MEMINFO = "/proc/meminfo"


def host_memory_usage_fraction() -> float:
    """Fraction of memory in use on this host (0.0–1.0), preferring the
    cgroup v2 limit when one is set (containerized runs)."""
    try:
        with open(_CGROUP_MAX) as f:
            raw = f.read().strip()
        if raw != "max":
            limit = float(raw)
            with open(_CGROUP_CURRENT) as f:
                current = float(f.read().strip())
            if limit > 0:
                return current / limit
    except (OSError, ValueError):
        pass
    try:
        total = avail = None
        with open(_MEMINFO) as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    total = float(line.split()[1])
                elif line.startswith("MemAvailable:"):
                    avail = float(line.split()[1])
                if total is not None and avail is not None:
                    break
        if total and avail is not None:
            # Fail open when MemAvailable is missing (pre-3.14 kernels /
            # restricted /proc): a fabricated 100% would kill-storm.
            return 1.0 - avail / total
    except (OSError, ValueError):
        pass
    return 0.0


# ---------------------------------------------------------------------------
# Worker-killing policies.  A candidate is (handle, spec, started_at) for a
# worker currently executing a task; both policies return the victim handle
# or None.  Pure functions over the snapshot so they unit-test in isolation
# (the reference's policies are tested the same way,
# worker_killing_policy_test.cc).
# ---------------------------------------------------------------------------
Candidate = Tuple[object, object, float]  # (WorkerHandle, TaskSpec, start time)


def _retriable(spec) -> bool:
    return spec.attempt < spec.max_retries


def retriable_lifo_policy(candidates: List[Candidate]) -> Optional[object]:
    """Newest retriable task's worker first; non-retriable only as a last
    resort (reference: RetriableLIFOWorkerKillingPolicy,
    worker_killing_policy.cc:32 — retriable before non-retriable, then
    task time descending)."""
    if not candidates:
        return None
    retriable = [c for c in candidates if _retriable(c[1])]
    pool = retriable or candidates
    return max(pool, key=lambda c: c[2])[0]


def group_by_owner_policy(candidates: List[Candidate]) -> Optional[object]:
    """Group by (owner, retriable); prefer retriable groups, then larger
    groups, then the group whose newest member is youngest; kill the newest
    worker in the chosen group (reference:
    worker_killing_policy_group_by_owner.h:85)."""
    if not candidates:
        return None
    groups: dict = {}
    for c in candidates:
        spec = c[1]
        owner = spec.owner_worker_id.binary() if spec.owner_worker_id else b""
        groups.setdefault((owner, _retriable(spec)), []).append(c)

    def rank(item):
        (_, retriable), members = item
        newest = max(m[2] for m in members)
        return (retriable, len(members), newest)

    _, members = max(groups.items(), key=rank)
    return max(members, key=lambda c: c[2])[0]


POLICIES = {
    "group_by_owner": group_by_owner_policy,
    "retriable_lifo": retriable_lifo_policy,
}


class MemoryMonitor:
    """Periodically evaluated by the head's health-monitor loop: when usage
    crosses the threshold, kill one local worker per check period (gradual
    pressure relief, like the reference's one-kill-per-interval pacing)."""

    def __init__(self, head):
        from ray_tpu_torch._private.config import CONFIG

        self.head = head
        self.threshold = CONFIG.memory_usage_threshold
        self.period_s = CONFIG.memory_monitor_refresh_ms / 1000.0
        name = CONFIG.worker_killing_policy
        if name not in POLICIES:
            # Reference behavior (worker_killing_policy.cc:105): warn and
            # fall back to the default rather than crashing init.
            import warnings

            warnings.warn(
                f"worker_killing_policy={name!r} is invalid (choices: "
                f"{sorted(POLICIES)}); defaulting to retriable_lifo")
            name = "retriable_lifo"
        self.policy = POLICIES[name]
        self._test_file = CONFIG.memory_monitor_test_file
        self._last_check = 0.0
        self.kill_count = 0  # observability: surfaced via state API stats

    @property
    def enabled(self) -> bool:
        return self.period_s > 0

    def usage(self) -> float:
        if self._test_file:
            try:
                with open(self._test_file) as f:
                    return float(f.read().strip() or 0.0)
            except (OSError, ValueError):
                return 0.0
        return host_memory_usage_fraction()

    def tick(self) -> None:
        """Called under the head lock from the monitor loop."""
        now = time.monotonic()
        if not self.enabled or now - self._last_check < self.period_s:
            return
        self._last_check = now
        usage = self.usage()
        if usage < self.threshold:
            return
        victim = self.policy(self._candidates())
        if victim is None:
            # Last resort: actor workers.  The reference's policies rank
            # actors/non-retriable last rather than exempting them — a host
            # whose pressure comes from actors must still get relief (the
            # actor FSM's restart path rebuilds state afterwards).  Newest
            # actor first: it has accumulated the least state.
            victim = self._actor_last_resort()
        if victim is None:
            return
        self.kill_count += 1
        spec = victim.current_task
        self.head.gcs.publish(
            "oom",
            {"worker_id": victim.worker_id.hex(),
             "task": spec.name if spec else None,
             "usage": usage})
        # Mark so the death handler reports OutOfMemoryError (not a generic
        # crash, and with the usage at kill time) when the retry budget is
        # exhausted.
        if spec is not None:
            from ray_tpu_torch._private.recovery import note

            note("oom_worker_kills")
            self.head._oom_killed[spec.task_id] = usage
        try:
            victim.proc.kill()
        except Exception:
            pass

    def _candidates(self) -> List[Candidate]:
        from ray_tpu_torch._private.raylet import RemoteRaylet

        out: List[Candidate] = []
        for raylet in self.head.raylets.values():
            if isinstance(raylet, RemoteRaylet):
                # This monitor reads the HEAD host's memory; killing a
                # worker on another host frees nothing here (remote hosts
                # run their own pressure handling in the node agent).
                continue
            for h in raylet.workers.values():
                # Only busy workers running a normal (non-actor-bound)
                # task are eligible: killing an actor loses state the FSM
                # would have to rebuild, so actors are spared like the
                # reference's policy spares non-retriable groups until last.
                # proc.poll() is None filters corpses: a worker killed on
                # the previous tick may not be reaped yet (the liveness
                # scan runs after this tick), and re-selecting it would
                # waste the one-kill-per-period pacing on a dead process.
                if (h.current_task is not None and h.actor_id is None
                        and h.proc is not None and h.proc.poll() is None):
                    out.append((h, h.current_task, h.task_started_at))
        return out

    def _actor_last_resort(self):
        from ray_tpu_torch._private.raylet import RemoteRaylet

        best, best_t = None, -1.0
        for raylet in self.head.raylets.values():
            if isinstance(raylet, RemoteRaylet):
                continue
            for h in raylet.workers.values():
                if (h.actor_id is not None and h.proc is not None
                        and h.proc.poll() is None):
                    # idle_since ~= registration time for actor workers
                    # (they never rejoin the idle pool): newest actor has
                    # accumulated the least state.
                    t = h.idle_since
                    if t > best_t:
                        best, best_t = h, t
        return best
