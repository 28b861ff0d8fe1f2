"""Shared RPC deadline/retry machinery for the control plane.

Reference: Ray treats every cross-process edge as lossy — per-call
deadlines with retries in the GCS/raylet clients (gcs_rpc_client.h
retryable grpc client, ray_config_def.h's *_rpc_timeout_ms family) are
what let it survive real clusters.  This module is the one place that
policy lives here:

- :class:`Deadline` — a monotonic budget threaded through retry loops.
- :class:`RetryPolicy` — exponential backoff with jitter, used both for
  resend cadence (attempt timeouts) and inter-attempt sleeps.
- :class:`ReplyCache` — the head-side exactly-once filter: every
  ``request`` frame carries an idempotency key; the first frame with a
  key executes (entry IN_PROGRESS -> DONE with the cached reply), any
  duplicate/retried frame *attaches* to the entry and is answered from
  the cache instead of re-applying the op.  This is what makes blind
  resends safe for non-idempotent ops (submit, seal, put_inline).
- The in-flight registry + :func:`rpc_inflight_stats` — a hung-call
  watchdog surface: every pending RPC's age is observable, and
  transports dump the blocked thread's stack to stderr once a call
  outlives its deadline (see ConnTransport's keeper thread).

Counters in :data:`RPC_STATS` are per-process and cheap (plain dict
increments under one lock); tests and the perf smoke assert on them.

Copied from ``ray_tpu/_private/retry.py`` (the JAX package).
"""
from __future__ import annotations

import random
import sys
import threading
import time
import traceback
import weakref
from collections import OrderedDict
from typing import Any, Callable, Dict, Optional, Tuple

from ray_tpu_torch.exceptions import RpcTimeoutError  # noqa: F401 — re-export

# ---------------------------------------------------------------------------
# Deadlines + backoff
# ---------------------------------------------------------------------------


class Deadline:
    """A monotonic time budget.  ``timeout=None`` (or <= 0) = unbounded."""

    __slots__ = ("timeout", "start", "_until")

    def __init__(self, timeout: Optional[float]):
        if timeout is not None and timeout <= 0:
            timeout = None
        self.timeout = timeout
        self.start = time.monotonic()
        self._until = None if timeout is None else self.start + timeout

    def remaining(self) -> Optional[float]:
        if self._until is None:
            return None
        return self._until - time.monotonic()

    def expired(self) -> bool:
        return self._until is not None and time.monotonic() >= self._until

    def elapsed(self) -> float:
        return time.monotonic() - self.start

    def bound(self, interval: float) -> float:
        """Clamp a per-attempt wait to what's left of the budget."""
        rem = self.remaining()
        if rem is None:
            return interval
        return max(0.0, min(interval, rem))


class RetryPolicy:
    """Exponential backoff with jitter (reference: the gcs client's
    exponential-backoff reconnect, ray_config_def.h:58-62)."""

    __slots__ = ("base", "mult", "cap", "jitter", "_rng")

    def __init__(self, base: float = 0.05, mult: float = 2.0,
                 cap: float = 2.0, jitter: float = 0.2,
                 seed: Optional[int] = None):
        self.base = base
        self.mult = mult
        self.cap = cap
        self.jitter = jitter
        self._rng = random.Random(seed)

    def delay(self, attempt: int) -> float:
        """Backoff before retry number ``attempt`` (1-based)."""
        d = min(self.cap, self.base * (self.mult ** max(0, attempt - 1)))
        if self.jitter:
            d *= 1.0 + self._rng.uniform(-self.jitter, self.jitter)
        return max(0.0, d)


def rpc_defaults() -> Tuple[Optional[float], float]:
    """(default overall timeout | None, per-attempt resend interval)."""
    from ray_tpu_torch._private.config import CONFIG

    total = CONFIG.rpc_timeout
    return (total if total and total > 0 else None,
            max(0.01, CONFIG.rpc_attempt_timeout))


# ---------------------------------------------------------------------------
# Stats
# ---------------------------------------------------------------------------

_stats_lock = threading.Lock()
RPC_STATS: Dict[str, int] = {
    "retries": 0,          # blocking-request resends
    "async_retries": 0,    # keeper-thread resends of acked one-way ops
    "timeouts": 0,         # RpcTimeoutError raised
    "async_dropped": 0,    # acked one-way ops abandoned past deadline
    "dedup_hits": 0,       # head reply-cache hits (duplicate frames)
    "hang_dumps": 0,       # watchdog stack dumps emitted
    "net_faults": 0,       # chaos faults actually injected
}


def note(counter: str, n: int = 1) -> None:
    with _stats_lock:
        RPC_STATS[counter] = RPC_STATS.get(counter, 0) + n


def rpc_stats() -> Dict[str, int]:
    with _stats_lock:
        return dict(RPC_STATS)


def reset_rpc_stats() -> None:
    with _stats_lock:
        for k in RPC_STATS:
            RPC_STATS[k] = 0


# ---------------------------------------------------------------------------
# Head-side exactly-once reply cache
# ---------------------------------------------------------------------------

class ReplyCache:
    """Idempotency-key -> reply memo with in-progress attachment.

    ``admit(key, reply)`` returns ``(should_run, wrapped_reply)``:

    - first frame for ``key``: ``(True, wrapped)`` — the caller runs the
      handler with ``wrapped``, which records the reply and flushes any
      duplicates that attached while the op was in flight;
    - duplicate frame: ``(False, None)`` — its ``reply`` was either
      answered immediately from the cache (op already done) or attached
      to the in-progress entry (answered when the first execution
      replies).  The op itself is never applied twice.

    Entries are bounded (``cap``) and aged out (``ttl`` seconds after
    their reply was recorded); in-progress entries are never evicted —
    a deferred reply (blocking get) may legitimately take minutes.
    """

    _DONE = 1
    _IN_PROGRESS = 0

    def __init__(self, cap: int = 1024, ttl: float = 300.0):
        self.cap = cap
        self.ttl = ttl
        self._lock = threading.Lock()
        # key -> [state, value, error, waiters, done_ts]
        self._entries: "OrderedDict[bytes, list]" = OrderedDict()

    def admit(self, key: bytes, reply: Callable
              ) -> Tuple[bool, Optional[Callable]]:
        replay = None
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                e = self._entries[key] = [self._IN_PROGRESS, None, None,
                                          [], 0.0]
                self._prune_locked()

                def wrapped(value=None, error=None, _e=e):
                    with self._lock:
                        if _e[0] == self._DONE:
                            return  # handler double-reply: first wins
                        _e[0] = self._DONE
                        _e[1], _e[2] = value, error
                        _e[4] = time.monotonic()
                        waiters, _e[3] = _e[3], []
                    reply(value, error=error)
                    for w in waiters:
                        try:
                            w(value, error=error)
                        except Exception:
                            pass

                return True, wrapped
            note("dedup_hits")
            if e[0] == self._DONE:
                replay = (e[1], e[2])
            else:
                e[3].append(reply)
        if replay is not None:
            reply(replay[0], error=replay[1])
        return False, None

    def _prune_locked(self):
        # Only DONE entries are evictable (an in-progress entry is a live
        # deferred reply); scan is bounded so admit() stays O(1)-ish.
        now = time.monotonic()
        over = len(self._entries) - self.cap
        scanned = 0
        for key in list(self._entries):
            scanned += 1
            if scanned > 256 or (over <= 0 and scanned > 32):
                break
            e = self._entries[key]
            if e[0] != self._DONE:
                continue
            if over > 0 or now - e[4] > self.ttl:
                del self._entries[key]
                over -= 1

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


# ---------------------------------------------------------------------------
# In-flight registry (hung-call watchdog surface)
# ---------------------------------------------------------------------------

_transports: "weakref.WeakSet" = weakref.WeakSet()
_transports_lock = threading.Lock()


def register_transport(transport) -> None:
    """Transports with a ``pending_rpcs()`` accessor register here so the
    process-wide in-flight stats cover every connection."""
    with _transports_lock:
        _transports.add(transport)


def rpc_inflight_stats() -> Dict[str, Any]:
    """Snapshot of every in-flight RPC in this process: count, max age,
    and the oldest op — the watchdog's exported metric surface."""
    now = time.monotonic()
    count = 0
    max_age = 0.0
    oldest_op = None
    with _transports_lock:
        transports = list(_transports)
    for tr in transports:
        try:
            pending = tr.pending_rpcs()
        except Exception:
            continue
        for rec in pending:
            count += 1
            age = now - rec.started
            if age >= max_age:
                max_age = age
                oldest_op = rec.op
    return {"count": count, "max_age_s": max_age, "oldest_op": oldest_op}


def dump_blocked_rpc(rec, reason: str = "past deadline") -> None:
    """Stderr dump for a stuck call: op, age, attempts, and the waiting
    thread's stack (the in-process SIGUSR1 equivalent, per call)."""
    note("hang_dumps")
    age = time.monotonic() - rec.started
    lines = [f"[ray_tpu_torch rpc-watchdog] RPC {rec.op!r} {reason}: "
             f"age {age:.1f}s, {rec.attempts} attempt(s), "
             f"mode={rec.mode}"]
    frame = sys._current_frames().get(getattr(rec, "thread_id", None) or -1)
    if frame is not None:
        lines.append("".join(traceback.format_stack(frame)))
    sys.stderr.write("\n".join(lines) + "\n")
