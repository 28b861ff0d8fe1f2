"""SampleStream: the asynchronous rollout plane (a copy of
``ray_tpu/rllib/evaluation/sample_stream.py``, on the port's runtime,
flow window, metrics and profiling spans).

The lockstep actor path (``WorkerSet.sample_sync``) is a barrier loop:
every worker samples, the learner trains while all rollout actors sit
idle, then a blocking weight sync gates the next round.  The Podracer /
Sebulba architecture (arXiv:2104.06272) decouples the two sides so
neither ever waits on the other; this module is that plane for the CPU
rollout actors:

- **Streaming production** — every worker holds up to
  ``max_in_flight_per_worker`` queued ``sample_fragment`` calls (a
  per-worker :class:`~ray_tpu_torch.parallel.flow.Window`, the shared
  bounded-window backpressure primitive under the mesh StepPipeline and
  the whole dataflow substrate).
  The actor mailbox is FIFO, so a worker finishes one fragment and rolls
  straight into the next with no driver round trip in between; the
  learner consumes fragments as they land via :meth:`next_fragment`,
  the oldest dispatch among the ready ones first (the JAX package takes
  the first ready in worker order, which starves every worker but the
  first while that one keeps up).
- **Versioned weight broadcast** — :meth:`publish_weights` performs ONE
  object-store put per version (riding the batched object plane;
  N workers borrow one ref) and fire-and-forget ``set_weights`` sends.
  Workers apply the newest version at their next fragment boundary and
  stamp every fragment with the version it acted under.
- **Bounded staleness** — fragments produced under weights older than
  ``max_weight_staleness`` versions are dropped before the learner sees
  them (counted in ``rollout_fragments_dropped_stale``).  PPO stays
  correct off-policy through its ``action_logp`` importance ratios;
  IMPALA's V-trace absorbs the staleness natively.
- **Dead-worker tolerance** — a failed fragment future feeds the
  WorkerSet's existing ``_count_failure``/restore path (strike counting,
  actor replacement, weight re-seed from the current version's ref); the
  dead handle's queued fragments are abandoned, never delivered, so
  episode returns are counted at most once (docs/FAULT_TOLERANCE.md).

Observability: ``rollout_fragments_total`` / ``rollout_steps_total``
(Meters — locally aggregated, no per-fragment KV round trip),
``rollout_queue_depth`` gauge, ``rollout_weight_version_lag`` histogram,
``rollout_worker_idle_frac`` gauge, plus ``rollout_wait`` /
``rollout_publish_weights`` profiling spans.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, NamedTuple, Optional

import ray_tpu_torch
from ray_tpu_torch import observability as obs
from ray_tpu_torch._private import profiling
from ray_tpu_torch.parallel.flow import CancellationToken, Window
from ray_tpu_torch.util.metrics import Gauge, Histogram, Meter


class Fragment(NamedTuple):
    """One consumed rollout fragment."""

    worker_index: int
    batch: Any                     # SampleBatch (gae) or time-major dict
    episode_returns: List[float]
    weights_version: int           # version the fragment was acted under
    env_steps: int
    info: Dict[str, Any]           # produce_start/end, idle_s, busy_s


class _Pending(NamedTuple):
    future: Any
    worker: Any                    # handle at dispatch time
    worker_index: int
    dispatched_at: float


def _stream_metrics():
    """Lazy metric handles (internal_kv needs a connected driver)."""
    return {
        "fragments": Meter("rollout_fragments_total",
                           "rollout fragments consumed by the learner"),
        "steps": Meter("rollout_steps_total",
                       "env steps consumed through the rollout plane"),
        "stale": Meter("rollout_fragments_dropped_stale",
                       "fragments dropped by the weight-staleness bound"),
        "depth": Gauge("rollout_queue_depth",
                       "fragment futures in flight across all workers"),
        "idle": Gauge("rollout_worker_idle_frac",
                      "fraction of worker wall time spent not sampling"),
        "lag": Histogram("rollout_weight_version_lag",
                         "published version minus consumed fragment's "
                         "version", boundaries=(0.5, 1.5, 2.5, 4.5, 8.5)),
    }


class SampleStream:
    """Bounded streaming fragment consumer over a WorkerSet.

    ``kind`` selects the fragment shape (``"gae"`` for PPO's flat
    SampleBatch with advantages, ``"timemajor"`` for IMPALA's V-trace
    tensors).  Call :meth:`publish_weights` once before the first
    :meth:`next_fragment` so every worker has version >= 1 weights before
    any sample dispatch.

    Not thread-safe: one consumer thread owns a stream."""

    def __init__(self, workers, kind: str = "gae",
                 max_in_flight_per_worker: int = 2,
                 max_weight_staleness: Optional[int] = None):
        if max_in_flight_per_worker < 1:
            raise ValueError("max_in_flight_per_worker must be >= 1, got "
                             f"{max_in_flight_per_worker}")
        self.workers = workers
        self.kind = kind
        self.depth = int(max_in_flight_per_worker)
        self.max_weight_staleness = max_weight_staleness
        self._windows: Dict[int, Window] = {
            i: Window(self.depth)
            for i in range(len(workers.workers))
        }
        # One flow cancellation token governs the stream's lifetime: the
        # owner (or a supervisor's restart hook) cancels it once and every
        # in-flight window drains (docs/FAULT_TOLERANCE.md).
        self.token = CancellationToken()
        self.token.on_cancel(self._drop_all_windows)
        # --- stats (driver-local; stats() snapshots them) ---
        self._t0 = time.monotonic()
        self.fragments_consumed = 0
        self.steps_consumed = 0
        self.stale_dropped = 0
        self.failures_seen = 0
        self._lag_sum = 0
        self._lag_max = 0
        self._lag_hist: Dict[int, int] = {}
        self._idle_s = 0.0
        self._busy_s = 0.0
        self._wait_s = 0.0
        try:
            self._metrics = _stream_metrics()
        except Exception:
            self._metrics = None
        # One distributed trace per stream lifetime: every fragment
        # dispatch and rollout_* span joins it, so a whole rollout run
        # assembles into a single cross-process timeline.
        self.trace_ctx = None
        try:
            if obs.enabled():
                self.trace_ctx = obs.get_context() or obs.mint_context()
        except Exception:
            pass

    # ---- weights ---------------------------------------------------------
    @property
    def weights_version(self) -> int:
        return self.workers.weights_version

    def publish_weights(self, params) -> int:
        """One put per version + async fan-out (see module docstring)."""
        t0 = time.perf_counter()
        version = self.workers.broadcast_weights_async(params)
        profiling.record_span("rollout_publish_weights", t0,
                              time.perf_counter(), version=version,
                              _trace_ctx=self.trace_ctx)
        return version

    # ---- production ------------------------------------------------------
    def _refill(self) -> None:
        """Top every healthy worker's window up to the in-flight cap."""
        ctx = None
        if self.trace_ctx is not None:
            ctx = obs.use_context(self.trace_ctx)
            ctx.__enter__()
        try:
            for i, w in enumerate(self.workers.workers):
                win = self._windows[i]
                while not win.full:
                    fut = w.sample_fragment.remote(self.kind)
                    win.append(_Pending(fut, w, i, time.monotonic()))
        finally:
            if ctx is not None:
                ctx.__exit__(None, None, None)

    def _drop_window(self, i: int) -> None:
        """Abandon a dead handle's queued fragments: cancel what never
        started; results that do land are simply never consumed — the
        at-most-once episode-return accounting."""
        for p in self._windows[i].clear():
            try:
                ray_tpu_torch.cancel(p.future)
            except Exception:
                pass

    def _drop_all_windows(self) -> None:
        for i in list(self._windows):
            self._drop_window(i)

    @property
    def inflight(self) -> int:
        return sum(len(w) for w in self._windows.values())

    def next_fragment(self, timeout: Optional[float] = None
                      ) -> Optional[Fragment]:
        """Block until the next fragment lands (refilling windows so
        production never drains), apply the staleness gate, and return it.
        Returns None when ``timeout`` elapses with nothing consumable."""
        if self.token.cancelled:
            raise RuntimeError("SampleStream is closed")
        deadline = None if timeout is None else time.monotonic() + timeout
        t_wait0 = time.perf_counter()
        while True:
            self._refill()
            # Oldest dispatch first: ``wait`` returns the ready futures
            # in the order it is given them, so listing them window by
            # window would always hand back worker 0's fragment while it
            # keeps up, and starve the others (their fragments then age
            # past the staleness gate unseen).
            pendings = sorted((p for win in self._windows.values()
                               for p in win),
                              key=lambda p: p.dispatched_at)
            if not pendings:
                return None  # no workers at all
            ready, _ = ray_tpu_torch.wait([p.future for p in pendings],
                                          num_returns=1, timeout=1.0)
            if not ready:
                if deadline is not None and time.monotonic() > deadline:
                    return None
                continue
            fut = ready[0]
            pend = next(p for p in pendings if p.future is fut)
            win = self._windows[pend.worker_index]
            try:
                win.remove(pend)
            except ValueError:
                continue  # window was dropped by a concurrent failure
            try:
                batch, completed, info = ray_tpu_torch.get(fut)
            except ray_tpu_torch.exceptions.RayTpuError:
                # Feed the existing FT manager (strike counting, actor
                # replacement past the budget, weight restore), abandon
                # the dead handle's window, and keep streaming.  This
                # includes RpcTimeoutError: a worker whose RPC edge blew
                # its deadline is treated exactly like a dead worker —
                # struck and replaced — instead of stalling the stream
                # waiting on a reply that may never come.
                self.failures_seen += 1
                self._drop_window(pend.worker_index)
                self.workers.report_failure_index(pend.worker_index)
                continue
            version = int(info.get("weights_version", 0))
            lag = self.weights_version - version
            self._idle_s += float(info.get("idle_s", 0.0))
            self._busy_s += float(info.get("busy_s", 0.0))
            if self.max_weight_staleness is not None and \
                    lag > self.max_weight_staleness:
                self.stale_dropped += 1
                if self._metrics is not None:
                    try:
                        self._metrics["stale"].mark()
                    except Exception:
                        pass
                continue  # refilled next loop; newer weights are queued
            t1 = time.perf_counter()
            self._wait_s += t1 - t_wait0
            profiling.record_span("rollout_wait", t_wait0, t1,
                                  worker=pend.worker_index, lag=lag,
                                  _trace_ctx=self.trace_ctx)
            steps = int(info.get("env_steps", 0))
            self.fragments_consumed += 1
            self.steps_consumed += steps
            self._lag_sum += max(0, lag)
            self._lag_max = max(self._lag_max, lag)
            self._lag_hist[lag] = self._lag_hist.get(lag, 0) + 1
            if self._metrics is not None:
                try:
                    self._metrics["fragments"].mark()
                    self._metrics["steps"].mark(steps)
                    self._metrics["depth"].set(float(self.inflight))
                    self._metrics["lag"].observe(float(lag))
                    self._metrics["idle"].set(self.worker_idle_frac())
                except Exception:
                    pass
            return Fragment(pend.worker_index, batch, completed, version,
                            steps, info)

    # ---- observability ---------------------------------------------------
    def worker_idle_frac(self) -> float:
        total = self._idle_s + self._busy_s
        return self._idle_s / total if total > 0 else 0.0

    def stats(self) -> Dict[str, Any]:
        dt = time.monotonic() - self._t0
        n = max(1, self.fragments_consumed)
        return {
            "fragments_consumed": self.fragments_consumed,
            "steps_consumed": self.steps_consumed,
            "fragments_per_s": self.fragments_consumed / dt if dt else 0.0,
            "steps_per_s": self.steps_consumed / dt if dt else 0.0,
            "stale_dropped": self.stale_dropped,
            "failures_seen": self.failures_seen,
            "weights_version": self.weights_version,
            "weight_lag_mean": self._lag_sum / n,
            "weight_lag_max": self._lag_max,
            "weight_lag_hist": dict(sorted(self._lag_hist.items())),
            "worker_idle_frac": self.worker_idle_frac(),
            "driver_wait_s": self._wait_s,
            "inflight": self.inflight,
        }

    def close(self) -> None:
        """Abandon all in-flight fragments (the workers' queued fragments
        finish and are garbage-collected unseen).  One token cancel — the
        window drop rides the flow token's on_cancel hook."""
        if self.token.cancelled:
            return
        self.token.cancel()
        if self._metrics is not None:
            for m in self._metrics.values():
                flush = getattr(m, "flush", None)
                if flush is not None:
                    try:
                        flush()
                    except Exception:
                        pass

    def __enter__(self) -> "SampleStream":
        return self

    def __exit__(self, exc_type, exc_val, tb) -> None:
        self.close()
