"""One async dataflow substrate: bounded pipelined stages.

This repo re-derived the same bounded-in-flight / backpressure / drain
pattern six times by hand — ``mesh_group.InflightWindow``/``StepPipeline``,
``SampleStream`` (rllib/evaluation), ``DevicePrefetcher`` (data/prefetch),
``AsyncCommitter`` (checkpoint/coordinator), the MPMD step window, and the
serving admission loop.  This module is the extraction (the Ray dataflow
thesis, arXiv:1712.05889 §3, and Podracer's actor/learner decoupling,
arXiv:2104.06272): a small operator core every "more in flight" feature
composes from, instead of growing a new subsystem.

Three primitives, one contract each:

- :class:`Window` — the in-flight bookkeeping primitive (bounded deque of
  dispatched-but-undrained items).  Pure data structure, no threads; both
  the mesh StepPipeline and the rollout plane's per-worker fragment
  streams are built on it.
- :class:`Stage` — a bounded thread-chained transform over an item
  iterator: ``workers`` threads pull items from the source, apply ``fn``,
  and push results into a queue of at most ``depth`` items.  Backpressure
  is by construction (a full queue parks the workers; a stage never holds
  more than ``depth`` finished + ``workers`` in-progress items).  Fan-out
  is ``workers > 1``; fan-in ordering is selectable (``ordered=True``
  re-serializes results into source order through a bounded reorder
  buffer, ``ordered=False`` yields completion order).
- :class:`RefStream` — the same bound for driver-side ObjectRef chains: a
  lazy source of *submit thunks* is kept at most ``depth`` refs in flight;
  the driver only ever holds refs, so peak store residency is the window.

Shared semantics:

- **Typed error propagation** — a worker/source exception is delivered to
  the consumer at the failing item's position with its ORIGINAL type and
  traceback (``exc.flow_stage`` names the stage); errors are sticky, never
  silently truncated into StopIteration.
- **Cooperative cancellation / drain** — every operator carries a
  :class:`CancellationToken`.  ``close()`` cancels the token, unblocks
  producers parked on full queues, joins all worker threads (bounded), and
  releases in-flight refs; idempotent and safe from ``__del__``.
  Tokens nest (``child()``), so one ``cancel()`` at the root drains a
  whole pipeline — the gang-restart story (checkpoint AsyncCommitter,
  docs/FAULT_TOLERANCE.md).
- **Free observability** — per-stage ``flow_*`` metrics (items total,
  queue depth/peak, idle fraction, items/s; tagged ``stage=<name>``)
  export through ray_tpu_torch.util.metrics to the dashboard ``/metrics``
  endpoint (best-effort: skipped with no connected driver), and per-item
  profiling spans land in the ray_tpu_torch._private.profiling recorder.

Copied from ``ray_tpu/parallel/flow.py`` (the JAX package), without
its ``chain_stages``: no module of the port composes stages that way yet.
"""
from __future__ import annotations

import collections
import queue
import threading
import time
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional

__all__ = [
    "CancellationToken",
    "FlowCancelled",
    "Window",
    "Stage",
    "RefStream",
]


class FlowCancelled(RuntimeError):
    """Raised to a consumer blocked on a flow that was cancelled."""


class CancellationToken:
    """Cooperative cancellation shared down an operator chain.

    ``cancel()`` is one call and is final; workers poll ``cancelled`` (or
    block on ``wait``) at their loop edges.  ``on_cancel`` callbacks fire
    exactly once, on the cancelling thread.  ``child()`` derives a token
    that cancels with its parent but can also be cancelled alone — a
    pipeline cancels root-down, one stage can still drain solo.
    """

    def __init__(self, parent: Optional["CancellationToken"] = None):
        self._event = threading.Event()
        self._lock = threading.Lock()
        self._callbacks: List[Callable[[], None]] = []
        if parent is not None:
            parent.on_cancel(self.cancel)

    @property
    def cancelled(self) -> bool:
        return self._event.is_set()

    def cancel(self) -> None:
        with self._lock:
            if self._event.is_set():
                return
            self._event.set()
            callbacks, self._callbacks = self._callbacks, []
        for cb in callbacks:
            try:
                cb()
            except Exception:
                pass

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block up to ``timeout``; True iff the token is cancelled."""
        return self._event.wait(timeout)

    def on_cancel(self, cb: Callable[[], None]) -> None:
        """Register ``cb`` to run at cancel time (immediately if already
        cancelled)."""
        with self._lock:
            if not self._event.is_set():
                self._callbacks.append(cb)
                return
        cb()

    def child(self) -> "CancellationToken":
        return CancellationToken(parent=self)

    def raise_if_cancelled(self) -> None:
        if self._event.is_set():
            raise FlowCancelled("flow cancelled")


class Window:
    """Bounded window of dispatched-but-undrained work — the backpressure
    primitive under the mesh step pipeline, the MPMD microbatch window and
    the rollout plane's per-worker fragment streams: items append at
    dispatch, ``over_depth`` tells the owner to drain the oldest before
    dispatching more, so the producer side always holds queued work while
    the consumer touches a result."""

    __slots__ = ("depth", "_items")

    def __init__(self, depth: int):
        if depth < 1:
            raise ValueError(f"window depth must be >= 1, got {depth}")
        self.depth = depth
        self._items: collections.deque = collections.deque()

    def append(self, item) -> None:
        self._items.append(item)

    def popleft(self):
        return self._items.popleft()

    def peek(self):
        return self._items[0]

    def remove(self, item) -> None:
        self._items.remove(item)

    def clear(self) -> list:
        out, self._items = list(self._items), collections.deque()
        return out

    @property
    def over_depth(self) -> bool:
        return len(self._items) > self.depth

    @property
    def full(self) -> bool:
        return len(self._items) >= self.depth

    def __len__(self) -> int:
        return len(self._items)

    def __iter__(self):
        return iter(self._items)

    def __bool__(self) -> bool:
        return bool(self._items)


# ---------------------------------------------------------------------------
# Stage: bounded thread-chained transform
# ---------------------------------------------------------------------------

class _End:
    """Producer→consumer end-of-stream sentinel (carries the seq count so
    an ordered consumer knows which gaps are real)."""
    __slots__ = ("seq",)

    def __init__(self, seq: int):
        self.seq = seq


class _Failure:
    """A worker/source exception, delivered at its item's position."""
    __slots__ = ("error",)

    def __init__(self, error: BaseException):
        self.error = error


def _bounded_put(q: "queue.Queue", token: CancellationToken, item) -> bool:
    """Bounded-queue put that aborts promptly on cancel — a producer must
    never be stranded on a full queue the consumer abandoned."""
    while not token.cancelled:
        try:
            q.put(item, timeout=0.1)
            return True
        except queue.Full:
            continue
    return False


class _StageCore:
    """All state shared with worker threads.  Deliberately separate from
    the user-facing Stage: a thread target referencing the Stage itself
    would keep it alive forever, so consumer-side GC could never trigger
    __del__/close and the threads would leak."""

    def __init__(self, name: str, fn, src, depth: int, workers: int,
                 token: CancellationToken, span: Optional[str],
                 sink: bool = False):
        self.name = name
        self.fn = fn
        self.src = src
        self.token = token
        self.span = span
        self.sink = sink
        # Trace context captured at construction (the creator's thread):
        # stage worker threads install it so their spans — and anything
        # they submit — join the creating trace instead of floating.
        self.trace_ctx = None
        try:
            from ray_tpu_torch import observability as obs

            if obs.enabled():
                self.trace_ctx = obs.get_context()
        except Exception:
            pass
        self.out_q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self.src_lock = threading.Lock()
        self.state_lock = threading.Lock()
        self.src_exhausted = False
        self.failed = False
        self.seq = 0
        self.workers_alive = workers
        # stats (updated under state_lock except monotonic counters)
        self.items_in = 0
        self.idle_s = 0.0
        self.busy_s = 0.0
        self.peak_queue = 0

    def close_src(self) -> None:
        close = getattr(self.src, "close", None)
        if close is not None:
            try:
                close()
            except Exception:
                pass


def _stage_worker(core: _StageCore) -> None:
    """Worker thread body (module-level on purpose — see _StageCore)."""
    from ray_tpu_torch._private import profiling

    if core.trace_ctx is not None:
        try:
            from ray_tpu_torch import observability as obs

            obs.set_context(core.trace_ctx)  # fresh thread: nothing saved
        except Exception:
            pass
    try:
        while not core.token.cancelled:
            t_wait0 = time.perf_counter()
            with core.src_lock:
                with core.state_lock:
                    if core.src_exhausted or core.failed:
                        return
                try:
                    item = next(core.src)
                except StopIteration:
                    with core.state_lock:
                        core.src_exhausted = True
                    return
                except BaseException as e:  # noqa: BLE001 — to consumer
                    with core.state_lock:
                        if core.failed:
                            return
                        core.failed = True
                        seq, core.seq = core.seq, core.seq + 1
                    _tag_stage(e, core.name)
                    _bounded_put(core.out_q, core.token, (seq, _Failure(e)))
                    return
                with core.state_lock:
                    seq, core.seq = core.seq, core.seq + 1
                    core.items_in += 1
            t0 = time.perf_counter()
            try:
                out = core.fn(item)
            except BaseException as e:  # noqa: BLE001 — to consumer
                with core.state_lock:
                    core.failed = True
                _tag_stage(e, core.name)
                _bounded_put(core.out_q, core.token, (seq, _Failure(e)))
                return
            t1 = time.perf_counter()
            with core.state_lock:
                core.idle_s += t0 - t_wait0
                core.busy_s += t1 - t0
            if core.span is not None:
                profiling.record_span(core.span, t0, t1, stage=core.name,
                                      seq=seq)
            if core.sink:
                continue  # results are fn's side effects; nothing queues
            with core.state_lock:
                core.peak_queue = max(core.peak_queue, core.out_q.qsize())
            if not _bounded_put(core.out_q, core.token, (seq, out)):
                return
    finally:
        with core.state_lock:
            core.workers_alive -= 1
            last = core.workers_alive == 0
            end_seq = core.seq
        if last:
            # The workers own the source: release its upstream resources
            # (threads, object refs) here, where it is not mid-pull.
            core.close_src()
            if not core.sink:
                _bounded_put(core.out_q, core.token, _End(end_seq))


def _tag_stage(exc: BaseException, name: str) -> None:
    try:
        exc.flow_stage = name
    except Exception:
        pass


class Stage(Iterator[Any]):
    """Bounded-in-flight transform over an item iterator.

    ``fn(item) -> out`` runs on ``workers`` background threads pulling
    from ``source``; results flow through a queue of at most ``depth``
    items.  ``ordered=True`` (default) re-serializes multi-worker results
    into source order; ``ordered=False`` yields them as they complete.
    ``workers=0`` degrades to a threadless inline transform (debugging /
    comparison baseline).  ``sink=True`` makes the stage terminal: ``fn``
    consumes items purely by side effect (resolving futures, writing
    files), nothing queues downstream and the stage is not iterable —
    the request/response shape (e.g. the serve batcher), where callers
    wait on futures ``fn`` resolves rather than pulling an iterator.
    Iterate to consume (non-sink); ``close()`` (also via ``with`` or GC)
    cancels, drains and joins every thread.

    The consumer side is single-threaded by contract (chained stages pull
    from each other under the downstream stage's source lock)."""

    def __init__(self, source: Iterable[Any], fn: Callable[[Any], Any],
                 *, depth: int = 2, workers: int = 1, ordered: bool = True,
                 sink: bool = False, name: str = "stage",
                 token: Optional[CancellationToken] = None,
                 span: Optional[str] = None, export_metrics: bool = True):
        if depth < 1:
            raise ValueError(f"stage depth must be >= 1, got {depth}")
        if workers < 0:
            raise ValueError(f"workers must be >= 0, got {workers}")
        if sink and workers < 1:
            raise ValueError("a sink stage needs at least one worker")
        self.name = name
        self.depth = int(depth)
        self.workers = int(workers)
        self.ordered = bool(ordered)
        self.sink = bool(sink)
        self.token = token if token is not None else CancellationToken()
        self._export = bool(export_metrics)
        self._core = _StageCore(name, fn, iter(source), depth,
                                max(1, workers), self.token,
                                span if span is not None else f"flow_{name}",
                                sink=self.sink)
        self._threads: List[threading.Thread] = []
        self._buffer: Dict[int, Any] = {}   # ordered-mode reorder buffer
        self._next_seq = 0
        self._end_seq: Optional[int] = None
        self._end: Optional[_Failure] = None  # sticky end: error or clean
        self._done = False
        self._consumed = 0
        self._t0 = time.monotonic()
        self._last_export = 0.0
        self._metrics = None
        if self.workers > 0:
            for i in range(self.workers):
                t = threading.Thread(target=_stage_worker,
                                     args=(self._core,), daemon=True,
                                     name=f"rtpu-flow-{name}-{i}")
                self._threads.append(t)
                t.start()

    # ---- consumer side ---------------------------------------------------
    def __iter__(self) -> "Stage":
        return self

    def __next__(self):
        if self.sink:
            raise TypeError(
                f"sink stage {self.name!r} is not iterable — its fn "
                "consumes items by side effect; use close()/join")
        if self._done:
            self._raise_end()
        if self.workers == 0:
            return self._next_inline()
        while True:
            got = self._pop_buffered()
            if got is not None:
                return self._deliver(got)
            if self._end_seq is not None and self._next_seq >= self._end_seq:
                self._finish(None)
            if self._end_seq is not None and \
                    self._core.out_q.empty() and self._threads_dead():
                # Gap before end-of-stream with every worker exited: the
                # item was dropped by a cancelled put.  Treat as end —
                # never hang a consumer.
                self._finish(None)
            try:
                item = self._core.out_q.get(timeout=0.5)
            except queue.Empty:
                if self.token.cancelled and self._core.out_q.empty():
                    # Cancelled workers exit without an _End sentinel
                    # (their puts abort); surface the cancellation, not a
                    # bogus worker-death error.
                    self._finish(_Failure(FlowCancelled(
                        f"flow stage {self.name!r} cancelled")))
                if self._end_seq is None and self._threads_dead():
                    # Workers always enqueue _End in their finally, so
                    # this means a thread was killed hard.
                    self._finish(_Failure(RuntimeError(
                        f"flow stage {self.name!r} worker died")))
                continue
            if isinstance(item, _End):
                self._end_seq = item.seq
                if not self.ordered:
                    # FIFO queue: everything produced was put before _End,
                    # so an unordered consumer has already seen it all.
                    self._finish(None)
                continue
            seq, value = item
            if not self.ordered:
                if isinstance(value, _Failure):
                    self._finish(value)
                return self._deliver(value)
            self._buffer[seq] = value

    def _pop_buffered(self):
        if self.ordered and self._next_seq in self._buffer:
            value = self._buffer.pop(self._next_seq)
            self._next_seq += 1
            if isinstance(value, _Failure):
                self._finish(value)
            return value
        return None

    def _next_inline(self):
        try:
            item = next(self._core.src)
        except StopIteration:
            self._core.close_src()
            self._finish(None)
        except BaseException as e:  # noqa: BLE001
            _tag_stage(e, self.name)
            self._finish(_Failure(e))
        try:
            out = self._core.fn(item)
        except BaseException as e:  # noqa: BLE001
            _tag_stage(e, self.name)
            self._finish(_Failure(e))
        self._core.items_in += 1
        return self._deliver(out)

    def _deliver(self, value):
        self._consumed += 1
        self._maybe_export()
        return value

    def _threads_dead(self) -> bool:
        return bool(self._threads) and \
            not any(t.is_alive() for t in self._threads)

    def _finish(self, failure: Optional[_Failure]):
        """Record the sticky end state and raise it (never returns)."""
        self._done = True
        self._end = failure
        self._export_metrics(final=True)
        self._raise_end()

    def _raise_end(self):
        if self._end is not None:
            raise self._end.error
        raise StopIteration

    # ---- lifecycle -------------------------------------------------------
    def close(self) -> None:
        """Cancel, unblock producers parked on the full queue, join all
        worker threads, release the source.  Idempotent; safe mid-stream
        (pending results are dropped)."""
        self.token.cancel()
        while True:  # unblock producers waiting on a full queue
            try:
                self._core.out_q.get_nowait()
            except queue.Empty:
                break
        for t in self._threads:
            t.join(timeout=10.0)
        self._threads = []
        self._buffer.clear()
        # Release the source too (idempotent): closing the tail of a
        # chain drains the whole pipeline, joining upstream threads.
        self._core.close_src()
        if not self._done:
            self._done = True
            self._end = None
            self._export_metrics(final=True)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __enter__(self) -> "Stage":
        return self

    def __exit__(self, exc_type, exc_val, tb) -> None:
        self.close()

    # ---- observability ---------------------------------------------------
    @property
    def worker_threads(self) -> List[threading.Thread]:
        """Live worker threads (tests assert none leak past close)."""
        return list(self._threads)

    @property
    def peak_occupancy(self) -> int:
        return max(self._core.peak_queue, len(self._buffer))

    @property
    def items_delivered(self) -> int:
        return self._consumed

    def idle_frac(self) -> float:
        total = self._core.idle_s + self._core.busy_s
        return self._core.idle_s / total if total > 0 else 0.0

    def stats(self) -> Dict[str, Any]:
        dt = time.monotonic() - self._t0
        return {
            "stage": self.name,
            "depth": self.depth,
            "workers": self.workers,
            "items_in": self._core.items_in,
            "items_out": self._consumed,
            "queue_depth": self._core.out_q.qsize(),
            "queue_peak": self.peak_occupancy,
            "idle_frac": self.idle_frac(),
            "items_per_s": self._consumed / dt if dt > 0 else 0.0,
        }

    def _metric_handles(self):
        from ray_tpu_torch.util.metrics import Gauge, Meter

        handles = {
            "items": Meter("flow_items_total",
                           "items delivered by flow stages",
                           tag_keys=("stage",)),
            "depth": Gauge("flow_queue_depth",
                           "current occupancy of a flow stage's queue",
                           tag_keys=("stage",)),
            "peak": Gauge("flow_queue_peak",
                          "peak occupancy of a flow stage's queue",
                          tag_keys=("stage",)),
            "idle": Gauge("flow_idle_frac",
                          "fraction of stage worker time spent waiting "
                          "on upstream", tag_keys=("stage",)),
            "rate": Gauge("flow_items_per_s",
                          "delivered items per second of a flow stage",
                          tag_keys=("stage",)),
        }
        for h in handles.values():
            h.set_default_tags({"stage": self.name})
        return handles

    def _maybe_export(self):
        if not self._export:
            return
        now = time.monotonic()
        if now - self._last_export >= 2.0:
            self._export_metrics()

    def _export_metrics(self, final: bool = False):
        if not self._export:
            return
        self._last_export = time.monotonic()
        try:
            if self._metrics is None:
                self._metrics = self._metric_handles()
            m, st = self._metrics, self.stats()
            m["items"].mark(self._consumed - m["items"].total())
            if final:
                m["items"].flush({"stage": self.name})
            m["depth"].set(float(st["queue_depth"]))
            m["peak"].set(float(st["queue_peak"]))
            m["idle"].set(float(st["idle_frac"]))
            m["rate"].set(float(st["items_per_s"]))
        except Exception:
            self._metrics = None  # no connected driver: stay local


# ---------------------------------------------------------------------------
# RefStream: bounded in-flight ObjectRef window over a lazy submit source
# ---------------------------------------------------------------------------

class RefStream(Iterator[Any]):
    """Keep at most ``depth`` ObjectRefs in flight from a lazy source of
    submit thunks; yield refs in submission order.

    The driver never holds bytes: a thunk submits one remote task (or
    chain) and returns its output ref; the window bounds how many outputs
    can be store-resident at once (the consumer must drop each yielded
    ref once consumed — exactly the StreamingDataset contract).  No
    threads: submission is non-blocking, so a pull-driven fill is enough
    for full read→transform→consume overlap.

    ``close()`` releases every in-flight ref (best-effort
    ``ray_tpu_torch.cancel`` when ``cancel_refs=True``) — the drain story for
    gang restarts and dead consumers."""

    def __init__(self, thunks: Iterable[Callable[[], Any]], depth: int,
                 *, name: str = "refs",
                 token: Optional[CancellationToken] = None,
                 prime: Iterable[Any] = (), cancel_refs: bool = False,
                 export_metrics: bool = True):
        self.name = name
        self.token = token if token is not None else CancellationToken()
        self.cancel_refs = bool(cancel_refs)
        self._window = Window(depth)
        for ref in prime:
            self._window.append(ref)
        self._thunks = iter(thunks)
        self._exhausted = False
        self._closed = False
        self._export = bool(export_metrics)
        self._metrics = None
        self._t0 = time.monotonic()
        self._last_export = 0.0
        self.submitted = len(self._window)
        self.emitted = 0
        self.peak_in_flight = len(self._window)

    @property
    def depth(self) -> int:
        return self._window.depth

    def _fill(self) -> None:
        while not self._exhausted and not self._window.full:
            if self.token.cancelled:
                return
            try:
                thunk = next(self._thunks)
            except StopIteration:
                self._exhausted = True
                return
            self._window.append(thunk())
            self.submitted += 1
            self.peak_in_flight = max(self.peak_in_flight,
                                      len(self._window))

    def __iter__(self) -> "RefStream":
        return self

    def __next__(self):
        if self._closed:
            raise StopIteration
        self.token.raise_if_cancelled()
        self._fill()
        if not self._window:
            self._export_metrics(final=True)
            raise StopIteration
        ref = self._window.popleft()
        self.emitted += 1
        self._maybe_export()
        return ref

    def close(self) -> None:
        """Cancel and release all in-flight refs.  Idempotent."""
        if self._closed:
            return
        self._closed = True
        self.token.cancel()
        pending = self._window.clear()
        if self.cancel_refs and pending:
            import ray_tpu_torch

            for ref in pending:
                try:
                    ray_tpu_torch.cancel(ref)
                except Exception:
                    pass
        del pending
        self._export_metrics(final=True)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __enter__(self) -> "RefStream":
        return self

    def __exit__(self, exc_type, exc_val, tb) -> None:
        self.close()

    # ---- observability ---------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        dt = time.monotonic() - self._t0
        return {
            "stage": self.name,
            "depth": self.depth,
            "in_flight": len(self._window),
            "peak_in_flight": self.peak_in_flight,
            "submitted": self.submitted,
            "items_out": self.emitted,
            "items_per_s": self.emitted / dt if dt > 0 else 0.0,
        }

    def _maybe_export(self):
        if not self._export:
            return
        if time.monotonic() - self._last_export >= 2.0:
            self._export_metrics()

    def _export_metrics(self, final: bool = False):
        if not self._export:
            return
        self._last_export = time.monotonic()
        try:
            from ray_tpu_torch.util.metrics import Gauge, Meter

            if self._metrics is None:
                items = Meter("flow_items_total",
                              "items delivered by flow stages",
                              tag_keys=("stage",))
                depth = Gauge("flow_queue_depth",
                              "current occupancy of a flow stage's queue",
                              tag_keys=("stage",))
                peak = Gauge("flow_queue_peak",
                             "peak occupancy of a flow stage's queue",
                             tag_keys=("stage",))
                rate = Gauge("flow_items_per_s",
                             "delivered items per second of a flow stage",
                             tag_keys=("stage",))
                for h in (items, depth, peak, rate):
                    h.set_default_tags({"stage": self.name})
                self._metrics = {"items": items, "depth": depth,
                                 "peak": peak, "rate": rate}
            m, st = self._metrics, self.stats()
            m["items"].mark(self.emitted - m["items"].total())
            if final:
                m["items"].flush({"stage": self.name})
            m["depth"].set(float(st["in_flight"]))
            m["peak"].set(float(st["peak_in_flight"]))
            m["rate"].set(float(st["items_per_s"]))
        except Exception:
            self._metrics = None
