"""@serve.batch — adaptive request batching inside a replica (copy of
``ray_tpu/serve/batching.py``).

Reference: python/ray/serve/batching.py (@serve.batch collects concurrent
calls into one invocation of the underlying function): a replica hosting
a model on the card turns N concurrent single requests into ONE batched
device call, the only way the card sees a real batch dimension from a
request/response workload.

Mechanics: requests enqueue (item, Future) and block on the future; the
batcher is ONE ``flow.Stage(sink=True)`` over a batch-assembly source —
the source generator drains the queue (first item blocking, then up to
max_batch_size or until batch_wait_timeout_s passes) and yields batches,
the stage worker calls the wrapped function once per batch and resolves
each item's future.  Thread lifecycle, cancellation and join-on-close
come from ``ray_tpu_torch.parallel.flow``.

Failure semantics: an exception from the batched handler is ISOLATED —
each item of the failed batch is retried alone, so only the item whose
handler actually raises sees the exception; its batchmates still get
results (at the cost of re-running their handler calls, so batched
handlers should be idempotent per item).  ``close()`` stops the batcher
stage and wakes queued submitters with a typed
:class:`~ray_tpu_torch.exceptions.BatcherClosedError` — deployment teardown and
``serve.shutdown()`` drain every batcher instead of leaking daemon
threads and permanently-blocked callers.
"""
from __future__ import annotations

import functools
import queue
import threading
import weakref
from concurrent.futures import Future
from typing import Any, Callable, List, Optional

from ray_tpu_torch.exceptions import BatcherClosedError

_CLOSE = object()  # queue sentinel: wake the assembly source for shutdown

# Every live batcher in this process, so teardown paths (serve.shutdown,
# replica drain) can close them without holding the decorated objects.
_BATCHERS: "weakref.WeakSet" = weakref.WeakSet()


class _Batcher:
    def __init__(self, fn: Callable[[List[Any]], List[Any]],
                 max_batch_size: int, batch_wait_timeout_s: float):
        self.fn = fn
        self.max_batch_size = max_batch_size
        self.batch_wait_timeout_s = batch_wait_timeout_s
        self._queue: "queue.Queue" = queue.Queue()
        self._stage: Optional[Any] = None  # flow.Stage (lazy import)
        self._lock = threading.Lock()
        self._closed = False
        _BATCHERS.add(self)

    def _ensure_stage(self):
        from ray_tpu_torch.parallel import flow

        with self._lock:
            if self._closed:
                raise BatcherClosedError(
                    f"batcher for {getattr(self.fn, '__name__', self.fn)!r} "
                    f"is closed")
            if self._stage is None:
                self._stage = flow.Stage(
                    self._batch_source(), self._dispatch, workers=1,
                    depth=1, sink=True, name="serve-batch",
                    export_metrics=False)

    def submit(self, item) -> Any:
        fut: Future = Future()
        self._ensure_stage()
        self._queue.put((item, fut))
        if self._closed:
            # close() raced our put: its drain may already have run, so
            # this future could block forever — fail it here (idempotent
            # if the drain got it first).
            if not fut.done():
                fut.set_exception(BatcherClosedError("batcher closed"))
        return fut.result()

    def _batch_source(self):
        """Batch-assembly source for the sink stage: block for the first
        item, then fill up to max_batch_size or the wait deadline.  The
        _CLOSE sentinel ends the stream (a mid-assembly close still
        yields the partial batch so its callers get results)."""
        import time

        while True:
            item, fut = self._queue.get()
            if item is _CLOSE:
                return
            if self._closed:
                # Drain mode: everything queued at close time is failed,
                # not run — callers wake with the typed error.
                if fut is not None and not fut.done():
                    fut.set_exception(BatcherClosedError(
                        "batcher closed before this request ran"))
                continue
            batch = [(item, fut)]
            deadline = time.monotonic() + self.batch_wait_timeout_s
            closing = False
            while len(batch) < self.max_batch_size:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt[0] is _CLOSE:
                    closing = True
                    break
                batch.append(nxt)
            yield batch
            if closing:
                return

    def close(self, timeout: float = 5.0):
        """Stop the batcher stage and fail queued submitters with a
        typed error.  The batch currently executing finishes and its
        callers get their results."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            stage = self._stage
        self._queue.put((_CLOSE, None))
        if stage is not None:
            # Joins the worker thread (the in-flight dispatch completes;
            # the _CLOSE above wakes a source parked on an empty queue).
            stage.close()
        err = BatcherClosedError(
            f"batcher for {getattr(self.fn, '__name__', self.fn)!r} was "
            f"closed before this request ran")
        while True:
            try:
                item, fut = self._queue.get_nowait()
            except queue.Empty:
                return
            if fut is not None and not fut.done():
                fut.set_exception(err)

    def _dispatch(self, batch):
        items = [b[0] for b in batch]
        try:
            results = self.fn(items)
            if results is None or len(results) != len(items):
                raise ValueError(
                    f"@serve.batch function must return one result per "
                    f"input ({len(items)} in, "
                    f"{None if results is None else len(results)} out)")
            for (_, f), r in zip(batch, results):
                f.set_result(r)
        except BaseException as e:  # noqa: BLE001 — delivered to callers
            if len(batch) == 1:
                _, f = batch[0]
                if not f.done():
                    f.set_exception(e)
                return
            # Isolate the offender: one poisoned item must not fail its
            # batchmates.  Re-run each item alone; whoever raises gets
            # their own exception, everyone else a result.
            for it, f in batch:
                if f.done():
                    continue
                try:
                    r = self.fn([it])
                    if r is None or len(r) != 1:
                        raise ValueError(
                            "@serve.batch function must return one result "
                            "per input")
                    f.set_result(r[0])
                except BaseException as ee:  # noqa: BLE001
                    f.set_exception(ee)


def shutdown_batchers():
    """Close every live batcher in this process (serve.shutdown)."""
    for b in list(_BATCHERS):
        try:
            b.close()
        except Exception:
            pass


def close_instance_batchers(obj):
    """Close the per-instance batchers installed on ``obj`` by the method
    form of @serve.batch (replica teardown)."""
    for name, val in list(vars(obj).items()):
        if name.startswith("__rtpu_batcher_") and isinstance(val, _Batcher):
            try:
                val.close()
            except Exception:
                pass


class _BatchDescriptor:
    """Function/method wrapper installing per-instance batchers."""

    def __init__(self, fn, max_batch_size: int, batch_wait_timeout_s: float):
        self._fn = fn
        self._max = max_batch_size
        self._wait = batch_wait_timeout_s
        self._free_batcher: Optional[_Batcher] = None
        functools.update_wrapper(self, fn)

    # plain-function use
    def __call__(self, item):
        if self._free_batcher is None or self._free_batcher._closed:
            self._free_batcher = _Batcher(self._fn, self._max, self._wait)
        return self._free_batcher.submit(item)

    # method use: one batcher per instance, created on first access
    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        attr = "__rtpu_batcher_" + self._fn.__name__
        batcher = getattr(obj, attr, None)
        if batcher is None or batcher._closed:
            bound = self._fn.__get__(obj, objtype)
            batcher = _Batcher(bound, self._max, self._wait)
            try:
                object.__setattr__(obj, attr, batcher)
            except AttributeError:
                pass  # __slots__: fall back to a fresh batcher per access

        def call(item):
            return batcher.submit(item)

        functools.update_wrapper(call, self._fn)
        return call


def batch(_func=None, *, max_batch_size: int = 8,
          batch_wait_timeout_s: float = 0.01):
    """Decorator: fn(list_of_items) -> list_of_results, called with
    auto-collected batches of concurrent single-item requests."""

    def deco(fn):
        return _BatchDescriptor(fn, max_batch_size, batch_wait_timeout_s)

    if _func is not None:
        return deco(_func)
    return deco
