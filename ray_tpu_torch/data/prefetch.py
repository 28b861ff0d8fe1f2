"""Background host→device prefetch: the Data→Train ingest hot path
(counterpart of ``ray_tpu/data/prefetch.py``).

:class:`DevicePrefetcher` moves the producer side — block fetch, batch
slicing, the host-to-device copy — onto a background thread feeding a
bounded queue of device-resident batches, double-buffered by default so
the copy of batch N+1..N+prefetch overlaps the consumer's compute on
batch N (reference analogue: iter_torch_batches' pin_memory+prefetch
worker, python/ray/data/dataset_iterator.py; the Podracer "keep the
device fed" rule, arXiv:2104.06272).  It is a thin wrapper over one
:class:`ray_tpu_torch.parallel.flow.Stage`: the bounded queue, producer
thread, error propagation and close/drain semantics come from flow; only
the placement lives here.

Placement, where the reference calls ``jax.device_put``:

- on the CPU, each numpy array becomes a tensor over the same memory
  (``torch.from_numpy``; an array the object store mapped read-only is
  copied first, since a tensor has no read-only flag);
- on CUDA, the producer copies each array into pinned host memory and
  issues its copy ``non_blocking`` on a side CUDA stream of its own, then
  records an event there.  The consumer's stream waits on that event
  before the batch is used, and each tensor is marked with
  ``record_stream`` on the consumer's stream, so that the caching
  allocator does not reuse its memory while the step still reads it.
  PyTorch's pinned-memory allocator keeps each pinned buffer until the
  copy that reads it has finished.

Contract (as the reference's):

- ``prefetch=0`` places inline — no thread, the consumer pays the copy.
- Producer-thread exceptions propagate to the consumer at the point of
  ``next()`` (original traceback preserved), never silently truncate the
  stream.
- ``close()`` (also called by ``__del__``) stops and joins the producer
  thread deterministically — no leaked threads, even when the producer
  is blocked on a full queue.
- Queue occupancy and batch counts export through
  ray_tpu_torch.util.metrics (``data_prefetch_*`` and the substrate's
  tagged ``flow_*`` series; best-effort, skipped where no driver is
  connected) and per-batch spans land in the
  ray_tpu_torch._private.profiling span recorder as ``prefetch_h2d``.

Copied from ``ray_tpu/data/prefetch.py`` (the JAX package), with the
placement above in place of ``jax.device_put``.
"""
from __future__ import annotations

from typing import Any, Iterable, Iterator


def _map_arrays(fn, batch):
    """Apply ``fn`` to every numpy array of a batch (nested dicts, lists
    and tuples of arrays)."""
    if isinstance(batch, dict):
        return {k: _map_arrays(fn, v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(_map_arrays(fn, v) for v in batch)
    return fn(batch)


def _host_tensor(array):
    import numpy as np
    import torch

    array = np.asarray(array)
    return torch.from_numpy(array if array.flags.writeable else array.copy())


class _CudaPlacer:
    """Pinned host copy, then a non-blocking copy on a side stream; the
    event recorded after it travels with the batch."""

    def __init__(self, device):
        import torch

        self.device = device
        self.stream = torch.cuda.Stream(device)

    def __call__(self, batch):
        import torch

        def to_device(array):
            pinned = _host_tensor(array).pin_memory()
            return pinned.to(self.device, non_blocking=True)

        with torch.cuda.stream(self.stream):
            out = _map_arrays(to_device, batch)
            event = torch.cuda.Event()
            event.record(self.stream)
        return out, event

    def ready(self, placed):
        """On the consumer's thread: make its current stream wait for the
        copy, and tie each tensor's memory to that stream."""
        import torch

        batch, event = placed
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(event)

        def mark(t):
            t.record_stream(stream)
            return t

        return _map_arrays(mark, batch)


class DevicePrefetcher(Iterator[Any]):
    """Iterator of device-resident batches with background transfer.

    ``host_batches``: any iterable of host batches (dicts of numpy
    arrays, possibly nested).  ``device``: where the batches go (None:
    CUDA, which raises where there is none).  ``prefetch``: bounded queue
    size (device batches materialized ahead of the consumer); 0 = inline.
    """

    def __init__(self, host_batches: Iterable[Any], device=None,
                 prefetch: int = 2, name: str = "device-prefetch"):
        from ray_tpu_torch._device import resolve_device
        from ray_tpu_torch.parallel.flow import Stage

        self.prefetch = int(prefetch)
        self._ready = None
        device = resolve_device(device)
        if device.type == "cuda":
            place_fn = _CudaPlacer(device)
            self._ready = place_fn.ready
        else:
            place_fn = lambda b: _map_arrays(_host_tensor, b)  # noqa: E731
        self._stage = Stage(
            host_batches, place_fn,
            depth=max(1, self.prefetch),
            workers=1 if self.prefetch > 0 else 0,
            name=name, span="prefetch_h2d",
            # flow's throttled export is kept; the data_prefetch_* names
            # are exported once at end-of-stream/close below.
            export_metrics=True)
        self._exported = False

    # ---- consumer side ----
    def __iter__(self) -> "DevicePrefetcher":
        return self

    def __next__(self):
        try:
            placed = next(self._stage)
        except BaseException:
            self._export_metrics()
            raise
        return placed if self._ready is None else self._ready(placed)

    # ---- lifecycle ----
    def close(self):
        """Stop the producer and join its thread.  Idempotent; safe to
        call mid-stream (pending device batches are dropped)."""
        self._stage.close()
        self._export_metrics()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __enter__(self) -> "DevicePrefetcher":
        return self

    def __exit__(self, exc_type, exc_val, tb):
        self.close()

    # ---- observability ----
    @property
    def _thread(self):
        """The producer thread (None once joined / in inline mode) —
        tests assert its lifecycle."""
        threads = self._stage.worker_threads
        return threads[0] if threads else None

    @property
    def peak_occupancy(self) -> int:
        return self._stage.peak_occupancy

    @property
    def batches_delivered(self) -> int:
        return self._stage.items_delivered

    def _export_metrics(self):
        if self._exported:
            return
        self._exported = True
        try:
            from ray_tpu_torch.util.metrics import Counter, Gauge

            Counter("data_prefetch_batches_total",
                    "device batches delivered by the prefetch queue"
                    ).inc(self.batches_delivered)
            Gauge("data_prefetch_queue_peak",
                  "peak occupancy of the device prefetch queue"
                  ).set(float(self.peak_occupancy))
        except Exception:
            pass  # no connected driver (e.g. bare worker process)

