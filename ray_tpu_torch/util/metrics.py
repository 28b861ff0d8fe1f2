"""User metrics API (reference: python/ray/util/metrics.py Counter/Gauge/
Histogram on the C++ OpenCensus pipeline).  Here metrics aggregate in the
GCS KV under the "metrics" namespace; a Prometheus text endpoint can read
them out (dashboard round-2).

Copied from ``ray_tpu/util/metrics.py`` (the JAX package).
"""
from __future__ import annotations

import pickle
from typing import Dict, Optional, Sequence, Tuple

from ray_tpu_torch import internal_kv

_NS = "metrics"


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, description: str = "",
                 tag_keys: Sequence[str] = ()):
        self.name = name
        self.description = description
        self.tag_keys = tuple(tag_keys)
        self._default_tags: Dict[str, str] = {}

    def set_default_tags(self, tags: Dict[str, str]):
        self._default_tags = dict(tags)
        return self

    def _key(self, tags: Optional[Dict[str, str]]) -> bytes:
        merged = {**self._default_tags, **(tags or {})}
        tag_str = ",".join(f"{k}={merged[k]}" for k in sorted(merged))
        return f"{self.name}|{tag_str}".encode()

    def _load(self, tags) -> float:
        raw = internal_kv.kv_get(self._key(tags), namespace=_NS)
        return pickle.loads(raw) if raw else 0.0

    def _store(self, tags, value):
        internal_kv.kv_put(self._key(tags), pickle.dumps(value), namespace=_NS)

    def value(self, tags: Optional[Dict[str, str]] = None):
        """Read the current recorded value for a tag set (0.0 when never
        recorded; a bucket-count list for Histogram).  Used by supervisors
        and tests to assert on counters, e.g. mesh_group_restarts_total."""
        return self._load(tags)


class Counter(_Metric):
    kind = "counter"

    def inc(self, value: float = 1.0, tags: Optional[Dict[str, str]] = None):
        self._store(tags, self._load(tags) + value)


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, tags: Optional[Dict[str, str]] = None):
        self._store(tags, float(value))


class Meter(_Metric):
    """Counter for hot paths: ``mark()`` is pure in-process arithmetic and
    the GCS-KV write happens at most once per ``flush_interval`` seconds.
    A plain Counter pays one internal_kv round trip per inc(), which a
    per-fragment or per-step path cannot afford; a Meter amortizes that to
    ~0 while still surfacing through prometheus_text().  ``rate()`` reads
    the local events/second since creation (no kv traffic)."""

    kind = "meter"

    def __init__(self, name: str, description: str = "",
                 flush_interval: float = 2.0, tag_keys: Sequence[str] = ()):
        super().__init__(name, description, tag_keys)
        import time

        self.flush_interval = flush_interval
        self._pending = 0.0
        self._total = 0.0
        self._t0 = time.monotonic()
        self._last_flush = self._t0

    def mark(self, value: float = 1.0,
             tags: Optional[Dict[str, str]] = None):
        import time

        self._pending += value
        self._total += value
        now = time.monotonic()
        if now - self._last_flush >= self.flush_interval:
            self.flush(tags)

    def flush(self, tags: Optional[Dict[str, str]] = None):
        import time

        if self._pending:
            try:
                self._store(tags, self._load(tags) + self._pending)
                self._pending = 0.0
            except Exception:
                pass  # kv unavailable (driver shutting down): keep local
        self._last_flush = time.monotonic()

    def total(self) -> float:
        """Locally-observed total (includes unflushed marks)."""
        return self._total

    def rate(self) -> float:
        import time

        dt = time.monotonic() - self._t0
        return self._total / dt if dt > 0 else 0.0


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name: str, description: str = "",
                 boundaries: Sequence[float] = (), tag_keys: Sequence[str] = ()):
        super().__init__(name, description, tag_keys)
        self.boundaries = tuple(boundaries)

    def observe(self, value: float, tags: Optional[Dict[str, str]] = None):
        raw = internal_kv.kv_get(self._key(tags), namespace=_NS)
        counts = pickle.loads(raw) if raw else [0] * (len(self.boundaries) + 1)
        import bisect

        counts[bisect.bisect_left(self.boundaries, value)] += 1
        internal_kv.kv_put(self._key(tags), pickle.dumps(counts), namespace=_NS)


def prometheus_text() -> str:
    """Render all recorded metrics in Prometheus exposition format."""
    lines = []
    for key in internal_kv.kv_keys(b"", namespace=_NS):
        raw = internal_kv.kv_get(key, namespace=_NS)
        value = pickle.loads(raw)
        name, _, tag_str = key.decode().partition("|")
        labels = "{%s}" % ",".join(
            f'{p.split("=")[0]}="{p.split("=")[1]}"'
            for p in tag_str.split(",") if p) if tag_str else ""
        if isinstance(value, list):
            lines.append(f"{name}_count{labels} {sum(value)}")
        else:
            lines.append(f"{name}{labels} {value}")
    return "\n".join(lines) + "\n"
