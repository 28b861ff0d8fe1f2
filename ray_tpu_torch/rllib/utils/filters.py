"""Observation filters (reference: rllib/utils/filter.py — MeanStdFilter
with cross-worker sync via apply_changes/sync).

A copy of ``ray_tpu/rllib/utils/filters.py`` (numpy only), which the port
may not import."""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


class RunningStat:
    """Welford online mean/var, mergeable across workers."""

    def __init__(self, shape: Tuple[int, ...] = ()):
        self.n = 0
        self.mean = np.zeros(shape, np.float64)
        self.m2 = np.zeros(shape, np.float64)

    def push(self, x: np.ndarray):
        x = np.asarray(x, np.float64)
        self.n += 1
        delta = x - self.mean
        self.mean += delta / self.n
        self.m2 += delta * (x - self.mean)

    def merge(self, other: "RunningStat"):
        if other.n == 0:
            return
        n = self.n + other.n
        delta = other.mean - self.mean
        self.mean = self.mean + delta * other.n / n
        self.m2 = self.m2 + other.m2 + delta ** 2 * self.n * other.n / n
        self.n = n

    @property
    def var(self) -> np.ndarray:
        return self.m2 / self.n if self.n > 1 else np.ones_like(self.mean)

    @property
    def std(self) -> np.ndarray:
        return np.sqrt(np.maximum(self.var, 1e-12))

    def copy(self) -> "RunningStat":
        s = RunningStat(self.mean.shape)
        s.n, s.mean, s.m2 = self.n, self.mean.copy(), self.m2.copy()
        return s


class MeanStdFilter:
    def __init__(self, shape: Tuple[int, ...], demean: bool = True,
                 destd: bool = True, clip: Optional[float] = 10.0):
        self.shape = shape
        self.demean = demean
        self.destd = destd
        self.clip = clip
        self.stat = RunningStat(shape)
        self._delta = RunningStat(shape)  # changes since last sync

    def __call__(self, x: np.ndarray, update: bool = True) -> np.ndarray:
        x = np.asarray(x, np.float64)
        if update:
            if x.shape == self.shape:
                self.stat.push(x)
                self._delta.push(x)
            else:  # batched
                for row in x:
                    self.stat.push(row)
                    self._delta.push(row)
        out = x
        if self.demean:
            out = out - self.stat.mean
        if self.destd:
            out = out / self.stat.std
        if self.clip is not None:
            out = np.clip(out, -self.clip, self.clip)
        return out.astype(np.float32)

    # ---- cross-worker sync protocol (reference filter.py) ----
    def collect_delta(self) -> RunningStat:
        d, self._delta = self._delta, RunningStat(self.shape)
        return d

    def apply_delta(self, delta: RunningStat):
        self.stat.merge(delta)

    def sync(self, other: "MeanStdFilter"):
        self.stat = other.stat.copy()
