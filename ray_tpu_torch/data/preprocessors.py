"""Preprocessors (counterpart of ``ray_tpu/data/preprocessors.py``;
reference: python/ray/data/preprocessors/ — fit/transform over datasets,
attached to trainers via DatasetConfig).

``transform`` appends one numpy-format ``map_batches`` op, so it works on
a ``Dataset`` and a ``StreamingDataset`` alike.  Copied from the JAX
package as it is.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np


class Preprocessor:
    _fitted = False

    def fit(self, ds) -> "Preprocessor":
        self._fit(ds)
        self._fitted = True
        return self

    def transform(self, ds):
        return ds.map_batches(self._transform_numpy, batch_format="numpy")

    def fit_transform(self, ds):
        return self.fit(ds).transform(ds)

    def _fit(self, ds):
        pass

    def _transform_numpy(self, batch: Dict[str, np.ndarray]):
        raise NotImplementedError


class BatchMapper(Preprocessor):
    def __init__(self, fn: Callable[[Dict[str, np.ndarray]], Dict[str, np.ndarray]]):
        self.fn = fn

    def _transform_numpy(self, batch):
        return self.fn(batch)


class StandardScaler(Preprocessor):
    def __init__(self, columns: List[str]):
        self.columns = columns
        self.stats: Dict[str, tuple] = {}

    def _fit(self, ds):
        sums: Dict[str, float] = {c: 0.0 for c in self.columns}
        sqs: Dict[str, float] = {c: 0.0 for c in self.columns}
        n = 0
        for batch in ds.iter_batches(batch_format="numpy"):
            first = True
            for c in self.columns:
                v = batch[c].astype(np.float64)
                sums[c] += v.sum()
                sqs[c] += (v ** 2).sum()
                if first:
                    n += len(v)
                    first = False
        for c in self.columns:
            mean = sums[c] / max(n, 1)
            var = max(sqs[c] / max(n, 1) - mean ** 2, 1e-12)
            self.stats[c] = (mean, var ** 0.5)

    def _transform_numpy(self, batch):
        out = dict(batch)
        for c in self.columns:
            mean, std = self.stats[c]
            out[c] = (batch[c] - mean) / std
        return out
