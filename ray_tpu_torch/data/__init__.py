"""Distributed datasets of the port (counterpart of ``ray_tpu/data``;
reference: python/ray/data/).

Blocks are dicts of numpy columns (``data/block.py``), so the numpy,
CSV, JSON, text, binary and TFRecord formats, sort, groupby, the
shuffles and the streaming executor run where neither pyarrow, pandas
nor PIL is installed (the card's machine); the parquet and image formats
and the pandas and pyarrow batch formats import their package when used,
and raise an ImportError naming it where it is absent.
``iter_device_batches`` hands batches to the card through
``DevicePrefetcher``.
"""
from typing import Any, Dict, List, Union

import numpy as np

from ray_tpu_torch.data.dataset import Dataset  # noqa: F401
from ray_tpu_torch.data.datasource import register_datasource  # noqa: F401
from ray_tpu_torch.data.grouped import GroupedData  # noqa: F401
from ray_tpu_torch.data.prefetch import DevicePrefetcher  # noqa: F401
from ray_tpu_torch.data.preprocessors import (  # noqa: F401
    BatchMapper,
    Preprocessor,
    StandardScaler,
)
from ray_tpu_torch.data.streaming import StreamingDataset  # noqa: F401


def read_streaming(paths, fmt: str, columns=None, **kw) -> "StreamingDataset":
    """Bounded-memory streaming read (reference: the streaming executor
    path, data/_internal/execution/streaming_executor.py:31)."""
    return StreamingDataset.read(paths, fmt, columns, **kw)


def from_items(items: List[Any], parallelism: int = 8) -> Dataset:
    return Dataset.from_items(items, parallelism)


def range(n: int, parallelism: int = 8) -> Dataset:  # noqa: A001
    return Dataset.range(n, parallelism)


def from_numpy(arrays: Union[np.ndarray, Dict[str, np.ndarray]],
               parallelism: int = 8) -> Dataset:
    if isinstance(arrays, np.ndarray):
        arrays = {"data": arrays}
    return Dataset.from_numpy(arrays, parallelism)


def read_parquet(paths, columns=None) -> Dataset:
    return Dataset.read(paths, "parquet", columns)


def read_csv(paths) -> Dataset:
    return Dataset.read(paths, "csv")


def read_json(paths) -> Dataset:
    return Dataset.read(paths, "json")


def read_numpy(paths) -> Dataset:
    return Dataset.read(paths, "numpy")


def read_text(paths) -> Dataset:
    return Dataset.read(paths, "text")


def read_binary_files(paths) -> Dataset:
    return Dataset.read(paths, "binary")


def read_images(paths) -> Dataset:
    return Dataset.read(paths, "images")


def read_tfrecords(paths, columns=None) -> Dataset:
    return Dataset.read(paths, "tfrecord", columns)


def read_datasource(fmt: str, paths, columns=None) -> Dataset:
    """Read through a registered plugin format (register_datasource)."""
    return Dataset.read(paths, fmt, columns)
