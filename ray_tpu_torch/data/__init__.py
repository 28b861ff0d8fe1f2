"""Distributed datasets of the port, the Data→Train ingest subset
(counterpart of ``ray_tpu/data``; reference: python/ray/data/).

``from_items``, ``range`` and ``from_numpy`` put blocks (dicts of numpy
columns) into the object store; ``Dataset`` maps, splits, counts and
iterates them, and ``iter_device_batches`` hands them to the card through
``DevicePrefetcher``.  The file readers, ``read_streaming`` and
``StreamingDataset``, grouping and the preprocessors raise, naming
ROADMAP Queue 1 item 1c.
"""
from typing import Any, Dict, List, Union

import numpy as np

from ray_tpu_torch.data.block import not_ported
from ray_tpu_torch.data.dataset import Dataset  # noqa: F401
from ray_tpu_torch.data.prefetch import DevicePrefetcher  # noqa: F401


def from_items(items: List[Any], parallelism: int = 8) -> Dataset:
    return Dataset.from_items(items, parallelism)


def range(n: int, parallelism: int = 8) -> Dataset:  # noqa: A001
    return Dataset.range(n, parallelism)


def from_numpy(arrays: Union[np.ndarray, Dict[str, np.ndarray]],
               parallelism: int = 8) -> Dataset:
    if isinstance(arrays, np.ndarray):
        arrays = {"data": arrays}
    return Dataset.from_numpy(arrays, parallelism)


read_parquet = not_ported("ray_tpu_torch.data.read_parquet")
read_csv = not_ported("ray_tpu_torch.data.read_csv")
read_json = not_ported("ray_tpu_torch.data.read_json")
read_numpy = not_ported("ray_tpu_torch.data.read_numpy")
read_text = not_ported("ray_tpu_torch.data.read_text")
read_binary_files = not_ported("ray_tpu_torch.data.read_binary_files")
read_images = not_ported("ray_tpu_torch.data.read_images")
read_tfrecords = not_ported("ray_tpu_torch.data.read_tfrecords")
read_datasource = not_ported("ray_tpu_torch.data.read_datasource")
read_streaming = not_ported("ray_tpu_torch.data.read_streaming")
register_datasource = not_ported("ray_tpu_torch.data.register_datasource")
