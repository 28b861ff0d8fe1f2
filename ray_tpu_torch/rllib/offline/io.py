"""SampleBatch JSON-lines IO (counterpart of
``ray_tpu/rllib/offline/io.py``; reference: rllib/offline/json_writer.py:30,
json_reader.py:43).  A copy over the port's numpy ``SampleBatch``: the
files it writes are the JAX package's byte for byte."""
from __future__ import annotations

import glob
import json
import os
from typing import Iterator, List, Union

import numpy as np

from ray_tpu_torch.rllib.policy.sample_batch import SampleBatch


class JsonWriter:
    """Append SampleBatches to JSON-lines files under ``path``."""

    def __init__(self, path: str, max_file_size: int = 64 * 1024 * 1024):
        self.path = path
        os.makedirs(path, exist_ok=True)
        self.max_file_size = max_file_size
        self._index = 0
        self._f = None

    def _rotate(self):
        if self._f is not None:
            self._f.close()
        name = os.path.join(self.path, f"output-{self._index:05d}.json")
        self._index += 1
        self._f = open(name, "a")

    def write(self, batch: SampleBatch):
        if self._f is None or self._f.tell() > self.max_file_size:
            self._rotate()
        payload = {k: np.asarray(v).tolist() for k, v in batch.items()}
        self._f.write(json.dumps(payload) + "\n")
        self._f.flush()

    def close(self):
        if self._f is not None:
            self._f.close()
            self._f = None


class JsonReader:
    """Iterate SampleBatches back from JsonWriter output."""

    def __init__(self, path: Union[str, List[str]]):
        if isinstance(path, str):
            if os.path.isdir(path):
                self.files = sorted(glob.glob(os.path.join(path, "*.json")))
            else:
                self.files = sorted(glob.glob(path)) or [path]
        else:
            self.files = list(path)

    def read_all(self) -> SampleBatch:
        return SampleBatch.concat_samples(list(self))

    def __iter__(self) -> Iterator[SampleBatch]:
        for fp in self.files:
            with open(fp) as f:
                for line in f:
                    line = line.strip()
                    if line:
                        obj = json.loads(line)
                        yield SampleBatch({k: np.asarray(v)
                                           for k, v in obj.items()})
