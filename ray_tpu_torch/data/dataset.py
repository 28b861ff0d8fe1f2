"""Distributed Dataset on object-store blocks (counterpart of
``ray_tpu/data/dataset.py``; reference: python/ray/data/dataset.py:156,
_internal/plan.py).

``map_batches`` is a LAZY plan op (``data/execution.py``): nothing runs
at call time, and the consuming iterators (``iter_batches``,
``iter_device_batches``, ``count``, ``take``) drive the plan per block
through a bounded :class:`ray_tpu_torch.parallel.flow.RefStream`.
``split`` materializes the plan first: it is a barrier by nature.

The port's Dataset is the Data->Train ingest subset: ``from_items``,
``range`` and ``from_numpy``; ``map_batches`` in the numpy format;
``split``, ``count``, ``take``, ``iter_rows``, ``iter_batches``,
``iter_device_batches`` and ``materialize``.  Blocks are dicts of numpy
columns (``data/block.py``).  The other operators (``map``, ``filter``,
``repartition``, ``random_shuffle``, ``sort``, ``groupby``, ``zip``,
``schema``, ``streaming``, the writers, ``take_all``, ``num_blocks``,
``stats``) and the pyarrow and pandas batch formats raise, naming
ROADMAP Queue 1 item 1c.

Copied from ``ray_tpu/data/dataset.py`` (the JAX package), cut to the
ingest subset.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data import execution
from ray_tpu_torch.data.block import (
    block_from_items,
    block_from_numpy,
    block_slice,
    block_to_numpy,
    block_to_rows,
    check_batch_format,
    concat_blocks,
    not_ported,
)


@ray_tpu_torch.remote
def _concat(*blks):
    return concat_blocks(list(blks))


@ray_tpu_torch.remote
def _slice_block(blk, start, end):
    return block_slice(blk, start, end)


class Dataset:
    """``sources`` holds object refs to materialized blocks; ``plan``
    holds the per-block ops not yet applied."""

    def __init__(self, block_refs: List[Any],
                 plan: Optional[List[execution.PlanOp]] = None):
        self._sources: List[Any] = list(block_refs)
        self._plan: List[execution.PlanOp] = list(plan or [])

    @property
    def _blocks(self) -> List[Any]:
        """Materialized block refs: collapses pending plan ops into
        store-resident blocks."""
        if self._plan:
            self._sources = execution.PlanExecutor(
                self._sources, self._plan).materialize_refs()
            self._plan = []
        return self._sources

    def _executor(self, window: Optional[int] = None,
                  name: str = "dataset") -> execution.PlanExecutor:
        return execution.PlanExecutor(self._sources, self._plan,
                                      window=window, name=name)

    # ---------------- creation ----------------
    @staticmethod
    def from_items(items: List[Any], parallelism: int = 8) -> "Dataset":
        chunks = np.array_split(np.arange(len(items)),
                                max(1, min(parallelism, len(items))))
        # Block puts ride put_many: one coalesced control-plane message
        # for the whole set of blocks instead of one per block.
        return Dataset(ray_tpu_torch.put_many(
            [block_from_items([items[i] for i in c])
             for c in chunks if len(c)]))

    @staticmethod
    def range(n: int, parallelism: int = 8) -> "Dataset":
        bounds = np.linspace(0, n, max(1, parallelism) + 1, dtype=int)
        return Dataset(ray_tpu_torch.put_many(
            [block_from_numpy({"id": np.arange(a, b)})
             for a, b in zip(bounds, bounds[1:]) if b > a]))

    @staticmethod
    def from_numpy(arrays: Dict[str, np.ndarray], parallelism: int = 8
                   ) -> "Dataset":
        n = len(next(iter(arrays.values())))
        bounds = np.linspace(0, n, max(1, parallelism) + 1, dtype=int)
        blocks = [block_from_numpy({k: v[a:b] for k, v in arrays.items()})
                  for a, b in zip(bounds, bounds[1:]) if b > a]
        return Dataset(ray_tpu_torch.put_many(blocks))

    # ---------------- transforms (lazy plan ops) ----------------
    def map_batches(self, fn, batch_format: str = "numpy",
                    num_gpus: float = 0) -> "Dataset":
        """``fn`` over every block's batch.  ``num_gpus`` is the share of
        a card each block's task asks for (0: a CPU task, whose worker
        sees no GPU)."""
        check_batch_format(batch_format)
        op = ("map_batches", fn, batch_format)
        if num_gpus:
            op += (num_gpus,)
        return Dataset(self._sources, self._plan + [op])

    map = not_ported("Dataset.map")
    filter = not_ported("Dataset.filter")
    repartition = not_ported("Dataset.repartition")
    random_shuffle = not_ported("Dataset.random_shuffle")
    sort = not_ported("Dataset.sort")
    groupby = not_ported("Dataset.groupby")
    zip = not_ported("Dataset.zip")
    schema = not_ported("Dataset.schema")
    streaming = not_ported("Dataset.streaming")
    write_parquet = not_ported("Dataset.write_parquet")
    write_csv = not_ported("Dataset.write_csv")
    write_json = not_ported("Dataset.write_json")
    take_all = not_ported("Dataset.take_all")
    num_blocks = not_ported("Dataset.num_blocks")
    stats = not_ported("Dataset.stats")

    def split(self, n: int, equal: bool = True) -> List["Dataset"]:
        """Per-worker shards (reference: Dataset.split with locality hints →
        train ingest, dataset_spec.py:46-99)."""
        total = self.count()
        per = total // n
        whole = _concat.remote(*self._blocks)
        out = []
        for i in range(n):
            start = i * per
            end = (i + 1) * per if (equal or i < n - 1) else total
            out.append(Dataset([_slice_block.remote(whole, start, end)]))
        return out

    # ---------------- consumption (drives the plan, windowed) -----------
    def count(self, window: Optional[int] = None) -> int:
        total = 0
        for ref in self._executor(window, name="count").iter_count_refs():
            total += int(ray_tpu_torch.get(ref))
            del ref
        return total

    def take(self, n: int = 20, window: Optional[int] = None) -> List[dict]:
        out: List[dict] = []
        refs = self._executor(window, name="take").iter_block_refs()
        try:
            for ref in refs:
                blk = ray_tpu_torch.get(ref)
                del ref
                out.extend(block_to_rows(blk)[: n - len(out)])
                if len(out) >= n:
                    break
        finally:
            refs.close()  # early exit: release the in-flight window
        return out

    def iter_rows(self, window: Optional[int] = None) -> Iterator[dict]:
        for ref in self._executor(window, name="rows").iter_block_refs():
            blk = ray_tpu_torch.get(ref)
            del ref
            yield from block_to_rows(blk)

    def iter_batches(self, batch_size: int = 256, batch_format: str = "numpy",
                     drop_last: bool = False,
                     window: Optional[int] = None
                     ) -> Iterator[Dict[str, np.ndarray]]:
        """Stream batches; the plan executes per-block with at most
        ``window`` blocks in flight (read→map→consume overlap)."""
        check_batch_format(batch_format)
        carry: Optional[dict] = None
        for ref in self._executor(window, name="batches").iter_block_refs():
            blk = ray_tpu_torch.get(ref)
            del ref  # release the store copy once rows are in-process
            batch = block_to_numpy(blk)
            del blk
            if carry is not None:
                batch = {k: np.concatenate([carry[k], batch[k]])
                         for k in batch}
            n = len(next(iter(batch.values()))) if batch else 0
            pos = 0
            while n - pos >= batch_size:
                yield {k: v[pos:pos + batch_size] for k, v in batch.items()}
                pos += batch_size
            carry = {k: v[pos:] for k, v in batch.items()} if pos < n else None
        if carry is not None and not drop_last and \
                len(next(iter(carry.values()))) > 0:
            yield carry

    def iter_device_batches(self, batch_size: int = 256, device=None,
                            prefetch: int = 2,
                            window: Optional[int] = None) -> Iterator[Any]:
        """ML-ingest hot path: host batches become tensors on ``device``
        (None: CUDA) on a BACKGROUND thread feeding a bounded queue, so the
        store fetch and the host-to-device copy overlap the consumer's
        step (reference analogue: iter_torch_batches + pin_memory/
        prefetch worker, data/dataset_iterator.py).  prefetch=0 places
        inline; see ray_tpu_torch.data.prefetch.DevicePrefetcher."""
        from ray_tpu_torch.data.prefetch import DevicePrefetcher

        return DevicePrefetcher(
            self.iter_batches(batch_size, "numpy", window=window),
            device=device, prefetch=prefetch)

    def materialize(self) -> "Dataset":
        blocks = self._blocks  # collapse pending plan ops
        ray_tpu_torch.wait(blocks, num_returns=len(blocks))
        return self
