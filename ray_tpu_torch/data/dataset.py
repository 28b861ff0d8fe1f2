"""Distributed Dataset on object-store blocks (counterpart of
``ray_tpu/data/dataset.py``; reference: python/ray/data/dataset.py:156,
_internal/plan.py).

The per-block transforms (``map_batches``/``map``/``filter``) are LAZY
plan ops (``data/execution.py``): nothing runs at call time, and the
consuming iterators (``iter_batches``/``iter_device_batches``/``count``/
``take``) drive the plan per block through a bounded
:class:`ray_tpu_torch.parallel.flow.RefStream` — read→map→consume
overlap with peak resident blocks capped by the window.  Whole-dataset
operators (repartition/sort/split/zip/writes) materialize the plan
first: they are barriers by nature.

Blocks are dicts of numpy columns (``data/block.py``); ``schema()`` is
``{name: (dtype, inner shape)}`` where the reference returns a
``pyarrow.Schema``.

Copied from ``ray_tpu/data/dataset.py`` (the JAX package).
"""
from __future__ import annotations

import os
from typing import Any, Callable, Dict, Iterator, List, Optional, Union

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data import execution
from ray_tpu_torch.data.block import (
    block_from_items,
    block_from_numpy,
    block_num_rows,
    block_schema,
    block_slice,
    block_to_numpy,
    block_to_rows,
    concat_blocks,
    format_batch,
)


@ray_tpu_torch.remote
def _count_block(blk):
    return block_num_rows(blk)


@ray_tpu_torch.remote
def _write_block(blk, path: str, fmt: str) -> str:
    from ray_tpu_torch.data.datasource import WRITERS

    if fmt not in WRITERS:
        raise ValueError(f"bad write format {fmt!r}")
    # Task-side: the writing node may not be the driver's host.
    os.makedirs(os.path.dirname(path), exist_ok=True)
    WRITERS[fmt](blk, path)
    return path


@ray_tpu_torch.remote
def _concat(*blks):
    return concat_blocks(list(blks))


@ray_tpu_torch.remote
def _slice_block(blk, start, end):
    return block_slice(blk, start, end)


@ray_tpu_torch.remote
def _concat_slices(ranges, *blks):
    """Concatenate [start, end) slices of the given blocks (the
    repartition reduce side: one output block's pieces only)."""
    parts = [block_slice(b, s, e) for b, (s, e) in zip(blks, ranges)]
    return concat_blocks(parts) if parts else block_from_items([])


class Dataset:
    """``sources`` holds object refs to materialized blocks and/or lazy
    ``("read", reader, path, columns)`` descriptors; ``plan`` holds the
    per-block ops not yet applied.  ``_blocks`` materializes the plan
    eagerly and caches the resulting refs."""

    def __init__(self, block_refs: List[Any],
                 plan: Optional[List[execution.PlanOp]] = None):
        self._sources: List[Any] = list(block_refs)
        self._plan: List[execution.PlanOp] = list(plan or [])

    @property
    def _blocks(self) -> List[Any]:
        """Materialized block refs: collapses lazy reads + pending plan
        ops into store-resident blocks."""
        if self._plan or any(execution.is_read_source(s)
                             for s in self._sources):
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

    @staticmethod
    def read(paths: Union[str, List[str]], fmt: str,
             columns=None) -> "Dataset":
        from ray_tpu_torch.data.datasource import (
            expand_paths,
            resolve_datasource,
        )

        reader = resolve_datasource(fmt)
        # Lazy read sources: no task runs until a consumer drives the
        # plan, and then the read fuses with the chained per-block ops.
        return Dataset([("read", reader, p, columns)
                        for p in expand_paths(paths)])

    # ---------------- transforms (lazy plan ops) ----------------
    def _with_op(self, op: execution.PlanOp) -> "Dataset":
        return Dataset(self._sources, self._plan + [op])

    def map_batches(self, fn: Callable, batch_format: str = "numpy",
                    num_gpus: float = 0) -> "Dataset":
        """``fn`` over every block's batch in ``batch_format`` (numpy,
        pandas or pyarrow).  ``num_gpus`` is the share of a card each
        block's task asks for (0: a CPU task, whose worker sees no
        GPU)."""
        if batch_format not in ("numpy", "pandas", "pyarrow"):
            raise ValueError(f"bad batch_format {batch_format!r}")
        op = ("map_batches", fn, batch_format)
        if num_gpus:
            op += (num_gpus,)
        return self._with_op(op)

    def map(self, fn: Callable) -> "Dataset":
        def row_fn(batch: dict):
            rows = _batch_to_rows(batch)
            out = [fn(r) for r in rows]
            return _rows_to_batch(out)

        return self.map_batches(row_fn, batch_format="numpy")

    def filter(self, fn: Callable) -> "Dataset":
        return self._with_op(("filter", fn, None))

    def repartition(self, num_blocks: int) -> "Dataset":
        """Block-parallel repartition via a slice plan: each output block
        concatenates only the input slices it needs — no task ever holds
        the whole dataset."""
        blocks = self._blocks  # barrier: slice plan needs all lengths
        lengths = ray_tpu_torch.get([_count_block.remote(b) for b in blocks])
        total = int(sum(lengths))
        starts = np.cumsum([0] + lengths)  # input block i covers
        bounds = np.linspace(0, total, num_blocks + 1, dtype=int)
        out = []
        for a, b in zip(bounds, bounds[1:]):
            pieces = []
            for i, (s, ln) in enumerate(zip(starts, lengths)):
                lo, hi = max(a, s), min(b, s + ln)
                if hi > lo:
                    pieces.append((blocks[i], int(lo - s), int(hi - s)))
            if pieces:
                out.append(_concat_slices.remote(
                    [p[1:] for p in pieces], *[p[0] for p in pieces]))
            else:
                # More output blocks than rows: an empty output must keep
                # the dataset's SCHEMA (a 0-row slice of a real block).
                out.append(_slice_block.remote(blocks[0], 0, 0))
        return Dataset(out)

    def random_shuffle(self, seed: Optional[int] = None) -> "Dataset":
        """Block-local shuffle after a repartition into as many blocks.
        Every block derives its rng from ``(seed, block_index)`` through a
        SeedSequence spawn, so the blocks' permutations are decorrelated
        and the same seed gives the JAX package's order bit for bit;
        ``seed=None`` draws fresh OS entropy per call."""
        entropy = np.random.SeedSequence(seed).entropy

        def shuf(batch: dict, block_index: int):
            rng = np.random.default_rng(np.random.SeedSequence(
                entropy=entropy, spawn_key=(int(block_index),)))
            n = len(next(iter(batch.values()))) if batch else 0
            idx = rng.permutation(n)
            return {k: v[idx] for k, v in batch.items()}

        out = self.repartition(self.num_blocks())
        return out._with_op(("map_batches_indexed", shuf, "numpy"))

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

    def sort(self, key: str, descending: bool = False) -> "Dataset":
        """Distributed sample-sort (reference: Dataset.sort →
        _internal/sort.py two-phase range partition)."""
        from ray_tpu_torch.data.grouped import sort_impl

        return Dataset(sort_impl(self._blocks, key, descending))

    def groupby(self, key: str, num_partitions: Optional[int] = None):
        """Hash-shuffle groupby (reference: Dataset.groupby →
        grouped_data.py)."""
        from ray_tpu_torch.data.grouped import GroupedData

        return GroupedData(self, key, num_partitions)

    def zip(self, other: "Dataset") -> "Dataset":
        a = concat_blocks(ray_tpu_torch.get(self._blocks))
        b = concat_blocks(ray_tpu_torch.get(other._blocks))
        if block_num_rows(a) != block_num_rows(b):
            raise ValueError(f"zip needs equal row counts, got "
                             f"{block_num_rows(a)} and {block_num_rows(b)}")
        return Dataset([ray_tpu_torch.put({**a, **b})])

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

    def take_all(self, window: Optional[int] = None) -> List[dict]:
        return list(self.iter_rows(window=window))

    def schema(self):
        """``{name: (dtype, inner shape)}`` of the first block (plan ops
        keep the columns even on 0-row outputs)."""
        ex = execution.PlanExecutor(self._sources[:1], self._plan,
                                    window=1, name="schema")
        for ref in ex.iter_block_refs():
            return block_schema(ray_tpu_torch.get(ref))
        raise ValueError("schema() on an empty dataset")

    def num_blocks(self) -> int:
        return len(self._sources)

    def iter_rows(self, window: Optional[int] = None) -> Iterator[dict]:
        for ref in self._executor(window, name="rows").iter_block_refs():
            blk = ray_tpu_torch.get(ref)
            del ref
            yield from block_to_rows(blk)

    def iter_batches(self, batch_size: int = 256, batch_format: str = "numpy",
                     drop_last: bool = False,
                     window: Optional[int] = None) -> Iterator[Any]:
        """Stream batches; the plan executes per-block with at most
        ``window`` blocks in flight (read→map→consume overlap)."""
        return _batches(self._executor(window, name="batches"
                                       ).iter_block_refs(),
                        batch_size, batch_format, drop_last)

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
        blocks = self._blocks  # collapse lazy reads + pending plan ops
        ray_tpu_torch.wait(blocks, num_returns=len(blocks))
        return self

    def streaming(self, store_budget: Optional[int] = None,
                  max_inflight_blocks: Optional[int] = None):
        """Switch to the bounded-memory streaming executor
        (ray_tpu_torch.data.streaming.StreamingDataset).  The pending plan
        carries over verbatim — ops are the same tuples both engines
        execute."""
        from ray_tpu_torch.data.streaming import StreamingDataset

        sources = [s if execution.is_read_source(s) else (lambda r=s: r)
                   for s in self._sources]
        return StreamingDataset(sources, stages=list(self._plan),
                                store_budget=store_budget,
                                max_inflight_blocks=max_inflight_blocks)

    # ---------------- writes (reference: Dataset.write_parquet/csv/json,
    # python/ray/data/dataset.py + file_datasink.py: one file per block,
    # written by the task that holds the block) ----------------
    def _write(self, path: str, fmt: str, ext: str, mode: str) -> List[str]:
        import glob as glob_mod

        existing = glob_mod.glob(os.path.join(path, f"part-*.{ext}"))
        if existing:
            if mode == "overwrite":
                for p in existing:
                    os.remove(p)  # a shorter write must not leave a stale
                    # tail that doubles rows on read-back
            else:
                raise FileExistsError(
                    f"{path} already holds {len(existing)} part files; "
                    "pass mode='overwrite' to replace them")
        refs = [
            _write_block.remote(
                b, os.path.join(path, f"part-{i:05d}.{ext}"), fmt)
            for i, b in enumerate(self._blocks)
        ]
        return ray_tpu_torch.get(refs)

    def write_parquet(self, path: str, mode: str = "error") -> List[str]:
        return self._write(path, "parquet", "parquet", mode)

    def write_csv(self, path: str, mode: str = "error") -> List[str]:
        return self._write(path, "csv", "csv", mode)

    def write_json(self, path: str, mode: str = "error") -> List[str]:
        return self._write(path, "json", "json", mode)

    def stats(self) -> dict:
        return {"num_blocks": len(self._sources), "count": self.count()}


def _batches(block_refs, batch_size: int, batch_format: str,
             drop_last: bool) -> Iterator[Any]:
    """Re-cut a stream of block refs into batches of ``batch_size`` rows,
    carrying the remainder across blocks; each ref is dropped once its
    rows are in this process, releasing its store copy."""
    carry: Optional[dict] = None
    for ref in block_refs:
        blk = ray_tpu_torch.get(ref)
        del ref
        batch = block_to_numpy(blk)
        del blk
        if carry is not None:
            batch = {k: np.concatenate([carry[k], batch[k]]) for k in batch}
        n = len(next(iter(batch.values()))) if batch else 0
        pos = 0
        while n - pos >= batch_size:
            yield format_batch({k: v[pos:pos + batch_size]
                                for k, v in batch.items()}, batch_format)
            pos += batch_size
        carry = {k: v[pos:] for k, v in batch.items()} if pos < n else None
    if carry is not None and not drop_last and \
            len(next(iter(carry.values()))) > 0:
        yield format_batch(carry, batch_format)


def _batch_to_rows(batch: Dict[str, np.ndarray]) -> List[dict]:
    keys = list(batch)
    n = len(batch[keys[0]]) if keys else 0
    return [{k: batch[k][i] for k in keys} for i in range(n)]


def _rows_to_batch(rows: List[Any]) -> Dict[str, np.ndarray]:
    if rows and isinstance(rows[0], dict):
        return {k: np.asarray([r[k] for r in rows]) for k in rows[0]}
    return {"item": np.asarray(rows)}
