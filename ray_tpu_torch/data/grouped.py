"""Distributed sort + groupby over dataset blocks (counterpart of
``ray_tpu/data/grouped.py``; reference: python/ray/data/dataset.py
(Dataset.sort, Dataset.groupby), _internal/sort.py and grouped_data.py).

Two phases, all block-parallel remote tasks — the driver only routes
refs:

  sort:    sample each block → positional boundaries → every block range-
           partitions itself (num_returns=P) → output block i concatenates
           part i of every input and sorts locally.
  groupby: every block hash-partitions itself by key → output partition i
           concatenates its parts and aggregates (``aggregate_block``).

The sample-sort and the hash are the reference's, so rows land in the
same partitions and in the same order.  The reference aggregates with
pyarrow's ``group_by().aggregate()``; the port does the same in numpy
(``aggregate_block``): the key column first, then ``{col}_{fn}`` columns,
groups in order of first appearance.

Copied from ``ray_tpu/data/grouped.py`` (the JAX package).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data import block as block_mod


@ray_tpu_torch.remote
def _sample_keys(blk, key: str, n: int):
    col = blk[key]
    if len(col) == 0:
        return col
    idx = np.random.default_rng(0).integers(0, len(col), size=min(n, len(col)))
    return col[idx]


@ray_tpu_torch.remote
def _range_partition(blk, key: str, boundaries, descending: bool):
    part = np.searchsorted(np.asarray(boundaries), blk[key], side="right")
    n_parts = len(boundaries) + 1
    if descending:
        part = (n_parts - 1) - part
    return tuple(block_mod.block_filter(blk, part == i)
                 for i in range(n_parts))


@ray_tpu_torch.remote
def _merge_sorted(key: str, descending: bool, *parts):
    t = block_mod.concat_blocks(list(parts))
    order = np.argsort(t[key], kind="stable")
    if descending:
        order = order[::-1]
    return block_mod.block_take(t, order)


def _stable_hash(col: np.ndarray) -> np.ndarray:
    """Process-stable per-value hashes (python's str hash is salted per
    process, which would send equal keys to different partitions across
    workers).  Numeric dtypes vectorize through a splitmix64 finalizer;
    objects/strings fall back to crc32 of the repr."""
    if np.issubdtype(col.dtype, np.integer) \
            or np.issubdtype(col.dtype, np.floating):
        # ONE canonical numeric form: a null promotes an int64 column to
        # float64 in the block that holds it, so int and float paths must
        # agree or the same key hashes differently across blocks and a
        # group splits.  float64 bits lose int uniqueness above 2^53 —
        # keys collide into one partition there, which only skews load,
        # never correctness.
        x = col.astype(np.float64).view(np.uint64)
    else:
        import zlib

        return np.fromiter((zlib.crc32(repr(v).encode()) for v in col),
                           dtype=np.uint64, count=len(col))
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


@ray_tpu_torch.remote
def _hash_partition(blk, key: str, num_parts: int):
    part = _stable_hash(blk[key]) % num_parts
    return tuple(block_mod.block_filter(blk, part == i)
                 for i in range(num_parts))


def _is_null(col: np.ndarray) -> np.ndarray:
    """A block's nulls: NaN/NaT where the column's type has them, None in
    an object column (the reference's arrow columns carry a mask)."""
    if col.dtype.kind in "fcmM":
        return np.isnan(col)
    if col.dtype == object:
        return np.fromiter((v is None for v in col), bool, len(col))
    return np.zeros(len(col), bool)


def _agg_dtype(dtype: np.dtype, fn: str) -> np.dtype:
    """arrow's result types: count int64, mean and stddev float64, sum of
    a signed integer int64, of an unsigned one or a bool uint64, of a
    float float64; min and max keep the column's type."""
    if fn == "count":
        return np.dtype(np.int64)
    if fn in ("mean", "stddev"):
        return np.dtype(np.float64)
    if fn == "sum":
        return np.dtype({"i": np.int64, "u": np.uint64, "b": np.uint64}.get(
            dtype.kind, np.float64))
    return dtype


def _agg(values: np.ndarray, fn: str):
    """One group's aggregate over its non-null values (arrow's default
    skip_nulls); a group with none gives NaN (arrow's null)."""
    values = values[~_is_null(values)]
    if fn == "count":
        return len(values)
    if len(values) == 0:
        return np.nan
    if fn == "sum":
        return values.sum()
    if fn == "mean":
        return values.astype(np.float64).mean()
    if fn == "stddev":
        return values.astype(np.float64).std(ddof=0)
    if fn == "min":
        return values.min()
    if fn == "max":
        return values.max()
    raise ValueError(f"unknown aggregate {fn!r}; known: count, sum, mean, "
                     "min, max, stddev")


def _group_ids(keys: np.ndarray) -> np.ndarray:
    """Each row's group, the groups numbered in order of first
    appearance; the nulls (None, NaN, NaT) are one group."""
    if keys.dtype == object:
        first: dict = {}
        return np.fromiter((first.setdefault(v, len(first)) for v in keys),
                           np.int64, len(keys))
    _, starts, inverse = np.unique(keys, return_index=True,
                                   return_inverse=True)
    rank = np.empty(len(starts), np.int64)
    rank[np.argsort(starts, kind="stable")] = np.arange(len(starts))
    return rank[inverse.reshape(-1)]


def aggregate_block(blk, key: str, aggs) -> dict:
    """``group_by([key]).aggregate(aggs)`` in numpy: one row per distinct
    key, groups in order of first appearance; the key column first, then
    ``{col}_{fn}`` for each ``(col, fn)``.  A block of 0 rows gives 0 rows
    of the same columns and types."""
    ids = _group_ids(blk[key])
    groups = int(ids.max()) + 1 if len(ids) else 0
    by_group = np.argsort(ids, kind="stable")
    bounds = np.searchsorted(ids[by_group], np.arange(groups + 1))
    members = [by_group[a:b] for a, b in zip(bounds, bounds[1:])]
    out = {key: blk[key][[m[0] for m in members]]
           if members else blk[key][:0]}
    for col, fn in aggs:
        values = blk[col]
        out[f"{col}_{fn}"] = np.asarray([_agg(values[m], fn)
                                         for m in members],
                                        dtype=_agg_dtype(values.dtype, fn))
    return out


@ray_tpu_torch.remote
def _agg_partition(key: str, aggs, *parts):
    """aggs: list of (column, aggregate name); output columns get
    pyarrow's '{col}_{fn}' naming."""
    # Empty partitions aggregate too: zero rows with the AGGREGATED
    # columns, so every output block has the same schema.
    return aggregate_block(block_mod.concat_blocks(list(parts)), key, aggs)


def sort_impl(blocks: List, key: str, descending: bool = False,
              samples_per_block: int = 64) -> List:
    if not blocks:
        return blocks
    samples = np.concatenate(
        ray_tpu_torch.get([_sample_keys.remote(b, key, samples_per_block)
                           for b in blocks]))
    if samples.size == 0:
        return blocks
    n_out = len(blocks)
    # Positional boundaries from the sorted sample — works for any
    # orderable dtype (strings included), unlike np.quantile.
    samples = np.sort(samples, kind="stable")
    if n_out > 1:
        pos = np.linspace(0, len(samples) - 1, n_out + 1)[1:-1]
        boundaries = samples[pos.astype(int)]
    else:
        boundaries = samples[:0]
    part_lists = [
        _range_partition.options(num_returns=n_out).remote(
            b, key, boundaries, descending)
        for b in blocks
    ]
    if n_out == 1:
        part_lists = [[p] for p in part_lists]
    return [
        _merge_sorted.remote(key, descending,
                             *[parts[i] for parts in part_lists])
        for i in range(n_out)
    ]


class GroupedData:
    """ds.groupby(key) → aggregations (reference: grouped_data.py)."""

    def __init__(self, dataset, key: str,
                 num_partitions: Optional[int] = None):
        self._ds = dataset
        self._key = key
        self._parts = num_partitions or max(
            1, min(8, len(dataset._blocks)))

    def _aggregate(self, aggs):
        from ray_tpu_torch.data.dataset import Dataset

        blocks = self._ds._blocks
        part_lists = [
            _hash_partition.options(num_returns=self._parts).remote(
                b, self._key, self._parts)
            for b in blocks
        ]
        if self._parts == 1:
            part_lists = [[p] for p in part_lists]
        return Dataset([
            _agg_partition.remote(self._key, aggs,
                                  *[parts[i] for parts in part_lists])
            for i in range(self._parts)
        ])

    def count(self):
        return self._aggregate([(self._key, "count")])

    def sum(self, col: str):
        return self._aggregate([(col, "sum")])

    def mean(self, col: str):
        return self._aggregate([(col, "mean")])

    def min(self, col: str):
        return self._aggregate([(col, "min")])

    def max(self, col: str):
        return self._aggregate([(col, "max")])

    def std(self, col: str):
        return self._aggregate([(col, "stddev")])

    def aggregate(self, *aggs):
        """aggs: (column, aggregate name) pairs, e.g. ("v", "sum")."""
        return self._aggregate(list(aggs))
