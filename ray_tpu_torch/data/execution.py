"""Streaming plan execution for the eager Dataset API (counterpart of
``ray_tpu/data/execution.py``; reference: ray.data's lazy ExecutionPlan +
StreamingExecutor, python/ray/data/_internal/plan.py,
_internal/execution/streaming_executor.py:31).

``Dataset.map_batches``/``map``/``filter`` append *plan ops* to a lazy
plan, and consumption drives the plan through a bounded
:class:`ray_tpu_torch.parallel.flow.RefStream`:

- one fused task per block applies the WHOLE op chain (read included for
  lazy read sources), so a read→map→filter pipeline costs one store
  write per block instead of one per stage;
- at most ``window`` output blocks are in flight or resident at once;
- eager and streaming results are byte-identical, since both run the
  same per-block kernel (:func:`apply_op`) in the same block order.

Plan ops are ``(kind, fn, batch_format)`` tuples, or ``(kind, fn,
batch_format, num_gpus)`` for an op whose task must reach the card
(``BatchPredictor``'s): a block's fused task asks for the largest share
its ops name.  Kinds:

- ``"map_batches"`` — ``apply_batch_fn`` over the block;
- ``"filter"`` — a row UDF, or a ``pyarrow.compute`` expression
  (vectorized, where pyarrow is installed);
- ``"map_batches_indexed"`` — like map_batches but ``fn(batch,
  block_index)``; carries per-block context (the decorrelated shuffle
  seeds) without a task per distinct closure.

Copied from ``ray_tpu/data/execution.py`` (the JAX package).
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data.block import (
    apply_batch_fn,
    block_filter,
    block_num_rows,
    block_take,
    block_to_arrow,
    require,
)

# Default bound on in-flight/resident output blocks for plan-driving
# consumers (iter_batches / count / take).
DEFAULT_WINDOW = 4

PlanOp = Tuple  # (kind, fn, batch_format[, num_gpus])


def _is_arrow_expression(fn) -> bool:
    """Only a ``pyarrow.compute.Expression`` comes from pyarrow's module;
    checking the type's module keeps pyarrow unimported for row UDFs."""
    return type(fn).__module__.startswith("pyarrow")


def _filter_block(blk, fn):
    if _is_arrow_expression(fn):
        # Vectorized: arrow evaluates the predicate over a table built
        # from the block; the surviving row numbers select the block's
        # own columns, so their dtypes stay the port's.
        pa = require("pyarrow", "a pyarrow.compute filter expression")
        table = block_to_arrow(blk)
        table = table.append_column(
            "__row", pa.array(np.arange(table.num_rows, dtype=np.int64)))
        rows = table.filter(fn).column("__row").to_numpy()
        return block_take(blk, rows)
    # Row UDF over zipped column values (Python values, as the
    # reference's to_pylist gives them).
    cols = {name: col.tolist() for name, col in blk.items()}
    names = list(cols)
    mask = [bool(fn(dict(zip(names, vals))))
            for vals in zip(*cols.values())] if names else []
    return block_filter(blk, np.asarray(mask, dtype=bool))


def apply_op(blk, op: PlanOp, block_index: int = 0):
    """Apply ONE plan op to a block — the single per-block kernel both
    the eager plan executor and the StreamingDataset run."""
    kind, fn, batch_format = op[0], op[1], op[2]
    if kind == "map_batches":
        return apply_batch_fn(blk, fn, batch_format)
    if kind == "map_batches_indexed":
        return apply_batch_fn(blk, lambda b: fn(b, block_index),
                              batch_format)
    if kind == "filter":
        return _filter_block(blk, fn)
    raise ValueError(f"unknown plan op {kind!r}")


def apply_ops(blk, ops: Sequence[PlanOp], block_index: int = 0):
    for op in ops:
        blk = apply_op(blk, op, block_index)
    return blk


@ray_tpu_torch.remote
def _apply_ops_task(blk, ops, block_index):
    return apply_ops(blk, ops, block_index)


@ray_tpu_torch.remote
def _read_apply_ops_task(reader, path, columns, ops, block_index):
    """Operator fusion with the read: the block is born, transformed and
    sealed in ONE task — the Read→MapBatches fusion from the reference's
    logical optimizer (data/_internal/logical/optimizers.py)."""
    return apply_ops(reader(path, columns), ops, block_index)


@ray_tpu_torch.remote
def _count_after_ops(blk, ops, block_index):
    """Count-only consumption: the transformed block lives and dies
    inside this task; only the row count crosses the store."""
    return block_num_rows(apply_ops(blk, ops, block_index))


@ray_tpu_torch.remote
def _read_count_after_ops(reader, path, columns, ops, block_index):
    return block_num_rows(apply_ops(reader(path, columns), ops,
                                    block_index))


def is_read_source(src) -> bool:
    return isinstance(src, tuple) and len(src) == 4 and src[0] == "read"


def _with_gpus(task, ops: Sequence[PlanOp]):
    """``task`` asking for the largest GPU share among ``ops``."""
    gpus = max((op[3] for op in ops if len(op) > 3), default=0)
    return task.options(num_gpus=gpus) if gpus else task


def _submit_thunk(src, ops: List[PlanOp], idx: int) -> Callable[[], Any]:
    """One submit thunk per block for the RefStream: read sources fuse
    read+ops into one task; ref sources chain ops in one task; a ref
    with no ops passes through untouched (no task, no copy)."""
    if is_read_source(src):
        _, reader, path, columns = src
        task = _with_gpus(_read_apply_ops_task, ops)
        return lambda: task.remote(reader, path, columns, ops, idx)
    if ops:
        task = _with_gpus(_apply_ops_task, ops)
        return lambda: task.remote(src, ops, idx)
    return lambda: src


def _count_thunk(src, ops: List[PlanOp], idx: int) -> Callable[[], Any]:
    if is_read_source(src):
        _, reader, path, columns = src
        task = _with_gpus(_read_count_after_ops, ops)
        return lambda: task.remote(reader, path, columns, ops, idx)
    task = _with_gpus(_count_after_ops, ops)
    return lambda: task.remote(src, ops, idx)


class PlanExecutor:
    """Drive a (sources, plan) pair as a bounded pipelined block stream.

    ``iter_block_refs`` yields output block refs in source order with at
    most ``window`` in flight; the caller drops each yielded ref once
    consumed to release its store copy.  ``last_stream_stats`` holds the
    flow stage's counters once a drive ends (``peak_in_flight``)."""

    def __init__(self, sources: Sequence[Any], plan: Sequence[PlanOp],
                 window: Optional[int] = None, name: str = "dataset"):
        self.sources = list(sources)
        self.plan = list(plan)
        self.window = max(1, int(window or DEFAULT_WINDOW))
        self.name = name
        self.last_stream_stats: Optional[dict] = None

    def _drive(self, make_thunk) -> Iterator[Any]:
        from ray_tpu_torch.parallel import flow

        thunks = (make_thunk(src, self.plan, i)
                  for i, src in enumerate(self.sources))
        stream = flow.RefStream(thunks, depth=self.window,
                                name=f"flow_{self.name}")
        try:
            for ref in stream:
                yield ref
                del ref
        finally:
            self.last_stream_stats = stream.stats()
            stream.close()

    def iter_block_refs(self) -> Iterator[Any]:
        return self._drive(_submit_thunk)

    def iter_count_refs(self) -> Iterator[Any]:
        return self._drive(_count_thunk)

    def materialize_refs(self) -> List[Any]:
        """Eager fan-out: every block's fused op chain submitted at once,
        refs returned in order."""
        return [_submit_thunk(src, self.plan, i)()
                for i, src in enumerate(self.sources)]
