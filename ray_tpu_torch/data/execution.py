"""Streaming plan execution for the eager Dataset API (counterpart of
``ray_tpu/data/execution.py``; reference: ray.data's lazy ExecutionPlan +
StreamingExecutor, python/ray/data/_internal/plan.py,
_internal/execution/streaming_executor.py:31).

``Dataset.map_batches`` appends a *plan op* to a lazy plan, and
consumption drives the plan through a bounded
:class:`ray_tpu_torch.parallel.flow.RefStream`: one fused task per block
applies the whole op chain, and at most ``window`` output blocks are in
flight or resident at once.  Plan ops are ``(kind, fn, batch_format)``
tuples, or ``(kind, fn, batch_format, num_gpus)`` for an op whose task
must reach the card (``BatchPredictor``'s): a block's fused task asks for
the largest share its ops name.  The port has one kind, ``"map_batches"``: the reference's
``filter``, indexed maps (for ``random_shuffle``) and lazy read sources
are ROADMAP Queue 1 item 1c.

Copied from ``ray_tpu/data/execution.py`` (the JAX package), cut to the
ingest subset.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Optional, Sequence, Tuple

import ray_tpu_torch
from ray_tpu_torch.data.block import apply_batch_fn, block_num_rows

# Default bound on in-flight/resident output blocks for plan-driving
# consumers (iter_batches / count / take).
DEFAULT_WINDOW = 4

PlanOp = Tuple  # (kind, fn, batch_format[, num_gpus])


def apply_op(blk, op: PlanOp):
    """Apply ONE plan op to a block."""
    kind, fn = op[0], op[1]
    if kind == "map_batches":
        return apply_batch_fn(blk, fn)
    raise ValueError(f"unknown plan op {kind!r}")


def apply_ops(blk, ops: Sequence[PlanOp]):
    for op in ops:
        blk = apply_op(blk, op)
    return blk


@ray_tpu_torch.remote
def _apply_ops_task(blk, ops):
    return apply_ops(blk, ops)


@ray_tpu_torch.remote
def _count_after_ops(blk, ops):
    """Count-only consumption: the transformed block lives and dies
    inside this task; only the row count crosses the store."""
    return block_num_rows(apply_ops(blk, ops))


def _with_gpus(task, ops: Sequence[PlanOp]):
    """``task`` asking for the largest GPU share among ``ops``."""
    gpus = max((op[3] for op in ops if len(op) > 3), default=0)
    return task.options(num_gpus=gpus) if gpus else task


def _submit_thunk(src, ops: List[PlanOp]) -> Callable[[], Any]:
    """One submit thunk per block for the RefStream: a ref with ops
    chains them in one task; a ref with no ops passes through untouched
    (no task, no copy)."""
    if ops:
        task = _with_gpus(_apply_ops_task, ops)
        return lambda: task.remote(src, ops)
    return lambda: src


def _count_thunk(src, ops: List[PlanOp]) -> Callable[[], Any]:
    task = _with_gpus(_count_after_ops, ops)
    return lambda: task.remote(src, ops)


class PlanExecutor:
    """Drive a (sources, plan) pair as a bounded pipelined block stream.

    ``iter_block_refs`` yields output block refs in source order with at
    most ``window`` in flight; the caller drops each yielded ref once
    consumed to release its store copy."""

    def __init__(self, sources: Sequence[Any], plan: Sequence[PlanOp],
                 window: Optional[int] = None, name: str = "dataset"):
        self.sources = list(sources)
        self.plan = list(plan)
        self.window = max(1, int(window or DEFAULT_WINDOW))
        self.name = name

    def _drive(self, make_thunk) -> Iterator[Any]:
        from ray_tpu_torch.parallel import flow

        thunks = (make_thunk(src, self.plan) for src in self.sources)
        stream = flow.RefStream(thunks, depth=self.window,
                                name=f"flow_{self.name}")
        try:
            for ref in stream:
                yield ref
                del ref
        finally:
            stream.close()

    def iter_block_refs(self) -> Iterator[Any]:
        return self._drive(_submit_thunk)

    def iter_count_refs(self) -> Iterator[Any]:
        return self._drive(_count_thunk)

    def materialize_refs(self) -> List[Any]:
        """Eager fan-out: every block's fused op chain submitted at once,
        refs returned in order."""
        return [_submit_thunk(src, self.plan)() for src in self.sources]
