"""Blocks: the unit of distributed data (counterpart of
``ray_tpu/data/block.py``; reference: python/ray/data/block.py).

The reference's block is a ``pyarrow.Table``.  The port's is a dict of
numpy columns of equal length (a row is one index into every column;
a column of rank > 1 holds one fixed-shape tensor a row), so the ingest
path imports no pyarrow.  Blocks travel as ObjectRefs; numpy arrays ride
the store's zero-copy path.  Only the numpy batch format is ported; the
pyarrow and pandas formats are ROADMAP Queue 1 item 1c.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

Block = Dict[str, np.ndarray]

NOT_PORTED = "is not ported yet (ROADMAP, Queue 1 item 1c)"


def not_ported(name: str):
    """A stand-in for what the ingest subset leaves out: it raises,
    naming ``name`` and the item that brings it."""
    def raise_not_ported(*args, **kwargs):
        raise NotImplementedError(f"{name} {NOT_PORTED}")

    raise_not_ported.__name__ = name.rsplit(".", 1)[-1]
    return raise_not_ported


def block_from_items(items: List[Any]) -> Block:
    if items and isinstance(items[0], dict):
        return {k: np.asarray([it[k] for it in items]) for k in items[0]}
    return {"item": np.asarray(items)}


def block_from_numpy(arrays: Dict[str, np.ndarray]) -> Block:
    return {k: np.asarray(v) for k, v in arrays.items()}


def block_to_numpy(block: Block) -> Dict[str, np.ndarray]:
    return dict(block)


def block_num_rows(block: Block) -> int:
    return len(next(iter(block.values()))) if block else 0


def block_to_rows(block: Block) -> List[dict]:
    """Rows as dicts of Python values (the reference's ``to_pylist``: a
    tensor column's row is a nested list)."""
    cols = {k: v.tolist() for k, v in block.items()}
    return [dict(zip(cols, vals)) for vals in zip(*cols.values())]


def block_slice(block: Block, start: int, end: int) -> Block:
    return {k: v[start:end] for k, v in block.items()}


def concat_blocks(blocks: List[Block]) -> Block:
    blocks = [b for b in blocks if block_num_rows(b) > 0] or blocks[:1]
    if len(blocks) == 1:
        return blocks[0]
    return {k: np.concatenate([b[k] for b in blocks]) for k in blocks[0]}


def check_batch_format(batch_format: str) -> None:
    if batch_format != "numpy":
        raise NotImplementedError(
            f"batch_format {batch_format!r} {NOT_PORTED}; use 'numpy'")


def apply_batch_fn(block: Block, fn) -> Block:
    """Run a user map_batches fn (numpy format) over one block."""
    result = fn(block_to_numpy(block))
    if not isinstance(result, dict):
        raise TypeError("numpy-format fn must return a dict of arrays")
    return block_from_numpy(result)
