"""Blocks: the unit of distributed data (counterpart of
``ray_tpu/data/block.py``; reference: python/ray/data/block.py).

The reference's block is a ``pyarrow.Table``.  The port's is a dict of
numpy columns of equal length (a row is one index into every column;
a column of rank > 1 holds one fixed-shape tensor a row, kept as it is,
where the reference needs a FixedSizeList and schema metadata), so no
path that the card's machine runs imports pyarrow, pandas or PIL.  The
columns take the dtypes that the reference's ``block_to_numpy`` gives:
int64, float64, bool, datetime64, and strings and bytes as numpy object
arrays of Python ``str`` and ``bytes`` (``as_column``).  Blocks travel as
ObjectRefs; numpy arrays ride the store's zero-copy path.

The ``pandas`` and ``pyarrow`` batch formats convert a block when a
function asks for them, importing the package then (``require``).
"""
from __future__ import annotations

import numbers
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np

Block = Dict[str, np.ndarray]


def require(package: str, what: str):
    """Import ``package`` for ``what`` (a format or a batch format), or
    raise an ImportError that names both: nothing falls back quietly."""
    import importlib

    try:
        return importlib.import_module(package)
    except ImportError as e:
        raise ImportError(
            f"{what} needs the {package.split('.')[0]!r} package, which "
            "is not installed") from e


# ---------------- columns ----------------

def object_column(values: Sequence[Any]) -> np.ndarray:
    """An object array holding each value as it is (``np.asarray`` would
    turn equal-length lists into a second axis)."""
    out = np.empty(len(values), dtype=object)
    for i, v in enumerate(values):
        out[i] = v
    return out


def as_column(values) -> np.ndarray:
    """A numpy column with the dtype the reference's arrow round trip
    gives: strings and bytes become object arrays (a fixed-width unicode
    array would hash and print differently from the reference's Python
    strings); other arrays are kept as they are."""
    arr = np.asarray(values)
    if arr.dtype.kind in "US":
        kind = str if arr.dtype.kind == "U" else bytes
        return object_column([kind(v) for v in arr.ravel()]).reshape(
            arr.shape)
    return arr


def infer_column(values: Sequence[Any]) -> np.ndarray:
    """A column from Python values, typed as ``pyarrow.array`` infers them
    and ``block_to_numpy`` then gives them: bools -> bool (object where a
    value is None); ints -> int64 (float64 with NaN for None; float64 past
    int64's range); ints and floats -> float64; str and bytes -> object;
    lists and arrays -> an object array of arrays, each inferred the same
    way; dicts -> object; all None -> object Nones.  Mixing strings with
    numbers raises, as arrow does."""
    present = [v for v in values if v is not None]
    has_none = len(present) < len(values)
    if not present:
        return object_column(list(values))
    if all(isinstance(v, (bool, np.bool_)) for v in present):
        if has_none:
            return object_column([None if v is None else bool(v)
                                  for v in values])
        return np.asarray(values, dtype=bool)
    if all(isinstance(v, numbers.Number) and not isinstance(v, (bool, np.bool_))
           for v in present):
        ints = all(isinstance(v, numbers.Integral) for v in present)
        if ints and all(-2**63 <= int(v) < 2**63 for v in present) \
                and not has_none:
            return np.asarray([int(v) for v in values], dtype=np.int64)
        return np.asarray([np.nan if v is None else float(v)
                           for v in values], dtype=np.float64)
    if all(isinstance(v, str) for v in present) or \
            all(isinstance(v, bytes) for v in present):
        return object_column(list(values))
    if all(isinstance(v, (list, tuple, np.ndarray)) for v in present):
        # One item type for the whole column (arrow's list<T>): infer it
        # over every row's items, then cut the rows apart again.
        flat = infer_column([x for v in present for x in v])
        ends = np.cumsum([len(v) for v in present])
        rows = iter(np.split(flat, ends[:-1]))
        return object_column([None if v is None else next(rows)
                              for v in values])
    if all(isinstance(v, dict) for v in present):
        return object_column(list(values))
    raise TypeError("cannot infer one column type from values of types "
                    f"{sorted({type(v).__name__ for v in present})}")


# ---------------- blocks ----------------

def block_from_items(items: List[Any]) -> Block:
    if items and isinstance(items[0], dict):
        return {k: infer_column([it[k] for it in items]) for k in items[0]}
    return {"item": infer_column(items)}


def block_from_numpy(arrays: Dict[str, np.ndarray]) -> Block:
    return {k: as_column(v) for k, v in arrays.items()}


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
    """Rows [start, end); a 0-row slice keeps every dtype and inner
    shape (the schema of an empty block)."""
    return {k: v[start:end] for k, v in block.items()}


def block_take(block: Block, indices) -> Block:
    indices = np.asarray(indices, dtype=np.int64)
    return {k: v[indices] for k, v in block.items()}


def block_filter(block: Block, mask) -> Block:
    mask = np.asarray(mask, dtype=bool)
    return {k: v[mask] for k, v in block.items()}


Schema = Dict[str, Tuple[np.dtype, Tuple[int, ...]]]


def block_schema(block: Block) -> Schema:
    """``{name: (dtype, inner shape)}``: a scalar column's inner shape is
    ``()``, a tensor column's the shape of one row."""
    return {k: (v.dtype, tuple(v.shape[1:])) for k, v in block.items()}


def concat_blocks(blocks: List[Block]) -> Block:
    blocks = [b for b in blocks if block_num_rows(b) > 0] or blocks[:1]
    if len(blocks) == 1:
        return blocks[0]
    return {k: np.concatenate([b[k] for b in blocks]) for k in blocks[0]}


# ---------------- the pyarrow and pandas formats ----------------

def block_to_arrow(block: Block):
    """A ``pyarrow.Table`` of the block, as the reference's
    ``block_from_numpy`` builds one: tensor columns as FixedSizeList with
    their inner shape in the schema's metadata."""
    pa = require("pyarrow", "the pyarrow batch format")
    cols, meta = {}, {}
    for k, v in block.items():
        if v.ndim <= 1:
            cols[k] = pa.array(v)
        else:
            flat = v.reshape(len(v), -1)
            cols[k] = pa.chunked_array([pa.FixedSizeListArray.from_arrays(
                pa.array(flat.ravel()), flat.shape[1])])
            meta[f"shape:{k}".encode()] = ",".join(
                map(str, v.shape[1:])).encode()
    table = pa.table(cols)
    if meta:
        table = table.replace_schema_metadata(
            {**(table.schema.metadata or {}), **meta})
    return table


def block_from_arrow(table) -> Block:
    """The reference's ``block_to_numpy``: FixedSizeList columns take back
    their inner shape from the schema's metadata."""
    pa = require("pyarrow", "the pyarrow batch format")
    out = {}
    meta = table.schema.metadata or {}
    for name in table.column_names:
        arr = table.column(name).combine_chunks()
        if pa.types.is_fixed_size_list(arr.type):
            flat = np.asarray(arr.values)
            shape = meta.get(f"shape:{name}".encode())
            inner = (tuple(int(x) for x in shape.decode().split(","))
                     if shape else (arr.type.list_size,))
            out[name] = flat.reshape((len(table),) + inner)
        else:
            out[name] = as_column(np.asarray(arr))
    return out


def block_to_pandas(block: Block):
    pd = require("pandas", "the pandas batch format")
    # A tensor column becomes one array a row, as arrow's to_pandas gives.
    return pd.DataFrame({k: (list(v) if v.ndim > 1 else v)
                         for k, v in block.items()})


def block_from_pandas(frame) -> Block:
    out = {}
    for name in frame.columns:
        col = frame[name].to_numpy()
        if col.dtype == object and len(col) and all(
                isinstance(v, np.ndarray) for v in col) and \
                len({v.shape for v in col}) == 1:
            col = np.stack(list(col))
        out[str(name)] = as_column(col)
    return out


def apply_batch_fn(block: Block, fn, batch_format: str = "numpy") -> Block:
    """Run a user map_batches fn over one block, in ``batch_format``
    (numpy: a dict of arrays; pandas: a DataFrame; pyarrow: a Table)."""
    if batch_format == "numpy":
        result = fn(block_to_numpy(block))
        if isinstance(result, dict):
            return block_from_numpy(result)
        if type(result).__module__.startswith("pyarrow"):
            return block_from_arrow(result)
        raise TypeError("numpy-format fn must return a dict of arrays "
                        "or a pyarrow Table")
    if batch_format == "pandas":
        return block_from_pandas(fn(block_to_pandas(block)))
    if batch_format == "pyarrow":
        return block_from_arrow(fn(block_to_arrow(block)))
    raise ValueError(f"bad batch_format {batch_format!r}")


def format_batch(batch: Dict[str, np.ndarray], batch_format: str):
    """A numpy batch in the format an iterator was asked for."""
    if batch_format == "numpy":
        return batch
    if batch_format == "pandas":
        return block_to_pandas(batch)
    if batch_format == "pyarrow":
        return block_to_arrow(batch)
    raise ValueError(f"bad batch_format {batch_format!r}")
