"""Datasource plugin API, built-in file formats and the block writers
(counterpart of ``ray_tpu/data/datasource.py``; reference:
python/ray/data/datasource/datasource.py:20 and the format readers under
python/ray/data/datasource/).

A datasource is a callable ``(path, columns) -> block`` (a dict of numpy
columns, ``data/block.py``); ``register_datasource`` adds user formats,
and ``Dataset.read``/``read_streaming`` resolve formats through this one
registry so every executor sees the same plugins.

The numpy, text, binary and TFRecord readers and the CSV and JSON
readers and writers need nothing beyond numpy and the standard library.
The reference reads CSV and JSON with ``pyarrow.csv``/``pyarrow.json``
and writes CSV with ``pyarrow.csv``; the port's readers infer the types
that arrow infers (``_csv_column``, ``block.infer_column``) and its CSV
writer writes arrow's bytes (``write_csv_file``), so each package reads
the other's files back to the same columns.  Parquet needs pyarrow and
images need PIL, imported when such a file is read.

The TFRecord reader parses the TFRecord framing (length / masked-crc /
payload) and the tf.train.Example protobuf wire format directly — no
tensorflow dependency.

Copied from ``ray_tpu/data/datasource.py`` (the JAX package).
"""
from __future__ import annotations

import csv
import datetime
import glob as glob_mod
import json
import os
import re
import struct
from typing import Any, Callable, Dict, List

import numpy as np

from ray_tpu_torch.data.block import (
    Block,
    block_from_arrow,
    block_from_numpy,
    block_to_arrow,
    block_to_rows,
    infer_column,
    object_column,
    require,
)


# ---------------- CSV types, as pyarrow.csv infers them ----------------

# pyarrow.csv's default null spellings (ConvertOptions.null_values).  A
# string column keeps them as strings (strings_can_be_null=False).
_CSV_NULLS = frozenset([
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "N/A", "NA", "NULL", "NaN", "n/a", "nan", "null"])
_CSV_TRUE = frozenset(["1", "True", "TRUE", "true"])
_CSV_FALSE = frozenset(["0", "False", "FALSE", "false"])
_INT = re.compile(r"-?\d+|0[xX][0-9a-fA-F]+")
_FLOAT = re.compile(r"[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?"
                    r"|[+-]?(?i:inf|infinity)")
_TIME = re.compile(r"(\d{2}):(\d{2})(?::(\d{2}))?")
_STAMP = re.compile(r"(\d{4}-\d{2}-\d{2})(?:[ T](\d{2}):(\d{2})"
                    r"(?::(\d{2})(\.\d{1,9})?)?)?(Z|[+-]\d{2}:?\d{2})?")


def _trim(s: str) -> str:
    # arrow's numeric and date parsers skip spaces and tabs at both ends;
    # its boolean parser does not.
    return s.strip(" \t")


def _parse_int(s: str):
    s = _trim(s)
    if not _INT.fullmatch(s):
        return None
    v = int(s, 16) if s[:2] in ("0x", "0X") else int(s)
    return v if -2**63 <= v < 2**63 else None


def _parse_float(s: str):
    s = _trim(s)
    return float(s) if _FLOAT.fullmatch(s) else None


def _parse_bool(s: str):
    return True if s in _CSV_TRUE else False if s in _CSV_FALSE else None


def _parse_date(s: str):
    s = _trim(s)
    if not re.fullmatch(r"\d{4}-\d{2}-\d{2}", s):
        return None
    try:
        datetime.date.fromisoformat(s)
    except ValueError:
        return None
    return np.datetime64(s, "D")


def _parse_time(s: str):
    m = _TIME.fullmatch(_trim(s))
    if not m:
        return None
    h, mi, sec = int(m[1]), int(m[2]), int(m[3] or 0)
    if h > 23 or mi > 59 or sec > 59:
        return None
    return datetime.time(h, mi, sec)


def _parse_stamp(s: str, unit: str):
    """A timestamp in ``unit`` ("s" refuses a fraction of a second), UTC
    where the text gives an offset, as arrow stores it."""
    m = _STAMP.fullmatch(_trim(s))
    if not m:
        return None
    day, h, mi, sec, frac, zone = m.groups()
    if frac and unit == "s":
        return None
    try:
        base = datetime.datetime.fromisoformat(day).replace(
            hour=int(h or 0), minute=int(mi or 0), second=int(sec or 0))
    except ValueError:
        return None
    if zone and zone != "Z":
        sign = 1 if zone[0] == "+" else -1
        digits = zone[1:].replace(":", "")
        base -= sign * datetime.timedelta(hours=int(digits[:2]),
                                          minutes=int(digits[2:]))
    value = np.datetime64(base.replace(tzinfo=None), unit)
    if frac:
        value += np.timedelta64(int(frac[1:].ljust(9, "0")), "ns")
    return value


def _column_of(values, parse, dtype, missing):
    """Parse every non-null value with ``parse``; None if one fails."""
    out = []
    for v in values:
        if v is None:
            out.append(missing)
            continue
        p = parse(v)
        if p is None:
            return None
        out.append(p)
    if dtype is object:
        return object_column(out)
    return np.asarray(out, dtype=dtype)


def _csv_column(raw: List[str]) -> np.ndarray:
    """One CSV column typed as pyarrow.csv infers it and as
    ``np.asarray`` then gives it: the first of null, int64, bool, date32,
    time32[s], timestamp[s], timestamp[ns], float64 that every non-null
    value parses as, else string (object array of str, nulls kept as
    text).  An int64 column with a null becomes float64 with NaN, a bool
    one an object array with None, as arrow's to_numpy gives them."""
    values = [None if v in _CSV_NULLS else v for v in raw]
    if all(v is None for v in values):
        return object_column([None] * len(values))
    has_null = any(v is None for v in values)
    # arrow gives one timezone to a column: text with an offset and text
    # without one do not make a timestamp column together.
    zones = {bool(m[6]) for m in (_STAMP.fullmatch(_trim(v))
                                  for v in values if v is not None) if m}
    stamp = _parse_stamp if len(zones) < 2 else (lambda s, unit: None)
    candidates = (
        (_parse_int, np.float64 if has_null else np.int64, np.nan),
        (_parse_bool, object if has_null else bool, None),
        (_parse_date, "datetime64[D]", np.datetime64("NaT")),
        (_parse_time, object, None),
        (lambda s: stamp(s, "s"), "datetime64[s]", np.datetime64("NaT")),
        (lambda s: stamp(s, "ns"), "datetime64[ns]",
         np.datetime64("NaT")),
        (_parse_float, np.float64, np.nan),
    )
    for parse, dtype, missing in candidates:
        col = _column_of(values, parse, dtype, missing)
        if col is not None:
            return col
    return object_column(list(raw))


# ---------------- built-in readers ----------------

def read_parquet_file(path: str, columns=None) -> Block:
    pq = require("pyarrow.parquet", "the parquet format")
    return block_from_arrow(pq.read_table(path, columns=columns))


def _select(block: Block, columns) -> Block:
    return {k: block[k] for k in columns} if columns else block


def read_csv_file(path: str, columns=None) -> Block:
    """Comma-separated, double-quoted, the first row the header; blank
    lines are skipped (pyarrow.csv's defaults)."""
    with open(path, newline="", encoding="utf-8") as f:
        rows = [r for r in csv.reader(f) if r]
    if not rows:
        raise ValueError(f"{path}: empty CSV file (no header)")
    header, body = rows[0], rows[1:]
    if len(set(header)) != len(header):
        raise ValueError(f"{path}: a column name appears twice: {header}")
    for i, r in enumerate(body):
        if len(r) != len(header):
            raise ValueError(f"{path}: row {i + 1} has {len(r)} columns, "
                             f"expected {len(header)}")
    return _select({name: _csv_column([r[j] for r in body])
                    for j, name in enumerate(header)}, columns)


def read_json_file(path: str, columns=None) -> Block:
    """Newline-delimited JSON objects; columns in order of first
    appearance, a missing field null (pyarrow.json's read_json)."""
    rows = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            if line.strip():
                rows.append(json.loads(line))
    names: List[str] = []
    for r in rows:
        for k in r:
            if k not in names:
                names.append(k)
    block = {}
    for k in names:
        values = [r.get(k) for r in rows]
        present = [v for v in values if v is not None]
        if present and all(isinstance(v, str) for v in present):
            # pyarrow.json reads strings as timestamp[s] where every one
            # parses as a date, or a date and a time to the second.
            stamps = _column_of(values, lambda v: _parse_stamp(v, "s"),
                                "datetime64[s]", np.datetime64("NaT"))
            if stamps is not None:
                block[k] = stamps
                continue
        block[k] = infer_column(values)
    return _select(block, columns)


def read_numpy_file(path: str, columns=None) -> Block:
    arr = np.load(path)
    if isinstance(arr, np.lib.npyio.NpzFile):
        with arr:
            return block_from_numpy({k: arr[k] for k in arr.files})
    return block_from_numpy({"data": arr})


def read_text_file(path: str, columns=None) -> Block:
    with open(path, "r", errors="replace") as f:
        lines = f.read().splitlines()
    return {"text": object_column(lines)}


def read_binary_file(path: str, columns=None) -> Block:
    with open(path, "rb") as f:
        data = f.read()
    return {"bytes": object_column([data]), "path": object_column([path])}


def read_image_file(path: str, columns=None) -> Block:
    """Decode one image to an HWC uint8 row (reference:
    image_datasource.py — decoded via PIL).  The image column keeps its
    ndarray shape, (1, H, W, 3)."""
    image = require("PIL.Image", "the images format")
    with image.open(path) as im:
        arr = np.asarray(im.convert("RGB"), dtype=np.uint8)
    return {"image": arr[None], "height": np.asarray([arr.shape[0]]),
            "width": np.asarray([arr.shape[1]]), "path": object_column([path])}


# ---------------- TFRecord / tf.train.Example ----------------

def _read_varint(buf: bytes, pos: int):
    result, shift = 0, 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _parse_fields(buf: bytes):
    """Yield (field_number, wire_type, value) from a protobuf message."""
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wire == 1:  # 64-bit
            val = buf[pos:pos + 8]
            pos += 8
        elif wire == 2:  # length-delimited
            n, pos = _read_varint(buf, pos)
            val = buf[pos:pos + n]
            pos += n
        elif wire == 5:  # 32-bit
            val = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _parse_feature(buf: bytes):
    """tf.train.Feature: oneof bytes_list=1 / float_list=2 / int64_list=3."""
    for field, _wire, val in _parse_fields(buf):
        vals: List[Any] = []
        if field == 1:  # BytesList.value = 1 (repeated bytes)
            vals = [v for f, _w, v in _parse_fields(val) if f == 1]
        elif field == 2:  # FloatList.value = 1 (repeated float, packed)
            for f, w, v in _parse_fields(val):
                if f == 1 and w == 2:  # packed
                    vals.extend(struct.unpack(f"<{len(v) // 4}f", v))
                elif f == 1:
                    vals.append(struct.unpack("<f", v)[0])
        elif field == 3:  # Int64List.value = 1 (repeated int64, packed)
            for f, w, v in _parse_fields(val):
                if f == 1 and w == 2:
                    pos = 0
                    while pos < len(v):
                        x, pos = _read_varint(v, pos)
                        vals.append(x - (1 << 64) if x >= (1 << 63) else x)
                elif f == 1:
                    vals.append(v - (1 << 64) if v >= (1 << 63) else v)
        return vals
    return []


def _parse_example(buf: bytes) -> Dict[str, Any]:
    """tf.train.Example { Features features = 1 };
    Features { map<string, Feature> feature = 1 }."""
    row: Dict[str, Any] = {}
    for field, _w, val in _parse_fields(buf):
        if field != 1:
            continue
        for f2, _w2, entry in _parse_fields(val):
            if f2 != 1:
                continue
            key, feat = None, b""
            for f3, _w3, v3 in _parse_fields(entry):
                if f3 == 1:
                    key = v3.decode()
                elif f3 == 2:
                    feat = v3
            if key is not None:
                vals = _parse_feature(feat)
                row[key] = vals[0] if len(vals) == 1 else vals
    return row


def read_tfrecord_file(path: str, columns=None) -> Block:
    """TFRecord framing: uint64 length, uint32 masked-crc(length), payload,
    uint32 masked-crc(payload).  CRCs are skipped (trusted local files)."""
    rows: List[Dict[str, Any]] = []
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                break
            (length,) = struct.unpack("<Q", header)
            f.read(4)  # length crc
            payload = f.read(length)
            f.read(4)  # payload crc
            rows.append(_parse_example(payload))
    keys: List[str] = []
    for r in rows:
        for k in r:
            if k not in keys:
                keys.append(k)
    if columns:
        keys = [k for k in keys if k in columns]
    return {k: infer_column([r.get(k) for r in rows]) for k in keys}


# ---------------- writers (one file per block) ----------------

def _arrow_float(x, float32: bool) -> str:
    """``x`` as arrow's CSV writer spells it: the shortest digits that
    read back to the value, fixed notation for decimal exponents -6..9,
    otherwise ``d.ddde+NN``; no trailing ``.0``."""
    if np.isnan(x):
        return "nan"
    if np.isinf(x):
        return "inf" if x > 0 else "-inf"
    sci = np.format_float_scientific(np.float32(x) if float32 else
                                     np.float64(x), unique=True, trim="-")
    mantissa, exp = sci.split("e")
    e = int(exp)
    sign = "-" if mantissa.startswith("-") else ""
    digits = mantissa.lstrip("-").replace(".", "")
    if not -7 < e < 10:
        body = digits[0] + ("." + digits[1:] if len(digits) > 1 else "")
        return f"{sign}{body}e{'+' if e >= 0 else '-'}{abs(e)}"
    if e < 0:
        return f"{sign}0.{'0' * (-e - 1)}{digits}"
    whole = digits[:e + 1].ljust(e + 1, "0")
    frac = digits[e + 1:]
    return f"{sign}{whole}" + (f".{frac}" if frac else "")


def _quote(text: str) -> str:
    return '"' + text.replace('"', '""') + '"'


def _csv_cells(col: np.ndarray) -> List[str]:
    if col.ndim > 1:
        raise TypeError("CSV cannot hold a tensor column (shape "
                        f"{col.shape[1:]} a row)")
    kind = col.dtype.kind
    if kind == "b":
        return ["true" if v else "false" for v in col]
    if kind in "iu":
        return [str(int(v)) for v in col]
    if kind == "f":
        f32 = col.dtype.itemsize <= 4
        return [_arrow_float(v, f32) for v in col]
    if kind == "M":
        return ["" if np.isnat(v) else str(v).replace("T", " ")
                for v in col]
    cells = []
    for v in col:
        if v is None:
            cells.append("")
        elif isinstance(v, bytes):
            cells.append(_quote(v.decode("utf-8", "surrogateescape")))
        else:
            cells.append(_quote(str(v)))
    return cells


def write_csv_file(block: Block, path: str) -> None:
    """The bytes pyarrow.csv.write_csv writes for the same table: quoted
    header, strings quoted with doubled quotes, nulls empty, booleans
    ``true``/``false``, floats as ``_arrow_float``."""
    cols = [_csv_cells(v) for v in block.values()]
    lines = [",".join(_quote(k) for k in block)]
    lines.extend(",".join(cells) for cells in zip(*cols))
    with open(path, "w", encoding="utf-8", errors="surrogateescape",
              newline="") as f:
        f.write("\n".join(lines) + "\n")


def write_json_file(block: Block, path: str) -> None:
    with open(path, "w") as f:
        for row in block_to_rows(block):
            f.write(json.dumps(row) + "\n")


def write_parquet_file(block: Block, path: str) -> None:
    pq = require("pyarrow.parquet", "the parquet format")
    pq.write_table(block_to_arrow(block), path)


WRITERS = {"parquet": write_parquet_file, "csv": write_csv_file,
           "json": write_json_file}


# ---------------- registry ----------------

_DATASOURCES: Dict[str, Callable] = {
    "parquet": read_parquet_file,
    "csv": read_csv_file,
    "json": read_json_file,
    "numpy": read_numpy_file,
    "text": read_text_file,
    "binary": read_binary_file,
    "images": read_image_file,
    "tfrecord": read_tfrecord_file,
}


def register_datasource(fmt: str, reader: Callable):
    """Plug a user format into every read path: ``reader(path, columns)``
    must return a block, a dict of equal-length numpy columns (reference:
    custom Datasource support, datasource.py:20)."""
    _DATASOURCES[fmt] = reader


def resolve_datasource(fmt: str) -> Callable:
    try:
        return _DATASOURCES[fmt]
    except KeyError:
        raise ValueError(
            f"unknown format {fmt!r}; known: {sorted(_DATASOURCES)} "
            "(add formats with ray_tpu_torch.data.register_datasource)"
        ) from None


def expand_paths(paths) -> List[str]:
    if isinstance(paths, str):
        if os.path.isdir(paths):
            out = []
            for root, dirs, files in os.walk(paths):
                dirs[:] = [d for d in dirs if not d.startswith(".")]
                out.extend(os.path.join(root, f) for f in files
                           if not f.startswith("."))
            return sorted(out)
        return sorted(p for p in glob_mod.glob(paths)
                      if os.path.isfile(p)) or [paths]
    return list(paths)

