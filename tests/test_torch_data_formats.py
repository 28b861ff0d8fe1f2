"""The port's Data (readers, writers, sort, groupby, filter, repartition,
shuffle, zip, the batch formats, preprocessors) against the JAX
package's: the counterpart of ``tests/test_data_formats.py`` and the Data
half of ``tests/test_data_serve_util.py``.

The same seeded inputs go through ``ray_tpu.data`` (pyarrow blocks) and
``ray_tpu_torch.data`` (blocks of numpy columns), each in its own cluster
started once for the module, one after the other.  Every scenario keeps
its reference test's name.  Where the reference defines an order (sort,
repartition, ``random_shuffle`` under a seed, the readers, the writers'
round trips) the blocks are compared bit for bit: the same blocks, and
in each the same columns with the same dtype, shape and bytes (object
columns element by element).  Groupby is compared block by block after
sorting each block by its key, since the order of groups within a block
is pyarrow's ``group_by`` order in the reference; the partition each key
lands in is the reference's.  ``test_batch_predictor_over_dataset``'s
counterpart is ``tests/test_torch_predictor.py``.

Decided differences, each held here: a string column is a numpy object
array of Python ``str`` (``test_strings_are_object_arrays``); ``schema()``
is ``{name: (dtype, inner shape)}``; a tensor column (an image too)
keeps its ndarray shape; a null in a numpy block is NaN/None, so an int64
key with a null is float64 in its block (the promotion scenario).

The card's machine has no pyarrow, pandas or PIL:
``test_card_formats_import_no_pyarrow_pandas_or_pil`` hides the three
and drives every format that needs none of them in local mode."""
import importlib
import json
import os
import struct
import sys

import numpy as np
import pytest
import torch

T = 60  # seconds: the bound of every get and wait
MB = 1024 * 1024
PACKAGES = ("ray_tpu", "ray_tpu_torch")


@pytest.fixture(scope="module", autouse=True)
def one_thread_and_fns_by_value():
    import cloudpickle

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    cloudpickle.register_pickle_by_value(sys.modules[__name__])
    yield
    cloudpickle.unregister_pickle_by_value(sys.modules[__name__])
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# Inputs (the reference tests' own), written once for both packages
# ---------------------------------------------------------------------------
def _varint(n):
    out = b""
    while True:
        b7 = n & 0x7F
        n >>= 7
        out += bytes([b7 | (0x80 if n else 0)])
        if not n:
            return out


def _write_tfrecord_example(f, feats):
    """Hand-encode a tf.train.Example proto + TFRecord frame
    (test_data_formats.py's writer)."""
    def ld(field, payload):  # length-delimited
        return _varint((field << 3) | 2) + _varint(len(payload)) + payload

    feat_entries = b""
    for name, val in feats.items():
        if isinstance(val, bytes):
            flist = ld(1, ld(1, val))
        elif isinstance(val, float):
            flist = ld(2, _varint((1 << 3) | 5) + struct.pack("<f", val))
        else:
            flist = ld(3, _varint((1 << 3) | 0) + _varint(val))
        feat_entries += ld(1, ld(1, name.encode()) + ld(2, flist))
    example = ld(1, feat_entries)
    f.write(struct.pack("<Q", len(example)))
    f.write(b"\x00" * 4)
    f.write(example)
    f.write(b"\x00" * 4)


# Type inference: what pyarrow.csv and pyarrow.json infer, and where the
# two packages could disagree (empty fields, null spellings, quoting,
# padded numbers, dates and times, ints past int64).
CSV_FILES = {
    "types.csv": (
        'i,f,b,s,q,e,n,d,t,ts,pad,big,bn,sn\n'
        '1,1.5,true,x,"a,b",,NA,2020-01-01,10:00,2020-01-01 10:00:00,'
        ' 7 ,9223372036854775808,true,NA\n'
        '-2,-0.25,False,y z,"say ""hi""",3,null,2020-02-29,23:59:59,'
        '2020-01-01T10:00:01,\t8,1,,x\n'
        '0x1F,1e5,TRUE,,"",,nan,1999-12-31,00:00,2021-06-30 23:59,'
        '9 ,2,false,\n'),
    "mixed.csv": (
        'a,b,c,d\n'
        '1,2020-01-01,+5,1\n'
        '2,2020-01-01 10:00:00,007,0\n'
        '\n'
        '3,2020-01-02,inf,1\n'),
    "header_only.csv": 'a,b\n',
    "ns.csv": 'x,y\n2020-01-01 10:00:00.5,1.\n2020-01-01T10:00:00Z,.5\n',
}
JSON_FILES = {
    "types.json": [
        {"i": 1, "f": 1.5, "m": 1, "b": True, "s": "x", "l": [1, 2],
         "d": {"x": 1}, "ts": "2020-01-01", "n": None},
        {"i": 2, "f": 2.5, "m": 2.5, "b": None, "s": None, "l": [3],
         "d": {"x": 2}, "ts": "2020-01-01 10:00:00", "extra": "late"},
        {"i": 3, "f": -0.5, "m": 3, "b": False, "s": "z", "l": [4.5, None],
         "ts": None},
    ],
    "missing.json": [{"b": 1, "a": 2}, {"a": 3, "c": 4}, {"a": 5}],
}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("data_formats_inputs")
    (root / "data.rot13").write_text("uryyb\njbeyq\n")
    (root / "a.txt").write_text("one\ntwo\n")
    (root / "b.bin").write_bytes(b"\x00\x01\x02")
    from PIL import Image

    arr = (np.arange(12 * 10 * 3) % 255).reshape(12, 10, 3).astype(np.uint8)
    Image.fromarray(arr).save(root / "img.png")
    with open(root / "data.tfrecord", "wb") as f:
        _write_tfrecord_example(f, {"label": 7, "name": b"seven",
                                    "score": 0.5})
        _write_tfrecord_example(f, {"label": 9, "name": b"nine",
                                    "score": 1.5})
    np.save(root / "m.npy", np.arange(12, dtype=np.float32).reshape(3, 4))
    np.savez(root / "z.npz", a=np.arange(6).reshape(3, 2),
             s=np.array(["p", "q", "r"]))
    import pyarrow as pa
    import pyarrow.parquet as pq

    pq.write_table(pa.table({"a": list(range(10))}),
                   str(root / "part0.parquet"))
    for name, text in CSV_FILES.items():
        (root / name).write_text(text)
    for name, rows in JSON_FILES.items():
        (root / name).write_text("".join(json.dumps(r) + "\n"
                                         for r in rows))
    return root


# ---------------------------------------------------------------------------
# One package's run of every scenario
# ---------------------------------------------------------------------------
def _rot13_reader(pkg_name):
    def read_rot13(path, columns=None):
        import codecs

        with open(path) as f:
            lines = [codecs.decode(ln, "rot13")
                     for ln in f.read().splitlines()]
        if pkg_name == "ray_tpu":
            import pyarrow as pa

            return pa.table({"text": lines})
        return {"text": np.asarray(lines, dtype=object)}

    return read_rot13


def _run(pkg_name: str, inp, out) -> dict:
    """Every scenario through one package in its own cluster: a dict of
    results (lists of numpy blocks, batches, rows or plain values)."""
    pkg = importlib.import_module(pkg_name)
    data = importlib.import_module(f"{pkg_name}.data")
    to_numpy = importlib.import_module(f"{pkg_name}.data.block"
                                       ).block_to_numpy
    pkg.init(num_cpus=2, object_store_memory=256 * MB)

    def get(ref):
        return pkg.get(ref, timeout=T)

    def blocks(ds):
        """Each output block as numpy columns, in block order."""
        return [to_numpy(get(ref)) for ref in ds._blocks]

    def batches(ds, n=256, **kw):
        return list(ds.iter_batches(n, **kw))

    r = {}
    try:
        # ---- sort
        vals = np.random.default_rng(0).integers(0, 10_000, size=2_000)
        r["sort_ints_across_blocks"] = blocks(
            data.from_numpy({"v": vals}, parallelism=8).sort("v"))
        words = [f"w{i:04d}"
                 for i in np.random.default_rng(1).permutation(300)]
        ds = data.from_items([{"k": w} for w in words], parallelism=4)
        r["sort_descending_and_strings"] = [
            blocks(ds.sort("k", descending=True)),
            list(ds.sort("k", descending=True).iter_rows())]

        # ---- groupby
        ds = data.from_items([{"k": i % 5, "v": float(i)}
                              for i in range(1000)], parallelism=8)
        g = ds.groupby("k")
        r["groupby_sum_mean_count"] = [
            blocks(g.sum("v")), blocks(g.count()), blocks(g.mean("v")),
            blocks(g.min("v")), blocks(g.max("v")),
            blocks(g.aggregate(("v", "sum"), ("v", "count")))]
        r["groupby_std"] = blocks(g.std("v"))
        ds = data.from_items([{"name": n, "x": 1}
                              for n in ["a", "b", "c"] * 100],
                             parallelism=6)
        r["groupby_string_keys_stable_across_workers"] = [blocks(
            ds.groupby("name").sum("x"))]
        ds = data.from_items([{"k": i % 2, "v": 1.0} for i in range(100)],
                             parallelism=8)
        agg = ds.groupby("k", num_partitions=6).sum("v")
        r["groupby_more_partitions_than_keys"] = [
            blocks(agg), [b for b in batches(agg) if "v_sum" in b]]

        # ---- datasources
        data.register_datasource("rot13", _rot13_reader(pkg_name))
        path = str(inp / "data.rot13")
        r["custom_datasource_plugin"] = [
            list(data.read_datasource("rot13", path).iter_rows()),
            batches(data.read_streaming(path, "rot13"))]
        r["read_text_and_binary"] = [
            list(data.read_text(str(inp / "a.txt")).iter_rows()),
            data.read_binary_files(str(inp / "b.bin")).take_all()]
        r["read_images"] = data.read_images(str(inp / "img.png")).take_all()
        r["read_tfrecords_without_tensorflow"] = [
            data.read_tfrecords(str(inp / "data.tfrecord")).take_all(),
            batches(data.read_tfrecords(str(inp / "data.tfrecord")))]
        r["read_numpy_multidim_roundtrip"] = [
            batches(data.read_numpy(str(inp / "m.npy"))),
            batches(data.read_numpy(str(inp / "z.npz")))]
        r["read_csv_types"] = [
            batches(data.read_csv(str(inp / name))) for name in CSV_FILES]
        r["read_json_types"] = [
            batches(data.read_json(str(inp / name))) for name in JSON_FILES]

        # ---- writers: one file per block, read back; the files' bytes
        rows = [{"k": i, "v": float(i) * 0.5} for i in range(100)]
        ds = data.from_items(rows, parallelism=4)
        mine = out / pkg_name
        n_pq = len(ds.write_parquet(str(mine / "pq")))
        ds.write_csv(str(mine / "csv"))
        ds.write_json(str(mine / "js"))
        r["write_parquet_csv_json_roundtrip"] = [
            n_pq,
            sorted(r["k"] for r in
                   data.read_parquet(str(mine / "pq")).iter_rows()),
            data.read_csv(str(mine / "csv")).count(),
            batches(data.read_csv(str(mine / "csv"))),
            batches(data.read_json(str(mine / "js")))]
        r["written_files"] = {
            f"{fmt}/{name}": (mine / fmt / name).read_bytes()
            for fmt in ("csv", "js") for name in
            sorted(os.listdir(mine / fmt))}
        # The other package's files, where it has run first.
        theirs = out / [p for p in PACKAGES if p != pkg_name][0]
        if (theirs / "csv").exists():
            r["read_the_other_packages_files"] = [
                batches(data.read_csv(str(theirs / "csv"))),
                batches(data.read_json(str(theirs / "js")))]
        ds8 = data.from_items([{"k": i} for i in range(80)], parallelism=8)
        ds8.write_parquet(str(mine / "o"))
        ds4 = data.from_items([{"k": i} for i in range(40)], parallelism=4)
        try:
            ds4.write_parquet(str(mine / "o"))
            refused = None
        except FileExistsError as e:
            refused = "part files" in str(e)
        ds4.write_csv(str(mine / "oc"))
        try:
            ds8.write_csv(str(mine / "oc"))
        except FileExistsError:
            pass
        ds4.write_parquet(str(mine / "o"), mode="overwrite")
        ds4.write_csv(str(mine / "oc"), mode="overwrite")
        r["write_refuses_stale_parts_unless_overwrite"] = [
            refused, data.read_parquet(str(mine / "o")).count(),
            data.read_csv(str(mine / "oc")).count()]

        # ---- filter, repartition, shuffle, zip, map
        import pyarrow.compute as pc

        ds = data.from_items([{"k": i, "v": i % 3} for i in range(300)],
                             parallelism=6)
        fast = ds.filter(pc.field("v") == 0)
        slow = ds.filter(lambda row: row["v"] == 0)
        r["filter_expression_fast_path_and_udf"] = [
            fast.count(), blocks(fast), slow.count(), blocks(slow)]
        ds = data.from_items([{"k": i} for i in range(103)], parallelism=7)
        r["repartition_slice_plan_preserves_order"] = [
            (rp.num_blocks(), blocks(rp), [x["k"] for x in rp.iter_rows()])
            for rp in (ds.repartition(n) for n in (1, 3, 10))]
        small = data.from_items([{"k": i} for i in range(5)], parallelism=2)
        rp = small.repartition(8)
        schema = rp.schema()
        if pkg_name == "ray_tpu":
            schema = {f.name: (np.dtype(f.type.to_pandas_dtype()), ())
                      for f in schema}
        r["repartition_more_blocks_than_rows_keeps_schema"] = [
            schema, blocks(rp), batches(rp, 2)]
        ds = data.from_numpy({"x": np.arange(40, dtype=np.int64),
                              "y": np.arange(40) * 0.5}, parallelism=5)
        r["random_shuffle_seeded"] = [
            blocks(ds.random_shuffle(seed=5)),
            blocks(ds.map_batches(lambda b: {"x": b["x"] * 2,
                                             "y": b["y"]})
                   .random_shuffle(seed=11))]
        other = data.from_numpy({"z": np.arange(40) * 3}, parallelism=3)
        r["zip_map_take_all_stats"] = [
            blocks(ds.zip(other)),
            ds.map(lambda row: {"x": row["x"] + 1, "s": str(row["x"])}
                   ).take_all(),
            ds.num_blocks(), ds.stats()]

        # ---- the pandas and pyarrow batch formats
        ds = data.from_numpy({"a": np.arange(12, dtype=np.int64),
                              "t": np.arange(24.0).reshape(12, 2)},
                             parallelism=3)
        flat = data.from_numpy({"a": np.arange(12, dtype=np.int64),
                                "f": np.arange(12) / 4}, parallelism=3)
        r["batch_formats"] = [
            blocks(ds.map_batches(
                lambda df: df.assign(b=df["a"] * 2)[["a", "b"]],
                batch_format="pandas")),
            blocks(ds.map_batches(
                lambda t: t.append_column("c", pc.multiply(t["a"], 3)),
                batch_format="pyarrow")),
            [_pandas_or_arrow_to_numpy(b) for fmt in ("pandas", "pyarrow")
             for b in flat.iter_batches(5, batch_format=fmt)],
            [_pandas_or_arrow_to_numpy(b)
             for b in ds.iter_batches(5, batch_format="pyarrow")]]

        # ---- test_data_serve_util.py's Data half
        ds = data.from_items([{"x": i} for i in range(100)], parallelism=4)
        doubled = ds.map_batches(lambda b: {"x": b["x"] * 2})
        r["dataset_from_items_map_filter"] = [
            ds.count(), doubled.take(3),
            ds.filter(lambda row: row["x"] % 2 == 0).count()]
        ds = data.range(100, parallelism=5)
        r["dataset_split_and_iter_batches"] = [
            [s.count() for s in ds.split(4, equal=True)],
            batches(ds, 32)]
        x = np.random.default_rng(2).random((64, 8, 3)).astype(np.float32)
        r["dataset_tensors_roundtrip"] = batches(
            data.from_numpy({"img": x, "label": np.arange(64)},
                            parallelism=4), 16)
        ds = data.read_parquet(str(inp / "part0.parquet"))
        r["dataset_parquet_io"] = [ds.count(), ds.take(2)]
        ds = data.from_numpy({"v": np.arange(100, dtype=np.float64)})
        scaler = data.StandardScaler(["v"])
        r["standard_scaler"] = [batches(scaler.fit_transform(ds), 50),
                                scaler.stats]
        mapper = data.BatchMapper(lambda b: {"v": b["v"] + 1})
        r["batch_mapper"] = batches(mapper.transform(ds), 30)
    finally:
        pkg.shutdown()
    return r


def _pandas_or_arrow_to_numpy(batch):
    """A pandas or pyarrow batch back as numpy columns (both packages'
    batches go through the same conversion)."""
    if hasattr(batch, "to_pydict"):
        from ray_tpu.data.block import block_to_numpy

        return block_to_numpy(batch)
    return {k: batch[k].to_numpy() for k in batch.columns}


@pytest.fixture(scope="module")
def results(inputs, tmp_path_factory):
    out = tmp_path_factory.mktemp("data_formats_out")
    return {name: _run(name, inputs, out) for name in PACKAGES}


# ---------------------------------------------------------------------------
# Comparison
# ---------------------------------------------------------------------------
def _same_value(a, b):
    if isinstance(a, float) and isinstance(b, float) and np.isnan(a) \
            and np.isnan(b):
        return
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        _same(a, b)
        return
    assert type(a) is type(b) and a == b, (a, b)


def _same(a, b):
    """Equal structure; every array equal in dtype, shape and bytes (an
    object array element by element)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), (a, b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), (a, b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), (a, b)
        assert (a.dtype, a.shape) == (b.dtype, b.shape), (a, b)
        if a.dtype == object:
            for x, y in zip(a.ravel(), b.ravel()):
                _same_value(x, y)
        else:
            assert a.tobytes() == b.tobytes(), (a, b)
    else:
        _same_value(a, b)


def _sorted_by(block, key):
    order = np.argsort(block[key], kind="stable")
    return {k: v[order] for k, v in block.items()}


BIT_FOR_BIT = [
    "sort_ints_across_blocks", "sort_descending_and_strings",
    "custom_datasource_plugin", "read_text_and_binary",
    "read_tfrecords_without_tensorflow", "read_numpy_multidim_roundtrip",
    "read_csv_types", "read_json_types", "write_parquet_csv_json_roundtrip",
    "written_files", "write_refuses_stale_parts_unless_overwrite",
    "filter_expression_fast_path_and_udf",
    "repartition_slice_plan_preserves_order",
    "repartition_more_blocks_than_rows_keeps_schema",
    "random_shuffle_seeded", "zip_map_take_all_stats", "batch_formats",
    "dataset_from_items_map_filter", "dataset_split_and_iter_batches",
    "dataset_tensors_roundtrip", "dataset_parquet_io", "standard_scaler",
    "batch_mapper"]


@pytest.mark.parametrize("scenario", BIT_FOR_BIT)
def test_scenario_equals_the_jax_packages_bit_for_bit(results, scenario):
    _same(results["ray_tpu"][scenario], results["ray_tpu_torch"][scenario])


def test_each_package_reads_the_others_csv_and_json_files(results):
    """The port runs second: its read of the reference's files equals the
    reference's own read, and the two wrote the same bytes, so the
    reference's read of the port's files is its read of its own."""
    ref, port = results["ray_tpu"], results["ray_tpu_torch"]
    mine = ref["write_parquet_csv_json_roundtrip"]
    _same(port["read_the_other_packages_files"], [mine[3], mine[4]])
    assert ref["written_files"] == port["written_files"]


@pytest.mark.parametrize("scenario", [
    "groupby_sum_mean_count", "groupby_string_keys_stable_across_workers",
    "groupby_more_partitions_than_keys"])
def test_groupby_equals_the_jax_packages_block_by_block(results, scenario):
    """Each output partition holds the same groups (the reference's hash)
    with the same aggregates, compared after sorting by the key (the
    order within a partition is pyarrow's group_by order)."""
    def by_key(run):
        out = []
        for blocks in run[scenario]:
            key = next(iter(blocks[0])) if blocks else None
            out.append([_sorted_by(b, key) if key in b else b
                        for b in blocks])
        return out

    ref, port = by_key(results["ray_tpu"]), by_key(results["ray_tpu_torch"])
    _same(ref, port)


def test_groupby_std_is_arrows_population_stddev(results):
    """stddev with pyarrow's default ddof=0; arrow and numpy round the
    variance differently in the last bits, so within 1e-12."""
    ref, port = (results[p]["groupby_std"] for p in PACKAGES)
    assert len(ref) == len(port)
    for a, b in zip(ref, port):
        a, b = _sorted_by(a, "k"), _sorted_by(b, "k")
        _same(a["k"], b["k"])
        assert a["v_stddev"].dtype == b["v_stddev"].dtype == np.float64
        np.testing.assert_allclose(b["v_stddev"], a["v_stddev"], rtol=1e-12)


def test_the_reference_tests_conditions_hold_on_the_port(results):
    """test_data_formats.py's and test_data_serve_util.py's own checks,
    on the port's results."""
    r = results["ray_tpu_torch"]
    vals = np.random.default_rng(0).integers(0, 10_000, size=2_000)
    np.testing.assert_array_equal(
        np.concatenate([b["v"] for b in r["sort_ints_across_blocks"]]),
        np.sort(vals))
    words = [f"w{i:04d}" for i in np.random.default_rng(1).permutation(300)]
    assert [x["k"] for x in r["sort_descending_and_strings"][1]] == \
        sorted(words, reverse=True)
    sums = {int(k): v for b in r["groupby_sum_mean_count"][0]
            for k, v in zip(b["k"], b["v_sum"])}
    assert sums == {k: float(sum(i for i in range(1000) if i % 5 == k))
                    for k in range(5)}
    got = {k: int(v)
           for b in r["groupby_string_keys_stable_across_workers"][0]
           for k, v in zip(b["name"], b["x_sum"])}
    assert got == {"a": 100, "b": 100, "c": 100}
    rows, streamed = r["custom_datasource_plugin"]
    assert [x["text"] for x in rows] == ["hello", "world"]
    assert [s for b in streamed for s in b["text"]] == ["hello", "world"]
    text, binary = r["read_text_and_binary"]
    assert [x["text"] for x in text] == ["one", "two"]
    assert binary[0]["bytes"] == b"\x00\x01\x02"
    tf_rows = r["read_tfrecords_without_tensorflow"][0]
    assert [x["label"] for x in tf_rows] == [7, 9]
    assert [x["name"] for x in tf_rows] == [b"seven", b"nine"]
    m = r["read_numpy_multidim_roundtrip"][0]
    assert m[0]["data"].dtype == np.float32 and m[0]["data"].shape == (3, 4)
    n_pq, keys, n_csv, _, js = r["write_parquet_csv_json_roundtrip"]
    assert n_pq == 4 and keys == list(range(100)) and n_csv == 100
    assert {int(k): v for b in js for k, v in zip(b["k"], b["v"])}[10] == 5.0
    assert r["write_refuses_stale_parts_unless_overwrite"] == [True, 40, 40]
    assert r["filter_expression_fast_path_and_udf"][0::2] == [100, 100]
    for n, (num, _, ks) in zip((1, 3, 10),
                               r["repartition_slice_plan_preserves_order"]):
        assert num == n and ks == list(range(103))
    schema, _, small = r["repartition_more_blocks_than_rows_keeps_schema"]
    assert "k" in str(schema)
    assert [int(x) for b in small for x in b["k"]] == list(range(5))
    agg_blocks, agg_batches = r["groupby_more_partitions_than_keys"]
    assert len(agg_blocks) == 6
    assert sum(float(b["v_sum"].sum()) for b in agg_batches) == 100.0
    count, first3, evens = r["dataset_from_items_map_filter"]
    assert (count, first3, evens) == (100, [{"x": 0}, {"x": 2}, {"x": 4}],
                                      50)
    counts, b32 = r["dataset_split_and_iter_batches"]
    assert counts == [25] * 4 and sum(len(b["id"]) for b in b32) == 100
    assert r["dataset_parquet_io"] == [10, [{"a": 0}, {"a": 1}]]
    scaled = np.concatenate([b["v"] for b in r["standard_scaler"][0]])
    assert abs(scaled.mean()) < 1e-6 and abs(scaled.std() - 1.0) < 1e-2


def test_strings_are_object_arrays_and_tensors_keep_their_shape(results):
    """The port's decided forms: a string column is an object array of
    Python str (the reference's block_to_numpy form, which the hash
    partitioning depends on); an image is a uint8 (1, H, W, 3) column
    where the reference has nested lists; the rows are the same."""
    r = results["ray_tpu_torch"]
    s = r["sort_descending_and_strings"][0][0]["k"]
    assert s.dtype == object and all(type(x) is str for x in s)
    csv_types = r["read_csv_types"][0][0]
    assert csv_types["s"].dtype == object and csv_types["s"][2] == ""
    img = r["read_images"]
    ref = results["ray_tpu"]["read_images"]
    assert img == ref
    arr = (np.arange(12 * 10 * 3) % 255).reshape(12, 10, 3)
    np.testing.assert_array_equal(np.asarray(img[0]["image"], np.uint8), arr)
    assert img[0]["height"] == 12 and img[0]["width"] == 10


def test_stable_hash_deterministic_and_spread():
    """The port's hash is the reference's, value for value."""
    from ray_tpu.data.grouped import _stable_hash as ref_hash
    from ray_tpu_torch.data.grouped import _stable_hash

    ints = np.arange(10_000)
    np.testing.assert_array_equal(_stable_hash(ints), ref_hash(ints))
    counts = np.bincount((_stable_hash(ints) % 8).astype(int), minlength=8)
    assert counts.min() > 800
    floats = np.linspace(0, 1, 1000)
    np.testing.assert_array_equal(_stable_hash(floats), ref_hash(floats))
    strs = np.array([f"key{i}" for i in range(100)], dtype=object)
    np.testing.assert_array_equal(_stable_hash(strs), ref_hash(strs))
    np.testing.assert_array_equal(_stable_hash(np.array([True, False])),
                                  ref_hash(np.array([True, False])))


def test_stable_hash_int_float_promotion_agrees():
    """A null promotes an int64 key to float64 in its block (arrow's
    to_numpy; the port's numpy block holds NaN): the same key must hash
    to the same partition, so a group never splits."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import data
    from ray_tpu_torch.data.grouped import _stable_hash

    ints = np.array([7, 8, 9], dtype=np.int64)
    np.testing.assert_array_equal(_stable_hash(ints),
                                  _stable_hash(ints.astype(np.float64)))
    rt.init(num_cpus=2, object_store_memory=64 * MB)
    try:
        b1 = {"k": np.array([7, 7, 8], np.int64), "v": np.ones(3)}
        b2 = {"k": np.array([7, np.nan, 8]), "v": np.ones(3)}
        ds = data.Dataset([rt.put(b1), rt.put(b2)])
        rows = [r for r in ds.groupby("k", num_partitions=4).sum("v")
                .iter_rows() if r["k"] == 7]
    finally:
        rt.shutdown()
    assert len(rows) == 1 and rows[0]["v_sum"] == 3.0


# ---------------------------------------------------------------------------
# The card's formats: no pyarrow, pandas or PIL
# ---------------------------------------------------------------------------
HIDDEN = ("pyarrow", "pyarrow.parquet", "pyarrow.compute", "pyarrow.csv",
          "pyarrow.json", "pandas", "PIL", "PIL.Image")


def test_card_formats_import_no_pyarrow_pandas_or_pil(monkeypatch, inputs,
                                                      tmp_path):
    """With the three packages hidden, every format the card's machine
    can run works (in local mode, so tasks run in this process), and the
    others raise an ImportError naming their package."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import data

    for name in HIDDEN:
        monkeypatch.setitem(sys.modules, name, None)
    rt.init(local_mode=True)
    try:
        assert data.read_numpy(str(inputs / "m.npy")).count() == 3
        assert data.read_csv(str(inputs / "types.csv")).count() == 3
        assert data.read_json(str(inputs / "types.json")
                              ).count() == 3
        assert data.read_text(str(inputs / "a.txt")).count() == 2
        assert data.read_binary_files(str(inputs / "b.bin")
                                      ).count() == 1
        assert data.read_tfrecords(str(inputs / "data.tfrecord")
                                   ).count() == 2
        ds = data.from_items([{"k": i % 7, "v": float(i), "s": str(i)}
                              for i in range(60)], parallelism=4)
        ds.write_csv(str(tmp_path / "csv"))
        ds.write_json(str(tmp_path / "js"))
        assert data.read_csv(str(tmp_path / "csv")).count() == 60
        assert data.read_json(str(tmp_path / "js")).count() == 60
        got = [r["v"] for r in ds.sort("v", descending=True).iter_rows()]
        assert got == sorted((float(i) for i in range(60)), reverse=True)
        sums = {r["k"]: r["v_sum"]
                for r in ds.groupby("k").sum("v").iter_rows()}
        assert sums == {k: float(sum(i for i in range(60) if i % 7 == k))
                        for k in range(7)}
        assert sorted(r["v"] for r in ds.random_shuffle(seed=0).iter_rows()
                      ) == [float(i) for i in range(60)]
        sd = ds.streaming(max_inflight_blocks=2)
        for full in (False, True):
            ids = np.sort(np.concatenate(
                [b["v"] for b in sd.random_shuffle(seed=1, full=full)
                 .iter_batches(16)]))
            np.testing.assert_array_equal(ids, np.arange(60.0))
        assert data.read_streaming(str(inputs / "m.npy"), "numpy"
                                   ).count() == 3
        for package, call in (
                ("pyarrow", lambda: data.read_parquet(
                    str(inputs / "part0.parquet")).count()),
                ("pyarrow", lambda: ds.write_parquet(str(tmp_path / "pq"))),
                ("pandas", lambda: ds.map_batches(
                    lambda df: df, batch_format="pandas").count()),
                ("pyarrow", lambda: ds.map_batches(
                    lambda t: t, batch_format="pyarrow").count()),
                ("pandas", lambda: next(ds.iter_batches(
                    4, batch_format="pandas"))),
                ("PIL", lambda: data.read_images(
                    str(inputs / "img.png")).count())):
            with pytest.raises(ImportError, match=repr(package)):
                call()
    finally:
        rt.shutdown()



def test_every_public_name_and_method_of_the_reference_exists():
    """After Queue 1 item 1c nothing of the JAX package's Data is missing
    from the port: its exports, and the public methods of its Dataset,
    StreamingDataset, GroupedData and preprocessors."""
    import ray_tpu.data as ref
    import ray_tpu_torch.data as port

    assert [n for n in dir(ref) if not n.startswith("_")
            and not hasattr(port, n)] == []
    for cls in ("Dataset", "StreamingDataset", "GroupedData",
                "Preprocessor", "BatchMapper", "StandardScaler",
                "DevicePrefetcher"):
        a, b = getattr(ref, cls), getattr(port, cls)
        assert [m for m in dir(a) if not m.startswith("_")
                and not hasattr(b, m)] == [], cls
