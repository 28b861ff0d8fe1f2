"""The port's Data ingest against the JAX package's.

The same seeded inputs go through ``ray_tpu.data`` (pyarrow blocks) and
``ray_tpu_torch.data`` (blocks of numpy columns), each in its own
cluster: ``from_numpy`` -> ``split(n, equal=True)`` -> ``iter_batches``
(the carry across blocks, ``drop_last``), ``map_batches``, ``from_items``,
``range``, ``count``, ``take`` and ``iter_rows`` must give the same arrays
and rows, bit for bit.  ``DevicePrefetcher`` keeps
``tests/test_device_prefetch.py``'s lifecycle rules on the CPU, where
placement is ``torch.from_numpy``; its pinned-memory side-stream path
runs on a card (``cuda``-marked).  Every ``get`` has a timeout."""
import gc
import importlib
import threading
import time

import numpy as np
import pytest
import torch

T = 60  # seconds: the bound of every get


def _inputs():
    rng = np.random.default_rng(0)
    return {"x": rng.standard_normal((103, 3)).astype(np.float32),
            "y": rng.integers(0, 1000, 103).astype(np.int64)}


def _pipelines(pkg_name: str) -> dict:
    """Every scenario through one package, in its own cluster: a dict of
    lists of numpy batches (or rows, or counts)."""
    pkg = importlib.import_module(pkg_name)
    data = importlib.import_module(f"{pkg_name}.data")
    pkg.init(num_cpus=4, object_store_memory=256 * 1024**2)
    try:
        ds = data.from_numpy(_inputs(), parallelism=5)
        shards = ds.split(3, equal=True)
        mapped = ds.map_batches(lambda b: {"x": b["x"] * 2 + 1,
                                           "s": b["x"].sum(axis=1),
                                           "y": b["y"] // 7})
        items = data.from_items([{"a": i, "b": i / 3} for i in range(20)],
                                parallelism=3)
        rng = data.range(50, parallelism=4)
        return {
            "split_carry": [list(s.iter_batches(8)) for s in shards],
            "split_drop_last": [list(s.iter_batches(8, drop_last=True))
                                for s in shards],
            "whole_carry": list(ds.iter_batches(16)),
            "map_batches": list(mapped.iter_batches(16)),
            "from_items": list(items.iter_batches(6)),
            "range": list(rng.iter_batches(12)),
            "counts": [ds.count(), mapped.count(), items.count(),
                       rng.count()] + [s.count() for s in shards],
            "take": [rng.take(7), items.take(4), ds.take(2)],
            "rows": list(items.iter_rows()),
            "materialized": list(mapped.materialize().iter_batches(50)),
        }
    finally:
        pkg.shutdown()


@pytest.fixture(scope="module")
def results():
    return {name: _pipelines(name) for name in ("ray_tpu", "ray_tpu_torch")}


def _same(a, b):
    """Equal structure, and every array equal in dtype, shape and bytes."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray)
        assert (a.dtype, a.shape) == (b.dtype, b.shape)
        assert a.tobytes() == b.tobytes()
    else:
        assert type(a) is type(b) and a == b


@pytest.mark.parametrize("scenario", [
    "split_carry", "split_drop_last", "whole_carry", "map_batches",
    "from_items", "range", "counts", "take", "rows", "materialized"])
def test_batches_equal_the_jax_packages_bit_for_bit(results, scenario):
    _same(results["ray_tpu"][scenario], results["ray_tpu_torch"][scenario])


def test_split_shards_are_equal_and_carry_then_drop_last(results):
    """Three equal shards of 103 rows hold 34 each (the last row goes);
    batches of 8 give four full batches and a carry of 2, which
    drop_last drops."""
    got = results["ray_tpu_torch"]
    assert got["counts"][4:] == [34, 34, 34]
    assert [[len(b["y"]) for b in s] for s in got["split_carry"]] == \
        [[8, 8, 8, 8, 2]] * 3
    assert [[len(b["y"]) for b in s] for s in got["split_drop_last"]] == \
        [[8, 8, 8, 8]] * 3
    want = _inputs()["y"][:102]
    np.testing.assert_array_equal(
        np.concatenate([b["y"] for s in got["split_carry"] for b in s]),
        want)


@pytest.mark.parametrize("call", [
    lambda d: d.read_parquet("x.parquet"),
    lambda d: d.read_csv("x.csv"),
    lambda d: d.read_streaming(["x"], "numpy"),
    lambda d: d.range(4).map(lambda r: r),
    lambda d: d.range(4).filter(lambda r: True),
    lambda d: d.range(4).sort("id"),
    lambda d: d.range(4).groupby("id"),
    lambda d: d.range(4).zip(d.range(4)),
    lambda d: d.range(4).random_shuffle(seed=0),
    lambda d: d.range(4).streaming(),
    lambda d: d.range(4).write_parquet("out"),
    lambda d: d.range(4).map_batches(lambda b: b, batch_format="pandas"),
    lambda d: next(d.range(4).iter_batches(2, batch_format="pyarrow")),
], ids=["read_parquet", "read_csv", "read_streaming", "map", "filter",
        "sort", "groupby", "zip", "random_shuffle", "streaming",
        "write_parquet", "pandas_format", "pyarrow_format"])
def test_the_rest_of_data_raises_naming_its_item(call):
    import ray_tpu_torch as rt
    from ray_tpu_torch import data

    rt.init(num_cpus=2, object_store_memory=64 * 1024**2)
    try:
        with pytest.raises(NotImplementedError, match="Queue 1 item 1c"):
            call(data)
    finally:
        rt.shutdown()


def test_the_ingest_path_imports_no_pyarrow():
    import ast
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent / "ray_tpu_torch"
    for path in sorted((root / "data").glob("*.py")) + [
            root / "train/torch/train_loop_utils.py"]:
        names = {alias.name.split(".")[0]
                 for node in ast.walk(ast.parse(path.read_text()))
                 if isinstance(node, (ast.Import, ast.ImportFrom))
                 for alias in getattr(node, "names", [])} | {
            node.module.split(".")[0]
            for node in ast.walk(ast.parse(path.read_text()))
            if isinstance(node, ast.ImportFrom) and node.module}
        assert not names & {"pyarrow", "pandas"}, path


# ---------------------------------------------------------------------------
# DevicePrefetcher: test_device_prefetch.py's rules, on the CPU
# ---------------------------------------------------------------------------
def _host_batches(n):
    return [{"x": np.full((8,), i, np.int64)} for i in range(n)]


def _wait_dead(thread, timeout=5.0):
    deadline = time.monotonic() + timeout
    while thread.is_alive() and time.monotonic() < deadline:
        time.sleep(0.05)
    return not thread.is_alive()


def _prefetcher(*args, **kwargs):
    from ray_tpu_torch.data.prefetch import DevicePrefetcher

    return DevicePrefetcher(*args, device="cpu", **kwargs)


def test_prefetch_order_values_and_occupancy():
    pf = _prefetcher(iter(_host_batches(6)), prefetch=2)
    batches = list(pf)
    assert all(isinstance(b["x"], torch.Tensor) and b["x"].device.type ==
               "cpu" and b["x"].dtype == torch.int64 for b in batches)
    assert [int(b["x"][0]) for b in batches] == [0, 1, 2, 3, 4, 5]
    assert pf.batches_delivered == 6
    assert pf.peak_occupancy <= 2  # the queue bound held


def test_producer_exception_propagates_to_consumer():
    def bad_source():
        yield {"x": np.zeros(2)}
        raise ValueError("reader exploded")

    pf = _prefetcher(bad_source(), prefetch=2)
    next(pf)
    with pytest.raises(ValueError, match="reader exploded"):
        next(pf)
    # The error is sticky, not swallowed into StopIteration.
    with pytest.raises(ValueError):
        next(pf)


def test_close_joins_blocked_producer_thread():
    # An unbounded source against a size-1 queue: the producer is parked
    # on a full queue when close() arrives — it must still join.
    pf = _prefetcher(({"x": np.zeros(2)} for _ in range(10**6)), prefetch=1)
    time.sleep(0.2)
    thread = pf._thread
    assert thread is not None and thread.is_alive()
    pf.close()
    assert not thread.is_alive(), "close() leaked the producer thread"
    with pytest.raises(StopIteration):
        next(pf)


def test_gc_joins_producer_thread():
    before = threading.active_count()
    pf = _prefetcher(({"x": np.zeros(2)} for _ in range(10**6)), prefetch=1)
    thread = pf._thread
    del pf
    gc.collect()
    assert _wait_dead(thread), "dropping the iterator leaked its thread"
    assert threading.active_count() <= before


def test_prefetch_zero_is_inline():
    pf = _prefetcher(iter(_host_batches(4)), prefetch=0)
    assert pf._thread is None  # no producer thread at all
    assert [int(b["x"][0]) for b in pf] == [0, 1, 2, 3]


def test_read_only_arrays_are_copied_and_writable_ones_shared():
    ro = np.arange(4.0)
    ro.flags.writeable = False
    rw = np.arange(4.0)
    batch = next(_prefetcher(iter([{"ro": ro, "rw": rw}]), prefetch=0))
    assert batch["rw"].data_ptr() == rw.ctypes.data
    assert batch["ro"].data_ptr() != ro.ctypes.data
    assert torch.equal(batch["ro"], torch.from_numpy(rw))


def test_default_device_is_cuda_and_raises_without_it():
    from ray_tpu_torch.data.prefetch import DevicePrefetcher

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    with pytest.raises(RuntimeError, match="cuda"):
        DevicePrefetcher(iter(_host_batches(1)))


@pytest.mark.cuda
def test_pinned_side_stream_batches_equal_the_host_batches_on_cuda():
    """On a card: every batch is copied from pinned memory on the
    prefetcher's side stream, the consumer's stream waits on its event,
    and the values equal the host batch's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from ray_tpu_torch.data.prefetch import DevicePrefetcher

    rng = np.random.default_rng(0)
    host = [{"tokens": rng.integers(0, 50257, (16, 1024), dtype=np.int32)}
            for _ in range(8)]
    pf = DevicePrefetcher(iter(host), prefetch=2)
    side = pf._stage._core.fn.stream
    assert side != torch.cuda.current_stream()
    got = [b["tokens"] for b in pf]
    assert all(t.is_cuda and t.dtype == torch.int32 for t in got)
    for t, h in zip(got, host):
        assert torch.equal(t.cpu(), torch.from_numpy(h["tokens"]))
    assert pf.peak_occupancy <= 2
