"""The port's streaming executor against the JAX package's: the
counterpart of ``tests/test_streaming_data.py`` and
``tests/test_push_shuffle.py``.

Each scenario keeps its reference test's name and runs through
``ray_tpu.data`` and ``ray_tpu_torch.data``, each in its own cluster of
a 256 MiB store started once for the module, one after the other.  The
sources are the reference tests' generator tasks (int64 columns), built
with each package's own ``block_from_numpy``.  Where the order is defined
— no shuffle, the window-scoped shuffle under a seed, the push-based full
shuffle under a seed, fused reads — the batches are compared bit for bit
(dtype, shape, bytes).  The window comes from the store budget over the
measured size of the first block, and the test shows it is that and not
the fallback of 4.  The reference's ``slow`` scenarios are ``slow`` here
too and run the port alone (the reference's own slow tests hold the JAX
side).  Every get and wait has a timeout."""
import importlib
import sys

import numpy as np
import pytest
import torch

T = 120  # seconds: the bound of every get and wait
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


def _gen_thunks(pkg_name, num_blocks, rows_per_block, second="x"):
    """Source thunks producing int64 blocks of rows_per_block rows each:
    ``id`` counts up; ``second`` is ones ("x") or the block index
    ("blk"), as in the reference tests."""
    pkg = importlib.import_module(pkg_name)
    block_from_numpy = importlib.import_module(
        f"{pkg_name}.data.block").block_from_numpy

    @pkg.remote
    def gen(i):
        base = i * rows_per_block
        other = (np.ones(rows_per_block, np.int64) if second == "x"
                 else np.full(rows_per_block, i, np.int64))
        return block_from_numpy(
            {"id": np.arange(base, base + rows_per_block, dtype=np.int64),
             second: other})

    return [(lambda i=i: gen.remote(i)) for i in range(num_blocks)]


def _store_used(pkg):
    return sum(r.store.used for r in pkg._head.raylets.values())


def _run(pkg_name, tmp) -> dict:
    pkg = importlib.import_module(pkg_name)
    data = importlib.import_module(f"{pkg_name}.data")
    to_numpy = importlib.import_module(f"{pkg_name}.data.block"
                                       ).block_to_numpy
    SD = data.StreamingDataset
    pkg.init(num_cpus=2, object_store_memory=256 * MB)
    r = {}
    try:
        # ---- test_streaming_data.py
        sd = SD(_gen_thunks(pkg_name, 12, 1000), max_inflight_blocks=3)
        r["streaming_bounded_inflight"] = list(sd.map_batches(
            lambda b: {"id": b["id"], "x": b["x"] * 2}).iter_batches(500))

        windows = []
        for budget in (16 * MB, 40 * MB):
            sd = SD(_gen_thunks(pkg_name, 8, 2 * MB // 16),
                    store_budget=budget)
            refs = sd.iter_block_refs()
            first = next(refs)
            pkg.wait([first], num_returns=1, timeout=T)
            worker = importlib.import_module(f"{pkg_name}._private.worker")
            info = worker.global_worker.transport.request(
                "object_info", {"oid": first.id})
            windows.append((budget, sd._window_size(first), info["size"]))
            refs.close()
            del first, refs
        r["streaming_window_from_store_budget"] = windows

        sd = SD(_gen_thunks(pkg_name, 6, 500), max_inflight_blocks=6)
        r["streaming_shuffle_preserves_rows"] = list(
            sd.random_shuffle(seed=0).iter_batches(250))
        def shuffled_blocks(num_blocks):
            sd = SD(_gen_thunks(pkg_name, num_blocks, 300),
                    max_inflight_blocks=3)
            return [to_numpy(pkg.get(ref, timeout=T)) for ref in
                    sd.random_shuffle(seed=9).iter_block_refs()]

        sd = SD(_gen_thunks(pkg_name, 6, 300), max_inflight_blocks=3)
        r["streaming_shuffle_windows"] = [
            list(sd.map_batches(lambda b: {"id": b["id"] * 3, "x": b["x"]})
                 .filter(lambda row: row["id"] % 2 == 0)
                 .random_shuffle(seed=4).iter_batches(100)),
            shuffled_blocks(6)]
        if pkg_name == "ray_tpu_torch":
            # Seven blocks in windows of three: a tail window of one
            # block, which the JAX package's copy fails on (ROADMAP,
            # Queue 3); the port's first six blocks are the six-block
            # run's.
            r["streaming_shuffle_tail_window"] = shuffled_blocks(7)

        ds = data.Dataset.range(4000, parallelism=8)
        sd = ds.streaming(max_inflight_blocks=2)
        r["eager_dataset_to_streaming"] = [
            sd.map_batches(lambda b: {"id": b["id"] + 1}).count(),
            list(ds.map_batches(lambda b: {"id": b["id"] * 2}).streaming(
                max_inflight_blocks=3).iter_batches(700))]

        import pyarrow as pa
        import pyarrow.parquet as pq

        for i in range(4):
            path = tmp / f"part{i}.parquet"
            if not path.exists():
                pq.write_table(pa.table({"v": np.arange(i * 100,
                                                        (i + 1) * 100)}),
                               str(path))
        sd = data.read_streaming(str(tmp / "*.parquet"), "parquet",
                                 max_inflight_blocks=2)
        r["read_streaming_files"] = list(sd.iter_batches(50))

        # ---- test_push_shuffle.py
        sd = SD(_gen_thunks(pkg_name, 6, 500, "blk"), max_inflight_blocks=2)
        r["push_shuffle_preserves_rows"] = list(
            sd.random_shuffle(seed=0, full=True).iter_batches(250))

        def first_block(full):
            sd = SD(_gen_thunks(pkg_name, 12, 400, "blk"),
                    max_inflight_blocks=2)
            it = sd.random_shuffle(seed=3, full=full).iter_block_refs()
            blk = to_numpy(pkg.get(next(it), timeout=T))
            it.close()
            return blk

        r["full_shuffle_beats_window_scoped_mixing"] = [
            first_block(False), first_block(True)]

        sd = (data.read_streaming(str(tmp / "*.parquet"), "parquet",
                                  max_inflight_blocks=2)
              .map_batches(lambda b: {"v": b["v"] * 2})
              .filter(lambda row: row["v"] % 4 == 0))
        r["fused_read_map_is_one_task"] = [sd.explain(),
                                           list(sd.iter_batches(64))]
        sd = SD(_gen_thunks(pkg_name, 2, 10, "blk")).map_batches(
            lambda b: {"id": b["id"], "blk": b["blk"]})
        r["thunk_sources_unfused_plan"] = [sd.explain(), sd.count()]

        # ---- the preprocessors on a stream
        sd = data.read_streaming(str(tmp / "*.parquet"), "parquet",
                                 max_inflight_blocks=2)
        mapper = data.BatchMapper(lambda b: {"v": b["v"] * 5,
                                             "w": b["v"] % 3})
        r["batch_mapper_on_a_stream"] = list(
            mapper.transform(sd).random_shuffle(seed=2).iter_batches(90))
    finally:
        pkg.shutdown()
    return r


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("streaming_data")
    return {name: _run(name, tmp) for name in PACKAGES}


def _same(a, b):
    """Equal structure; every array equal in dtype, shape and bytes."""
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
        assert a.tobytes() == b.tobytes()
    else:
        assert type(a) is type(b) and a == b, (a, b)


@pytest.mark.parametrize("scenario", [
    "streaming_bounded_inflight", "streaming_shuffle_preserves_rows",
    "streaming_shuffle_windows", "eager_dataset_to_streaming",
    "read_streaming_files", "push_shuffle_preserves_rows",
    "full_shuffle_beats_window_scoped_mixing", "fused_read_map_is_one_task",
    "thunk_sources_unfused_plan", "batch_mapper_on_a_stream"])
def test_scenario_equals_the_jax_packages_bit_for_bit(results, scenario):
    _same(results["ray_tpu"][scenario], results["ray_tpu_torch"][scenario])


def test_window_comes_from_the_measured_block_size(results):
    """Half the budget over the first block's size as the head records it
    (test_streaming_data.py: ~2 MiB blocks, a 16 MiB budget, a window of
    2 to 4), not the fallback of 4: a larger budget gives a larger
    window."""
    for budget, window, size in results["ray_tpu_torch"][
            "streaming_window_from_store_budget"]:
        assert 2 * MB <= size < 2 * MB + 64 * 1024
        assert window == max(2, int(budget * 0.5 // size))
    (_, small, _), (_, large, _) = results["ray_tpu_torch"][
        "streaming_window_from_store_budget"]
    assert 2 <= small <= 4 and small != 4
    assert large > 4
    # The reference sizes its window by the same rule.
    for budget, window, size in results["ray_tpu"][
            "streaming_window_from_store_budget"]:
        assert window == max(2, int(budget * 0.5 // size))


def test_a_tail_window_of_one_block_shuffles_that_block(results):
    """The stream's last window may hold one block: its rows come out
    permuted, and the windows before it are the shorter run's, bit for
    bit."""
    tail = results["ray_tpu_torch"]["streaming_shuffle_tail_window"]
    six = results["ray_tpu"]["streaming_shuffle_windows"][1]
    assert len(tail) == 7
    _same(tail[:6], six)
    np.testing.assert_array_equal(np.sort(tail[6]["id"]),
                                  np.arange(6 * 300, 7 * 300))
    assert not np.array_equal(tail[6]["id"], np.arange(6 * 300, 7 * 300))


def test_the_reference_tests_conditions_hold_on_the_port(results):
    r = results["ray_tpu_torch"]
    assert len(r["streaming_bounded_inflight"]) == 24
    out = [b["id"] for b in r["streaming_shuffle_preserves_rows"]]
    np.testing.assert_array_equal(np.sort(np.concatenate(out)),
                                  np.arange(6 * 500))
    assert not np.array_equal(np.concatenate(out)[:500], np.arange(500))
    assert r["eager_dataset_to_streaming"][0] == 4000
    np.testing.assert_array_equal(
        np.sort(np.concatenate([b["v"] for b in r["read_streaming_files"]])),
        np.arange(400))
    out = [b["id"] for b in r["push_shuffle_preserves_rows"]]
    np.testing.assert_array_equal(np.sort(np.concatenate(out)),
                                  np.arange(6 * 500))
    assert not np.array_equal(np.concatenate(out)[:500], np.arange(500))
    window, full = (set(np.unique(b["blk"]).tolist())
                    for b in r["full_shuffle_beats_window_scoped_mixing"])
    assert len(window) <= 2 and len(full) >= 10 and len(full) > len(window)
    plan, batches = r["fused_read_map_is_one_task"]
    assert "Fused[read -> map_batches -> filter]" in plan
    expect = np.arange(400, dtype=np.int64) * 2
    np.testing.assert_array_equal(
        np.sort(np.concatenate([b["v"] for b in batches])),
        expect[expect % 4 == 0])
    plan, count = r["thunk_sources_unfused_plan"]
    assert "Sources x2" in plan and "map_batches" in plan and count == 20


def test_device_batches_default_to_cuda_and_take_the_cpu_when_asked():
    """``iter_device_batches`` places on CUDA unless given
    ``device="cpu"``; without a card the default raises."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import data

    rt.init(num_cpus=2, object_store_memory=64 * MB)
    try:
        sd = data.StreamingDataset(_gen_thunks("ray_tpu_torch", 3, 40),
                                   max_inflight_blocks=2)
        host = list(sd.iter_batches(16))
        got = list(sd.iter_device_batches(16, device="cpu"))
        assert [b["id"].device.type for b in got] == ["cpu"] * len(host)
        for g, h in zip(got, host):
            assert torch.equal(g["id"], torch.from_numpy(h["id"]))
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="cuda"):
                sd.iter_device_batches(16)
    finally:
        rt.shutdown()


def test_window_shuffle_keeps_the_store_within_its_budget(tmp_path):
    """The port's window shuffle holds one window's blocks and their
    outputs, and no earlier block: sampled every half millisecond, the
    store holds at most four 256 KiB blocks, within a budget of five (a
    window of 2), with a fast consumer and a slow one."""
    import threading
    import time

    import ray_tpu_torch as rt
    from ray_tpu_torch import data

    rows = np.random.default_rng(0).integers(0, 50257, (8 * 64, 1024),
                                             dtype=np.int32)
    paths = []
    for i in range(8):
        paths.append(str(tmp_path / f"r{i}.npy"))
        np.save(paths[-1], rows[i * 64:(i + 1) * 64])
    budget = 5 * (tmp_path / "r0.npy").stat().st_size
    rt.init(num_cpus=2, object_store_memory=64 * MB)
    try:
        for pause in (0.0, 0.02):
            base, peak = _store_used(rt), [0]
            stop = threading.Event()

            def sample():
                while not stop.is_set():
                    peak[0] = max(peak[0], _store_used(rt) - base)
                    time.sleep(0.0005)

            thread = threading.Thread(target=sample, daemon=True)
            thread.start()
            sd = data.read_streaming(paths, "numpy", store_budget=budget
                                     ).random_shuffle(seed=0)
            got = []
            for b in sd.iter_batches(16):
                got.append(b["data"])
                time.sleep(pause)
            stop.set()
            thread.join(timeout=T)
            assert not thread.is_alive()
            assert sorted(r.tobytes() for r in np.concatenate(got)) == \
                sorted(r.tobytes() for r in rows)
            # A window of 2 (half the budget over a block's stored size)
            # and its 2 outputs: 4 blocks, and not a fifth.
            block = (tmp_path / "r0.npy").stat().st_size
            assert 0 < peak[0] <= min(budget, 4.5 * block), (pause, peak[0])
    finally:
        rt.shutdown()


# ---------------------------------------------------------------------------
# The reference's slow gates, on the port
# ---------------------------------------------------------------------------
@pytest.fixture
def port_cluster():
    import ray_tpu_torch as rt

    rt.init(num_cpus=4, object_store_memory=256 * MB)
    yield rt
    rt.shutdown()


@pytest.mark.slow  # as test_streaming_data.py:63
def test_streaming_gb_scale_through_quarter_gb_store(port_cluster):
    """~1 GiB flows read->map->shuffle->iter through a 256 MiB store
    without overflowing it (32 MiB blocks x 32)."""
    from ray_tpu_torch import data

    rt = port_cluster
    rows_per_block, num_blocks = 2 * MB, 32
    sd = data.StreamingDataset(
        _gen_thunks("ray_tpu_torch", num_blocks, rows_per_block),
        store_budget=128 * MB)
    pipe = (sd.map_batches(lambda b: {"id": b["id"], "x": b["x"] * 3})
            .random_shuffle(seed=1))
    total_rows = checksum = peak = 0
    for batch in pipe.iter_batches(batch_size=rows_per_block // 2):
        total_rows += len(batch["id"])
        checksum += int(batch["x"][0])
        peak = max(peak, _store_used(rt))
    assert total_rows == num_blocks * rows_per_block
    assert checksum == 3 * (total_rows // (rows_per_block // 2))
    assert peak <= 256 * MB, f"store overflowed: peak {peak / MB:.0f}MB"


def _run_over_budget_shuffle(rt, n_blocks, rows_per_block, budget):
    from ray_tpu_torch import data

    sd = data.StreamingDataset(
        _gen_thunks("ray_tpu_torch", n_blocks, rows_per_block, "blk"),
        store_budget=budget)
    total, seen, peak = 0, set(), 0
    for b in sd.random_shuffle(seed=1, full=True).iter_batches(
            rows_per_block // 2):
        total += len(b["id"])
        seen.update(np.unique(b["blk"]).tolist())
        peak = max(peak, _store_used(rt))
    assert total == n_blocks * rows_per_block
    assert seen == set(range(n_blocks))
    assert peak <= 256 * MB, f"store overflowed: peak {peak / MB:.0f}MB"


@pytest.mark.slow  # as test_push_shuffle.py:86
def test_push_shuffle_beyond_store_budget(port_cluster):
    _run_over_budget_shuffle(port_cluster, 12, MB // 2, 32 * MB)


@pytest.mark.slow  # as test_push_shuffle.py:94
def test_push_shuffle_384mb_through_64mb_budget(port_cluster):
    _run_over_budget_shuffle(port_cluster, 24, MB, 64 * MB)
