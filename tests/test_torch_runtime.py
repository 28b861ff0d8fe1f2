"""The port's task/actor/object runtime against the JAX package's.

The same scenarios run through ``ray_tpu`` and through ``ray_tpu_torch``
(parametrised over the package, one module-scoped cluster at a time) and
must give the same results and raise the same exception classes.  The
port's own part, GPU partitioning by ``CUDA_VISIBLE_DEVICES``, runs on
the CPU with a declared ``num_gpus=2``.  Every ``get`` has a timeout."""
import importlib
import os
import sys
import time

import numpy as np
import pytest

T = 60  # seconds: the bound of every get

PACKAGES = ("ray_tpu", "ray_tpu_torch")
# The accelerator resource of each package: the reference's TPU chips,
# the port's GPUs.
ACCEL = {"ray_tpu": "TPU", "ray_tpu_torch": "GPU"}


@pytest.fixture(scope="module", params=PACKAGES)
def rt(request):
    pkg = importlib.import_module(request.param)
    accel = {"ray_tpu": {"num_tpus": 2}, "ray_tpu_torch": {"num_gpus": 2}}
    pkg.init(num_cpus=4, object_store_memory=256 * 1024**2,
             **accel[request.param])
    yield pkg
    pkg.shutdown()


# The port's own tests take only the port's cluster.
port_only = pytest.mark.parametrize("rt", ["ray_tpu_torch"], indirect=True)


def _name(exc_info) -> str:
    return type(exc_info.value).__name__


def test_put_get_and_a_zero_copy_array(rt):
    assert rt.get(rt.put(42), timeout=T) == 42
    assert rt.get(rt.put({"a": [1, 2, 3]}), timeout=T) == {"a": [1, 2, 3]}
    x = np.arange(1_000_000, dtype=np.float32)
    ref = rt.put(x)
    rt._worker()._value_cache.clear()  # force a read from the store
    y = rt.get(ref, timeout=T)
    assert np.array_equal(x, y) and y.dtype == np.float32
    assert not y.flags.owndata  # a view over the store's memory

    @rt.remote
    def inspect(a):
        return float(a.sum()), a.flags.owndata

    assert rt.get(inspect.remote(ref), timeout=T) == (float(x.sum()), False)


def test_tasks_ref_args_multiple_returns_and_nesting(rt):
    @rt.remote
    def double(v):
        return v * 2

    @rt.remote(num_returns=3)
    def three():
        return 1, 2, 3

    @rt.remote
    def outer(v):
        return rt.get(double.remote(v), timeout=T) + 10

    assert rt.get(double.remote(rt.put(21)), timeout=T) == 42
    assert rt.get(list(three.remote()), timeout=T) == [1, 2, 3]
    assert rt.get(outer.remote(1), timeout=T) == 12
    assert rt.get([double.remote(i) for i in range(20)], timeout=T) == \
        [2 * i for i in range(20)]


def test_actors_state_named_and_get_actor(rt):
    @rt.remote
    class Counter:
        def __init__(self, start):
            self.n = start

        def inc(self, by=1):
            self.n += by
            return self.n

    c = Counter.options(name="counter").remote(10)
    assert rt.get([c.inc.remote() for _ in range(3)], timeout=T) == \
        [11, 12, 13]
    same = rt.get_actor("counter")
    assert rt.get(same.inc.remote(5), timeout=T) == 18
    rt.kill(c)


def test_task_and_actor_errors_keep_their_class_names(rt):
    @rt.remote
    def boom():
        raise ValueError("kaboom")

    @rt.remote
    class Broken:
        def fail(self):
            raise KeyError("missing")

    with pytest.raises(Exception, match="kaboom") as e:
        rt.get(boom.remote(), timeout=T)
    assert _name(e) == "TaskError" and e.value.cause_cls_name == "ValueError"
    b = Broken.remote()
    with pytest.raises(Exception, match="missing") as e:
        rt.get(b.fail.remote(), timeout=T)
    assert _name(e) == "TaskError"
    rt.kill(b)
    with pytest.raises(Exception) as e:
        rt.get(b.fail.remote(), timeout=T)
    assert _name(e) == "ActorDiedError"


def test_wait_and_cancel(rt):
    @rt.remote
    def sleepy(s):
        time.sleep(s)
        return s

    @rt.remote(num_cpus=4)
    def hog(s):
        time.sleep(s)
        return s

    fast, slow = sleepy.remote(0), sleepy.remote(3)
    ready, pending = rt.wait([fast, slow], num_returns=1, timeout=T)
    assert ready == [fast] and pending == [slow]
    assert rt.get(slow, timeout=T) == 3
    # A task queued behind one that holds every CPU is cancelled.
    held = hog.remote(3)
    deadline = time.monotonic() + T
    while rt.available_resources().get("CPU", 0) > 0:  # hog is placed
        assert time.monotonic() < deadline
        time.sleep(0.05)
    queued = sleepy.remote(0)
    rt.cancel(queued)
    with pytest.raises(Exception, match="cancelled") as e:
        rt.get(queued, timeout=T)
    assert _name(e) == "RayTpuError"
    assert rt.get(held, timeout=T) == 3


@port_only
def test_get_timeout_on_a_pending_task_raises_get_timeout_error(rt):
    """The port's copy of test_core_basic.py::test_get_timeout: the head's
    ``GetTimeoutError`` reaches the caller (the JAX package's copy turns it
    into an ``RpcTimeoutError``), and it is both a ``RayTpuError`` and a
    ``TimeoutError``, as the port's own deadline waits expect."""
    @rt.remote
    def never():
        time.sleep(60)

    ref = never.remote()
    t0 = time.monotonic()
    with pytest.raises(rt.exceptions.GetTimeoutError) as e:
        rt.get(ref, timeout=0.5)
    assert time.monotonic() - t0 < 10
    assert isinstance(e.value, rt.exceptions.RayTpuError)
    assert isinstance(e.value, TimeoutError)
    # Cancelled, placed or running, the task gives its CPU back (one
    # cancelled while its worker still started kept it in the JAX
    # package's copy).
    rt.cancel(ref)
    deadline = time.monotonic() + T
    while rt.available_resources().get("CPU", 0) < 4:
        assert time.monotonic() < deadline
        time.sleep(0.05)


@port_only
def test_cancel_a_running_task_after_wait(rt, tmp_path):
    """A task that has started, and that ``wait`` then sees still
    running, is cancelled: its ``get`` raises the cancellation at once,
    and the cluster runs the next task."""
    marker = str(tmp_path / "started")

    @rt.remote
    def slow(path):
        with open(path, "w"):
            pass
        time.sleep(30)
        return "slow"

    ref = slow.remote(marker)
    deadline = time.monotonic() + T
    while not os.path.exists(marker):  # the task body runs
        assert time.monotonic() < deadline
        time.sleep(0.05)
    ready, pending = rt.wait([ref], num_returns=1, timeout=0.5)
    assert ready == [] and pending == [ref]
    rt.cancel(ref)
    t0 = time.monotonic()
    with pytest.raises(Exception, match="cancelled") as e:
        rt.get(ref, timeout=T)
    assert _name(e) == "RayTpuError" and time.monotonic() - t0 < 10

    @rt.remote
    def one():
        return 1

    assert rt.get(one.remote(), timeout=T) == 1


def test_put_many_and_get_many(rt):
    values = [i * np.ones(3000, np.float64) for i in range(5)] + ["s", 7]
    refs = rt.put_many(values)
    got = rt.get_many(refs, timeout=T)
    assert all(np.array_equal(a, b) for a, b in zip(got[:5], values[:5]))
    assert got[5:] == ["s", 7]


def test_placement_group_and_cluster_resources(rt):
    pgm = importlib.import_module(rt.__name__ + ".util.placement_group")
    strategies = importlib.import_module(
        rt.__name__ + ".util.scheduling_strategies")
    res = rt.cluster_resources()
    accel = ACCEL[rt.__name__]
    assert {k: v for k, v in res.items() if k != "memory"} == \
        {"CPU": 4.0, accel: 2.0}
    pg = pgm.placement_group([{"CPU": 1}, {"CPU": 1}], strategy="PACK")
    pg.ready(timeout=T)
    assert rt.available_resources()["CPU"] <= 2.0

    @rt.remote(num_cpus=1)
    def where():
        return "in the group"

    strategy = strategies.PlacementGroupSchedulingStrategy(
        placement_group=pg, placement_group_bundle_index=0)
    assert rt.get(where.options(scheduling_strategy=strategy).remote(),
                  timeout=T) == "in the group"
    pgm.remove_placement_group(pg)
    deadline = time.monotonic() + T
    while rt.available_resources().get("CPU", 0) < 4.0:
        assert time.monotonic() < deadline
        time.sleep(0.1)


@port_only
def test_gpu_actors_partition_the_declared_gpus(rt):
    port = rt

    @port.remote(num_gpus=1)
    class OnGPU:
        def visible(self):
            return os.environ.get("CUDA_VISIBLE_DEVICES")

    a, b = OnGPU.remote(), OnGPU.remote()
    assert sorted(port.get([a.visible.remote(), b.visible.remote()],
                           timeout=T)) == ["0", "1"]
    c = OnGPU.remote()
    third = c.visible.remote()
    ready, _ = port.wait([third], timeout=2)
    assert not ready  # both GPUs are held: the third actor waits
    first = port.get(a.visible.remote(), timeout=T)
    port.kill(a)
    assert port.get(third, timeout=T) == first  # it got a's GPU
    port.kill(b)
    port.kill(c)


@port_only
def test_a_task_without_gpus_sees_none_and_cannot_resolve_cuda(rt):
    port = rt

    @port.remote(num_gpus=1)
    def gpu_task():
        return os.environ.get("CUDA_VISIBLE_DEVICES")

    @port.remote
    def cpu_task():
        try:
            port.resolve_device()
            err = None
        except RuntimeError as e:
            err = str(e)
        return os.environ.get("CUDA_VISIBLE_DEVICES"), err

    assert port.get(gpu_task.remote(), timeout=T) in ("0", "1")
    # The GPU task's worker is idle again; a CPU task never takes it.
    for _ in range(3):
        visible, err = port.get(cpu_task.remote(), timeout=T)
        assert visible == "" and "device='cpu'" in err


@port_only
def test_a_gpu_actor_is_never_placed_without_a_gpu(rt):
    port = rt

    @port.remote(num_gpus=3)  # the node declares 2
    class TooBig:
        def visible(self):
            return os.environ.get("CUDA_VISIBLE_DEVICES")

    big = TooBig.remote()
    with pytest.raises(Exception, match="no node can ever satisfy") as e:
        port.get(big.visible.remote(), timeout=T)
    assert _name(e) == "ActorDiedError"  # failed, not run on the CPU


@port_only
def test_port_workers_import_nothing_of_the_jax_package(rt):
    port = rt

    @port.remote
    def jax_modules():
        return sorted(m for m in sys.modules
                      if m in ("jax", "ray_tpu") or m.startswith("ray_tpu."))

    @port.remote(num_gpus=1)
    class OnGPU:
        def jax_modules(self):
            return sorted(m for m in sys.modules if m in ("jax", "ray_tpu")
                          or m.startswith("ray_tpu."))

    g = OnGPU.remote()
    assert port.get(jax_modules.remote(), timeout=T) == []
    assert port.get(g.jax_modules.remote(), timeout=T) == []
    port.kill(g)


@port_only
def test_torch_tensors_cross_processes(rt):
    import torch

    port = rt

    sd = {"w": torch.randn(256, 64).to(torch.bfloat16),
          "b": torch.arange(10), "mask": torch.ones(5, dtype=torch.bool)}

    @port.remote
    def echo(d):
        return {k: (v * 1 if v.dtype != torch.bool else v)
                for k, v in d.items()}

    out = port.get(echo.remote(sd), timeout=T)
    assert all(torch.equal(out[k], sd[k]) and out[k].dtype == sd[k].dtype
               for k in sd)


@port_only
def test_a_worker_writes_a_stored_tensor_as_it_writes_a_stored_array(rt):
    """A tensor read from a shared-memory segment shares it, as a numpy
    array does: a worker's in-place write lands in the stored object,
    and a later reader on the node sees it, for both.  (Over read-only
    memory, the native arena's, the tensor is a private copy instead:
    test_torch_serialization.py holds that.)"""
    import torch

    port = rt
    t = torch.arange(100_000, dtype=torch.float32)
    a = np.arange(100_000, dtype=np.float32)
    refs = [port.put(t), port.put(a)]

    @port.remote
    def write(x):
        x += 1
        return float(x.sum())

    assert port.get([write.remote(r) for r in refs], timeout=T) == \
        [float((t + 1).sum()), float((a + 1).sum())]
    port._worker()._value_cache.clear()
    t2, a2 = port.get(refs, timeout=T)
    assert torch.equal(t2, t + 1) and np.array_equal(a2, a + 1)


@port_only
def test_a_recycled_segment_outlives_a_reader_that_exits(rt):
    """The driver's large puts recycle one pool segment under one name,
    and a reader attaches it again for each object.  Python 3.12
    registers every attach with the reader's resource tracker: a
    registration left from the second attach would unlink the segment
    when the reader exits, and the next reader of the recycled segment
    would find the object gone."""
    port = rt

    @port.remote
    class Reader:
        def total(self, x):
            return float(x.sum())

    a = Reader.remote()
    for v in range(3):
        ref = port.put(np.full(1 << 20, v, np.float32))  # 4 MiB: pooled
        assert port.get(a.total.remote(ref), timeout=T) == float(v << 20)
        del ref
    port.kill(a)
    time.sleep(1.0)  # the reader's tracker cleans up after it
    ref = port.put(np.full(1 << 20, 5, np.float32))
    b = Reader.remote()
    assert port.get(b.total.remote(ref), timeout=T) == float(5 << 20)
    port.kill(b)
