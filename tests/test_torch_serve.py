"""The port's Serve control plane against the JAX package's (after
tests/test_serve_control.py and the Serve cases of
tests/test_data_serve_util.py).

- ``calculate_desired_num_replicas`` equals ``ray_tpu``'s on a grid;
- ``@serve.batch``: plain-function and method forms, item-exception
  isolation, and ``close`` waking blocked waiters with a typed error;
- ``ASGIAdapter.handle`` gives ``ray_tpu``'s responses for the same app
  and requests;
- on one module cluster of the port's runtime: function and class
  deployments through a handle and over HTTP, an ASGI ingress over HTTP,
  autoscaling up under load and back down, ``options`` copies that do
  not share replicas, and teardown draining the replicas' batchers.

Every ``get`` has a timeout; torch runs on one intra-op thread."""
from __future__ import annotations

import itertools
import json
import os
import sys
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import cloudpickle
import pytest
import torch

from ray_tpu.serve import asgi as jasgi
from ray_tpu.serve import autoscaling as jautoscaling
from ray_tpu_torch import serve
from ray_tpu_torch.exceptions import BatcherClosedError
from ray_tpu_torch.serve import batching

T = 60  # seconds: the bound of every get


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cluster():
    import ray_tpu_torch
    from ray_tpu_torch._private.config import CONFIG
    from ray_tpu_torch.serve.controller import reset_controller

    key = "RAY_TPU_TORCH_SERVE_CONTROL_INTERVAL_S"
    old = os.environ.get(key)
    os.environ[key] = "0.2"
    CONFIG.reset()  # the env override applies to the next read
    reset_controller()
    ray_tpu_torch.init(num_cpus=8, object_store_memory=128 * 1024**2)
    # Workers cannot import tests/: what this module sends them (the
    # ASGI app) pickles by value.
    cloudpickle.register_pickle_by_value(sys.modules[__name__])
    try:
        yield ray_tpu_torch
    finally:
        cloudpickle.unregister_pickle_by_value(sys.modules[__name__])
        serve.shutdown()
        ray_tpu_torch.shutdown()
        if old is None:
            os.environ.pop(key, None)
        else:
            os.environ[key] = old
        CONFIG.reset()


# ---------------------------------------------------------------------------
# the policy and the batcher (no cluster)
# ---------------------------------------------------------------------------
def test_calculate_desired_num_replicas_matches_jax():
    grid = itertools.product((0, 1, 2, 5), (0.0, 0.4, 1.0, 2.5, 9.0),
                             (0.5, 1.0, 4.0), (1, 2), (3, 10),
                             (0.5, 1.0))
    for cur, avg, target, lo, hi, smooth in grid:
        args = (cur, avg, target, lo, hi, smooth)
        assert serve.calculate_desired_num_replicas(*args) == \
            jautoscaling.calculate_desired_num_replicas(*args), args


def test_batch_decorator_plain_function():
    calls = []

    @serve.batch(max_batch_size=4, batch_wait_timeout_s=0.1)
    def double(items):
        calls.append(len(items))
        return [x * 2 for x in items]

    with ThreadPoolExecutor(8) as pool:
        out = sorted(pool.map(double, range(8)))
    assert out == [0, 2, 4, 6, 8, 10, 12, 14]
    assert max(calls) > 1 and max(calls) <= 4


def test_batch_decorator_method_form_batches_per_instance():
    class Model:
        def __init__(self, k):
            self.k = k
            self.sizes = []

        @serve.batch(max_batch_size=8, batch_wait_timeout_s=0.2)
        def predict(self, items):
            self.sizes.append(len(items))
            return [x * self.k for x in items]

    a, b = Model(2), Model(3)
    with ThreadPoolExecutor(8) as pool:
        got_a = sorted(pool.map(a.predict, range(8)))
        got_b = sorted(pool.map(b.predict, range(4)))
    assert got_a == [2 * i for i in range(8)]
    assert got_b == [3 * i for i in range(4)]
    assert max(a.sizes) > 1 and sum(a.sizes) == 8 and sum(b.sizes) == 4
    batching.close_instance_batchers(a)
    batching.close_instance_batchers(b)


@pytest.mark.parametrize("form", ["function", "method"])
def test_batch_item_exception_isolated(form):
    """One poisoned item fails only its own caller; its batchmates still
    get results."""
    def handler(items):
        if any(x == 3 for x in items):
            raise ValueError("bad item 3")
        return [x * 2 for x in items]

    if form == "function":
        call = serve.batch(max_batch_size=8,
                           batch_wait_timeout_s=0.1)(handler)
    else:
        class Model:
            @serve.batch(max_batch_size=8, batch_wait_timeout_s=0.1)
            def predict(self, items):
                return handler(items)

        call = Model().predict
    with ThreadPoolExecutor(8) as pool:
        futs = [pool.submit(call, i) for i in range(8)]
        results, failed = [], []
        for i, f in enumerate(futs):
            try:
                results.append(f.result(timeout=30))
            except ValueError:
                failed.append(i)
    assert failed == [3], f"wrong/extra items poisoned: {failed}"
    assert sorted(results) == [0, 2, 4, 8, 10, 12, 14]


def test_batcher_close_wakes_blocked_waiters():
    """Closing a batcher wakes queued submitters with BatcherClosedError,
    lets the in-flight batch finish, stops its thread, and leaves the
    decorated function usable again (a fresh batcher)."""
    started = threading.Event()

    @serve.batch(max_batch_size=1, batch_wait_timeout_s=5.0)
    def slow(items):
        started.set()
        time.sleep(0.5)
        return items

    got, errs = [], []

    def waiter(x):
        try:
            got.append(slow(x))
        except BatcherClosedError:
            errs.append(x)

    t1 = threading.Thread(target=waiter, args=(1,), daemon=True)
    t1.start()
    assert started.wait(10)
    t2 = threading.Thread(target=waiter, args=(2,), daemon=True)
    t2.start()
    time.sleep(0.2)  # item 2 queues behind the in-flight batch
    batching.shutdown_batchers()
    t1.join(30)
    t2.join(30)
    assert not t1.is_alive() and not t2.is_alive()
    assert got == [1], f"in-flight batch lost its result: {got}"
    assert errs == [2], f"queued waiter not woken with typed error: {errs}"
    time.sleep(0.2)
    assert not any(t.name.startswith("rtpu-flow-serve-batch")
                   and t.is_alive() for t in threading.enumerate()), \
        "batcher thread leaked"
    assert slow(9) == 9
    batching.shutdown_batchers()


# ---------------------------------------------------------------------------
# ASGI
# ---------------------------------------------------------------------------
async def _app(scope, receive, send):
    """An ASGI app that echoes what it was given: method, path, query, a
    header and the body, with a status from the path and two Set-Cookie
    headers."""
    msg = await receive()
    headers = dict(scope["headers"])
    status = 404 if scope["path"].endswith("/missing") else 200
    body = json.dumps({"method": scope["method"], "path": scope["path"],
                       "query": scope["query_string"].decode(),
                       "x": headers.get(b"x-test", b"").decode(),
                       "body": msg["body"].decode()}).encode()
    await send({"type": "http.response.start", "status": status,
                "headers": [(b"content-type", b"application/json"),
                            (b"set-cookie", b"a=1"),
                            (b"set-cookie", b"b=2")]})
    await send({"type": "http.response.body", "body": body[:10],
                "more_body": True})
    await send({"type": "http.response.body", "body": body[10:]})


REQUESTS = [
    {"method": "GET", "path": "/items/7", "query_string": "q=1&r=2",
     "headers": [("X-Test", "yes")], "body": b""},
    {"method": "post", "path": "/submit", "headers": {"X-Test": "post"},
     "body": "payload"},
    {"method": "GET", "path": "/a/missing?z=9", "body": b""},
    {"path": "/"},
]


def test_asgi_adapter_matches_jax():
    mine, theirs = serve.ASGIAdapter(_app), jasgi.ASGIAdapter(_app)
    for req in REQUESTS:
        got, want = mine.handle(dict(req)), theirs.handle(dict(req))
        assert got == want, req
    assert mine.handle(dict(REQUESTS[0]))["headers"][1:] == \
        [("set-cookie", "a=1"), ("set-cookie", "b=2")]


# ---------------------------------------------------------------------------
# deployments on the port's runtime (one module cluster)
# ---------------------------------------------------------------------------
def _post(port, name, payload, timeout=T):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/{name}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


def test_function_and_class_deployments_through_a_handle_and_http(cluster):
    rt = cluster

    @serve.deployment(num_replicas=2)
    def square(x):
        return x * x

    handle = serve.run(square.bind())
    assert handle.num_replicas == 2
    assert rt.get([handle.remote(i) for i in range(6)], timeout=T) == \
        [i * i for i in range(6)]

    @serve.deployment(name="adder")
    class Adder:
        def __init__(self, base):
            self.base = base

        def __call__(self, payload):
            return self.base + payload["x"]

        def scale(self, k):
            return self.base * k

    adder = serve.run(Adder.bind(10))
    assert rt.get(adder.remote({"x": 5}), timeout=T) == 15
    assert rt.get(adder.method("scale").remote(3), timeout=T) == 30
    assert serve.get_deployment_handle("adder") is adder
    port = serve.start_http_proxy()
    assert _post(port, "adder", {"x": 7}) == (200, {"result": 17})
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(port, "nothing", {"x": 1})
    assert e.value.code == 404
    serve.delete("square")
    serve.delete("adder")


def test_asgi_ingress_over_http(cluster):
    serve.run(serve.ingress(_app, name="app"))
    port = serve.start_http_proxy()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/app/items/3?k=v", data=b"hi",
        headers={"X-Test": "proxy"}, method="PUT")
    with urllib.request.urlopen(req, timeout=T) as resp:
        body = json.loads(resp.read())
        cookies = resp.headers.get_all("Set-Cookie")
    assert body == {"method": "PUT", "path": "/items/3", "query": "k=v",
                    "x": "proxy", "body": "hi"}
    assert cookies == ["a=1", "b=2"]
    serve.delete("app")


def test_autoscales_up_under_load_and_back_down(cluster):
    rt = cluster

    @serve.deployment(name="slow", autoscaling_config={
        "min_replicas": 1, "max_replicas": 3,
        "target_num_ongoing_requests_per_replica": 1.0,
        "look_back_polls": 1})
    def slow(x):
        time.sleep(0.4)
        return x

    handle = serve.run(slow.bind())
    assert handle.num_replicas == 1
    stop = threading.Event()

    def pound():
        while not stop.is_set():
            try:
                rt.get(handle.remote(1), timeout=30)
            except Exception:
                return

    threads = [threading.Thread(target=pound, daemon=True)
               for _ in range(8)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline and handle.num_replicas < 2:
        time.sleep(0.2)
    scaled_up = handle.num_replicas
    stop.set()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert scaled_up >= 2, "controller never scaled up under load"
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline and handle.num_replicas > 1:
        time.sleep(0.2)
    assert handle.num_replicas == 1, "controller never scaled back down"
    serve.delete("slow")


def test_options_copies_do_not_share_replicas(cluster):
    rt = cluster

    @serve.deployment
    def model(x):
        return x * 2

    a = serve.run(model.options(), name="opt_a")
    b = serve.run(model.options(), name="opt_b")
    assert rt.get(a.remote(2), timeout=T) == 4
    assert rt.get(b.remote(3), timeout=T) == 6
    serve.delete("opt_a")
    assert rt.get(b.remote(5), timeout=T) == 10
    serve.delete("opt_b")


def test_teardown_drains_replica_batchers(cluster):
    """Deleting a deployment drains its replicas (drain before kill); a
    second deployment's batchers are untouched."""
    rt = cluster

    class Batched:
        def __init__(self):
            self.sizes = []

        @serve.batch(max_batch_size=4, batch_wait_timeout_s=0.05)
        def predict(self, items):
            self.sizes.append(len(items))
            return [x * 2 for x in items]

        def __call__(self, x):
            return self.predict(x)

        def seen(self):
            return list(self.sizes)

    a = serve.run(serve.deployment(Batched, name="drain_a").bind(),
                  name="drain_a")
    b = serve.run(serve.deployment(Batched, name="drain_b").bind(),
                  name="drain_b")
    assert sorted(rt.get([a.remote(i) for i in range(8)], timeout=T)) == \
        [2 * i for i in range(8)]
    assert max(rt.get(a.method("seen").remote(), timeout=T)) > 1
    assert rt.get(b.remote(3), timeout=T) == 6
    replica = serve.api._deployments["drain_a"]._replicas[0]
    serve.delete("drain_a")
    assert rt.get(b.remote(5), timeout=T) == 10
    with pytest.raises(Exception):
        rt.get(replica.handle_request.remote("__call__", (1,), {}),
               timeout=T)
    serve.delete("drain_b")
