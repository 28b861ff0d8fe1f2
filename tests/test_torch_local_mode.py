"""``init(local_mode=True)`` of the port against the JAX package's: tasks
and actors run inline in the driver, with the same results and the same
exception classes."""
import importlib

import pytest


@pytest.mark.parametrize("name", ["ray_tpu", "ray_tpu_torch"])
def test_local_mode_runs_tasks_and_actors_inline(name):
    rt = importlib.import_module(name)
    rt.init(local_mode=True)
    try:
        @rt.remote
        def square(x):
            return x * x

        @rt.remote
        def boom():
            raise ValueError("kaboom")

        @rt.remote
        class Counter:
            def __init__(self):
                self.n = 0

            def inc(self):
                self.n += 1
                return self.n

        assert rt.is_initialized()
        assert rt.get([square.remote(i) for i in range(4)], timeout=10) == \
            [0, 1, 4, 9]
        assert rt.get(square.remote(rt.put(7)), timeout=10) == 49
        c = Counter.remote()
        assert rt.get([c.inc.remote(), c.inc.remote()], timeout=10) == [1, 2]
        with pytest.raises(Exception, match="kaboom") as e:
            rt.get(boom.remote(), timeout=10)
        assert type(e.value).__name__ == "ValueError"  # raised as is
    finally:
        rt.shutdown()
    assert not rt.is_initialized()
