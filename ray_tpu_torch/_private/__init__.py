"""Copied from ``ray_tpu/_private/__init__.py`` (the JAX package)."""
import os


def inject_pkg_pythonpath(env: dict) -> dict:
    """Prepend the ray_tpu_torch package parent to env['PYTHONPATH'] so spawned
    subprocesses (workers, node-agent workers, job entrypoints) can import
    ray_tpu_torch even when the driver runs from a source tree rather than an
    installed package.  Skips empty segments — a trailing ':' would put the
    subprocess cwd on sys.path and shadow stdlib modules."""
    import ray_tpu_torch as _pkg

    pkg_parent = os.path.dirname(os.path.dirname(
        os.path.abspath(_pkg.__file__)))
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (pkg_parent, env.get("PYTHONPATH")) if p)
    return env
