"""ray_tpu_torch: the PyTorch/CUDA port of ``ray_tpu`` for NVIDIA Hopper.

The layout mirrors the JAX package (``ops/attention.py`` here is the
counterpart of ``ray_tpu/ops/attention.py``, and so on).  The port
imports ``torch`` and never JAX or anything of ``ray_tpu``.  Every entry
point runs on ``cuda`` unless the caller passes ``device="cpu"``; asking
for CUDA where there is none raises rather than running on the CPU.

The core API is copied from ``ray_tpu/__init__.py`` (the JAX package):
init/shutdown, remote, get/put/wait, actors, placement groups and state
queries, on a single-host head with subprocess workers and a
shared-memory object store.  GPUs take the place of TPU chips: ``init``
takes ``num_gpus`` and the resource is ``"GPU"``.  ``import
ray_tpu_torch`` stays torch-free, so a CPU worker starts without
importing torch; ``resolve_device`` is loaded on first use.
"""
from __future__ import annotations

import os
import threading
from typing import Any, Dict, List, Optional, Sequence

from ray_tpu_torch import exceptions  # noqa: F401
from ray_tpu_torch._private.ids import JobID, NodeID, ObjectID, WorkerID
from ray_tpu_torch.object_ref import ObjectRef  # noqa: F401
from ray_tpu_torch.actor import ActorClass, ActorHandle  # noqa: F401
from ray_tpu_torch.remote_function import RemoteFunction
from ray_tpu_torch.runtime_context import get_runtime_context  # noqa: F401

__version__ = "0.1.0"

_head = None
_head_lock = threading.RLock()


def _global_head():
    return _head


def _default_num_cpus() -> float:
    env = os.environ.get("RAY_TPU_NUM_CPUS")
    if env:
        return float(env)
    # On tiny dev machines a detected count of 1 starves multi-actor
    # workloads; logical CPUs are a scheduling token here, not a cgroup.
    return float(max(os.cpu_count() or 1, 8))


def _detect_num_gpus() -> float:
    env = os.environ.get("RAY_TPU_NUM_GPUS")
    if env:
        return float(env)
    import torch

    # device_count() reads the driver's count without creating a CUDA
    # context, so the driver does not hold the card its workers are given.
    return float(torch.cuda.device_count())


def _boot_head(resources: Dict[str, float], labels=None,
               store_capacity: int = 2 * 1024**3) -> NodeID:
    """Start the in-process head with one node; driver connects separately."""
    global _head
    from ray_tpu_torch._private.head import Head

    with _head_lock:
        if _head is not None:
            raise RuntimeError("already initialized")
        _head = Head()
        return _head.add_node(resources, labels, store_capacity=store_capacity)


def _apply_job_config(worker, job_config: Optional[dict]) -> None:
    """Job-level defaults → driver worker state (reference: JobConfig's
    ray_namespace/runtime_env semantics): per-call options still win.
    Local py_modules paths are packaged + uploaded here (once, at
    connect) so every spec carrying the default ships pkg:// URIs that
    resolve on any node; job_config is updated in place so head
    registration records the normalized form."""
    if not job_config:
        return
    if job_config.get("namespace"):
        worker.namespace = job_config["namespace"]
    if job_config.get("runtime_env"):
        from ray_tpu_torch._private.runtime_env_pkg import normalize_py_modules

        job_config["runtime_env"] = normalize_py_modules(
            job_config["runtime_env"], worker.transport)
        worker.default_runtime_env = job_config["runtime_env"]


def _connect_driver(job_config: Optional[dict] = None):
    from ray_tpu_torch._private.worker import CoreWorker, DirectTransport, set_global_worker

    with _head_lock:
        job_id = JobID.from_random()
        worker_id = WorkerID.from_random()
        node_id = next(iter(_head.raylets))
        transport = DirectTransport(_head, worker_id)
        worker = CoreWorker(worker_id, node_id, job_id, transport, mode="driver")
        from ray_tpu_torch._private.config import CONFIG

        if CONFIG.direct_transport:
            # The driver owns its tasks' results: start its direct listener
            # (serving fetch/pin for borrowed refs) + lease-caching submitter.
            from ray_tpu_torch._private.direct import DirectServer

            server = DirectServer(worker._owned, _head.authkey,
                                  _head.host_key,
                                  session_dir=_head.session_dir,
                                  on_exec=None, tcp_bind=CONFIG.tcp_host)
            worker.enable_direct(server, _head.host_key)
        _apply_job_config(worker, job_config)
        set_global_worker(worker)
        _head.gcs.add_job(job_id, job_config or {})
    return worker


def init(num_cpus: Optional[float] = None, num_gpus: Optional[float] = None,
         resources: Optional[Dict[str, float]] = None,
         object_store_memory: int = 2 * 1024**3,
         labels: Optional[dict] = None,
         ignore_reinit_error: bool = False,
         address: Optional[str] = None, **kwargs):
    """Start a local cluster head + connect this process as the driver.
    ``num_gpus`` defaults to ``torch.cuda.device_count()`` (or
    ``RAY_TPU_NUM_GPUS``); joining a remote head (``address=``) raises.

    Reference: ray.init (python/ray/_private/worker.py:1043)."""
    global _head
    with _head_lock:
        if is_initialized():
            if ignore_reinit_error:
                return
            raise RuntimeError("ray_tpu_torch.init() called twice "
                               "(pass ignore_reinit_error=True to allow)")
        if kwargs.get("_system_config"):
            from ray_tpu_torch._private.config import CONFIG

            CONFIG.apply_system_config(kwargs["_system_config"])
        if kwargs.get("local_mode"):
            # Inline debugging execution (reference:
            # ray.init(local_mode=True)) — no head, no subprocesses.
            from ray_tpu_torch._private.local_mode import LocalModeWorker
            from ray_tpu_torch._private.worker import set_global_worker

            w = LocalModeWorker()
            set_global_worker(w)
            return w
        if address is not None:
            raise NotImplementedError(
                "joining a remote head (init(address=...)) is the multi-host "
                "part of ROADMAP Queue 1 item 1a, not ported yet")
        res = dict(resources or {})
        res["CPU"] = float(num_cpus) if num_cpus is not None else _default_num_cpus()
        ngpu = float(num_gpus) if num_gpus is not None else _detect_num_gpus()
        if ngpu:
            res["GPU"] = ngpu
        res.setdefault("memory", float(object_store_memory))
        _boot_head(res, labels, store_capacity=object_store_memory)
        worker = _connect_driver(kwargs.get("job_config"))
        if kwargs.get("log_to_driver", True):
            from ray_tpu_torch._private.log_monitor import attach_driver_echo

            attach_driver_echo(_head.gcs)
        return worker


def client(address: str):
    """Ray-Client-style builder (``ray_tpu/__init__.py::client``): client
    mode is the part of ROADMAP Queue 1 item 1a not ported yet."""
    raise NotImplementedError(
        "client mode (ray_tpu_torch.client) is part of ROADMAP Queue 1 "
        "item 1a, not ported yet")


def is_initialized() -> bool:
    from ray_tpu_torch._private.worker import global_worker

    return _head is not None or \
        getattr(global_worker, "mode", None) == "local"


def shutdown():
    global _head
    from ray_tpu_torch._private.worker import global_worker, set_global_worker

    with _head_lock:
        if global_worker is not None:
            if getattr(global_worker, "mode", None) == "local":
                global_worker.shutdown()
            else:
                try:
                    global_worker.shutdown()
                except Exception:
                    pass
            try:
                global_worker._closed = True
            except Exception:
                pass
            set_global_worker(None)
        if _head is not None:
            _head.shutdown()
            _head = None
    # Session boundary: an implicit trace context minted for this
    # session's API calls must not bleed into the next init().
    from ray_tpu_torch import observability as _obs

    _obs.clear_context()


def remote(*args, **kwargs):
    """@remote decorator for functions and classes (reference:
    python/ray/_private/worker.py remote())."""
    if len(args) == 1 and not kwargs and callable(args[0]):
        target = args[0]
        if isinstance(target, type):
            return ActorClass(target)
        return RemoteFunction(target)

    def decorator(target):
        if isinstance(target, type):
            return ActorClass(target, dict(kwargs))
        return RemoteFunction(target, dict(kwargs))

    return decorator


def _worker():
    from ray_tpu_torch._private.worker import global_worker

    if global_worker is None:
        raise RuntimeError("ray_tpu_torch.init() has not been called")
    return global_worker


def put(value: Any) -> ObjectRef:
    return _worker().put(value)


def put_many(values: Sequence[Any]) -> List[ObjectRef]:
    """Put a burst of objects with coalesced control-plane traffic: the
    per-object seal/inline notifications ride one batched message (O(1)
    head messages per burst instead of O(K)).  Bytes move exactly as in
    put()."""
    w = _worker()
    if hasattr(w, "put_many"):
        return w.put_many(list(values))
    return [w.put(v) for v in values]


def get(refs, timeout: Optional[float] = None):
    return _worker().get(refs, timeout)


def get_many(refs: Sequence[ObjectRef], timeout: Optional[float] = None):
    """Batch get for a burst of refs: one resolve round trip covers every
    already-available object (same semantics as get(list))."""
    w = _worker()
    if hasattr(w, "get_many"):
        return w.get_many(list(refs), timeout)
    return w.get(list(refs), timeout)


def wait(refs: Sequence[ObjectRef], num_returns: int = 1,
         timeout: Optional[float] = None, fetch_local: bool = True):
    return _worker().wait(refs, num_returns, timeout, fetch_local)


def kill(actor: ActorHandle, no_restart: bool = True):
    _worker().transport.request(
        "kill_actor", {"actor_id": actor._actor_id, "no_restart": no_restart})


def cancel(ref: ObjectRef, force: bool = False):
    w = _worker()
    if hasattr(w, "cancel_task"):
        w.cancel_task(ref.id.task_id())
    else:
        w.transport.request("cancel", {"task_id": ref.id.task_id()})


def get_actor(name: str, namespace: Optional[str] = None) -> ActorHandle:
    w = _worker()
    if namespace is None:  # fall back to the job's namespace (JobConfig)
        namespace = getattr(w, "namespace", None) or "default"
    info = w.transport.request(
        "get_actor", {"name": name, "namespace": namespace})
    spec = info["creation_spec"]
    return ActorHandle(info["actor_id"], spec.actor_method_names,
                       spec.name.replace(".__init__", ""))


def cluster_resources() -> Dict[str, float]:
    return _worker().transport.request("cluster_resources", {})


def available_resources() -> Dict[str, float]:
    return _worker().transport.request("cluster_resources", {"available": True})


def nodes() -> List[dict]:
    return _worker().transport.request("state", {"what": "nodes"})


def timeline(filename: Optional[str] = None,
             trace_id: Optional[str] = None) -> List[dict]:
    """Chrome-trace dump of task execution (reference: ray.timeline()),
    merged with the tracing plane's cluster spans: per-node pid lanes,
    per-process tid lanes, and cross-process flow arrows.  Pass a
    ``trace_id`` to assemble one distributed trace's timeline."""
    from ray_tpu_torch._private.profiling import chrome_tracing_dump

    try:
        raw = _worker().transport.request(
            "trace_timeline", {"trace_id": trace_id})
        tasks, spans = raw["tasks"], raw["spans"]
    except Exception:
        # Older head without the tracing plane: tasks only.
        tasks, spans = _worker().transport.request(
            "state", {"what": "tasks"}), []
    return chrome_tracing_dump(tasks, filename, spans=spans)


# Submodules re-exported lazily to keep `import ray_tpu_torch` light (torch-free).
def __getattr__(name):
    import importlib

    if name == "resolve_device":
        from ray_tpu_torch._device import resolve_device

        return resolve_device

    if name in ("util", "air", "train", "tune", "data", "serve", "rllib",
                "parallel", "ops", "models", "workflow", "dag",
                "cluster_utils", "state", "internal_kv", "checkpoint",
                "observability"):
        return importlib.import_module(f"ray_tpu_torch.{name}")
    raise AttributeError(f"module 'ray_tpu_torch' has no attribute {name!r}")
