"""MeshGroup: the gang-scheduled process-group primitive (counterpart of
``ray_tpu/parallel/mesh_group.py``).

A placement group reserves one bundle per host (or per GPU share), one
actor is spawned in each bundle, and the actors rendezvous into ONE
``torch.distributed`` process group: rank 0 picks the address, every
rank calls ``init_process_group`` at it with its rank.  Where the JAX
package joins the hosts into one ``jax.distributed`` world whose global
device mesh then spans them (``bootstrap_jax_distributed``), the port's
"mesh" is that process group: one process a rank, the collectives in
each rank's eager step.  After bootstrap, ``run(fn)`` fans the same
function out to every rank behind a single driver-side handle.

The group's backend follows the ranks' cards (``process_group_backend``):
NCCL when each rank has a card of its own; gloo when the ranks share one
card (each holds a fraction of it: NCCL refuses two ranks on one device)
or run on the CPU; any other layout raises.  Nothing tries NCCL and then
falls back.  The group's timeout (``bootstrap_timeout``) bounds the
rendezvous and every collective.

Fault tolerance (unchanged from the reference): eager rank-death
detection through ``gang_get``; ``health_check(deadline)``; all-or-nothing
gang restarts under a ``max_group_restarts`` budget with exponential
backoff (a rank that dies mid-collective leaves its peers blocked in a
group that can never complete, so the restart kills every survivor and
forms a new group in fresh processes); restart hooks
(``add_restart_hook``) and per-call ``on_restart``; the gloo transport
abort's own rebuild budget; the chaos kill schedule
(``RAY_TPU_TORCH_TESTING_KILL_SCHEDULE``, op ``mesh_run`` at
``MeshWorker.run`` entry, generation ``RTTP_MESH_GENERATION``).

Pipelined dispatch (unchanged): ``StepPipeline`` keeps a bounded window
of steps in flight on every rank (``submit``/``flush``, strict step order
through a per-worker sequence gate, sparse metrics fetch, restart and
replay of the held window); ``driver_sync_count()`` counts the lockstep
paths' blocking syncs.  ``submit_ordered`` is the ordered per-rank
dispatch.

Copied from ``ray_tpu/parallel/mesh_group.py`` (the JAX package), with
the ``jax.distributed`` bootstrap replaced by a ``torch.distributed``
one.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import ray_tpu_torch
from ray_tpu_torch import exceptions as exc
from ray_tpu_torch.parallel import flow

# Errors that poison the gang (vs. a user exception raised by fn, which is
# re-raised as-is: the worker is alive and a restart would not help).
# RpcTimeoutError counts: a rank whose control-plane edge blew its
# deadline is indistinguishable from a hung rank — the supervisor must
# treat it as failed (restart path) rather than assume the reply will
# eventually arrive.
_GANG_ERRORS = (exc.ActorDiedError, exc.ActorUnavailableError,
                exc.WorkerCrashedError, exc.ObjectLostError,
                exc.RpcTimeoutError)

# The recurring CPU-gloo TCP race: a rank's connection pair aborts
# mid-collective ("gloo::EnforceNotMet ... op.preamble.length",
# "Connection reset by peer", ...).  The worker processes are alive and
# the program is correct — the *transport* hiccuped — so this failure
# class gets its own bounded in-place recovery (init retry + warm-up +
# same-size rebuild budget) instead of consuming the caller's
# gang-restart/FailureConfig budget.  Matching is textual because gloo
# surfaces the abort as a plain RuntimeError inside the worker.
_TRANSPORT_MARKERS = ("preamble", "connection reset", "connection closed",
                      "connection refused", "enforcenotmet", "timed out",
                      "socket")

# Bounds the rendezvous and every collective of a group.
DEFAULT_TIMEOUT_S = 120.0


def _transport_text(s: str) -> bool:
    s = s.lower()
    if "gloo" not in s and "enforcenotmet" not in s:
        return False
    return any(m in s for m in _TRANSPORT_MARKERS)


def is_transport_abort(err: Any) -> bool:
    """True when ``err`` is (or wraps, rank-for-rank) the gloo TCP
    transport abort rather than a real rank death.  A ``MeshGroupError``
    counts only when EVERY failed rank classifies as transport — one
    genuinely dead rank makes the whole gang failure a death."""
    if getattr(err, "transport_abort", False):
        return True
    if isinstance(err, exc.MeshGroupError):
        ranks = getattr(err, "failed_ranks", None) or {}
        return bool(ranks) and all(is_transport_abort(e)
                                   for e in ranks.values())
    return _transport_text(str(err))


# Driver-side sync counter: every blocking per-step driver<->worker round
# trip on a dispatch path (the lockstep run*/health_check calls) bumps it.
# The pipelined path must leave it untouched.
_DRIVER_SYNCS = {"count": 0}


def driver_sync_count() -> int:
    """Blocking driver<->worker syncs performed by lockstep dispatch paths
    since process start.  A pipelined step stream adds zero."""
    return _DRIVER_SYNCS["count"]


def _note_driver_sync() -> None:
    _DRIVER_SYNCS["count"] += 1


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _coordinator_address(loopback: bool = False) -> str:
    """Pick ``ip:port`` for the process group's rendezvous.

    MUST run *inside the rank-0 worker process*: the port has to be free
    on rank 0's machine, and the address has to be one the other hosts can
    route to."""
    from ray_tpu_torch._private.transfer import routable_ip

    port = _free_port()
    if loopback:
        return f"127.0.0.1:{port}"
    return f"{routable_ip()}:{port}"


def process_group_backend(gpus_per_rank: float,
                          cards: Sequence[Tuple[str, str]]) -> str:
    """The backend of a gang whose ranks each hold ``gpus_per_rank`` GPUs
    and see ``cards[rank] = (host, CUDA_VISIBLE_DEVICES)``.

    - NCCL when each rank has whole cards of its own (no card seen by two
      ranks of one host);
    - gloo when the ranks share a card (a fraction of one each: NCCL
      refuses two ranks on one device) or hold no GPU (the CPU);
    - any other case raises: there is no try-NCCL-then-gloo."""
    g = float(gpus_per_rank or 0.0)
    if g == 0.0 or 0.0 < g < 1.0:
        return "gloo"
    if g != int(g):
        raise RuntimeError(
            f"{g:g} GPUs a rank: a rank holds a fraction of one card "
            "(ranks share it, over gloo) or whole cards (over NCCL)")
    seen: Dict[Tuple[str, str], int] = {}
    for rank, (host, visible) in enumerate(cards):
        devices = [d for d in (visible or "").split(",") if d.strip()]
        if not devices:
            raise RuntimeError(
                f"rank {rank} holds {g:g} GPU(s) but sees no CUDA device "
                f"(CUDA_VISIBLE_DEVICES={visible!r})")
        for d in devices:
            if (host, d) in seen:
                raise RuntimeError(
                    f"ranks {seen[(host, d)]} and {rank} both see card {d} "
                    f"of {host} with whole GPUs: NCCL refuses two ranks on "
                    "one device")
            seen[(host, d)] = rank
    return "nccl"


def bootstrap_torch_distributed(coordinator: str, world_size: int,
                                rank: int, backend: str,
                                timeout: float = DEFAULT_TIMEOUT_S) -> dict:
    """Runs inside each rank's process: join the process group at
    ``coordinator`` (``tcp://``) with ``backend`` (NCCL binds the rank to
    the first card it sees).  A group left from an earlier gang in the
    same process is destroyed first.  The gloo rendezvous sporadically
    aborts while its pairs connect: before any collective ran, the init
    is safely repeatable, so it is retried in place; then one warm-up
    all-reduce makes every pair connect now, where a transport abort is
    cheap to rebuild, and not in the first training step."""
    import datetime
    import os

    import torch
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    if backend == "nccl":
        torch.cuda.set_device(0)
    retries = int(os.environ.get("RAY_TPU_TORCH_GLOO_INIT_RETRIES", "2"))
    for attempt in range(retries + 1):
        try:
            dist.init_process_group(
                backend, init_method=f"tcp://{coordinator}",
                world_size=world_size, rank=rank,
                timeout=datetime.timedelta(seconds=timeout))
            break
        except Exception as e:  # noqa: BLE001 — classified below
            if attempt >= retries or not _transport_text(str(e)):
                raise
            time.sleep(0.2 * (attempt + 1))
    if world_size > 1:
        _collective_warmup(backend)
    return {"rank": rank, "process_index": dist.get_rank(),
            "world_size": dist.get_world_size(), "backend": backend,
            "local_devices": torch.cuda.device_count()
            if backend == "nccl" else 1}


def _collective_warmup(backend: str) -> None:
    """One tiny all-reduce across the group: connection-time races surface
    here, inside the rendezvous."""
    import torch
    import torch.distributed as dist

    n = dist.get_world_size()
    x = torch.tensor([float(dist.get_rank())],
                     device="cuda" if backend == "nccl" else "cpu")
    dist.all_reduce(x)
    expect = float(n * (n - 1) / 2)
    if float(x.item()) != expect:
        raise RuntimeError(
            f"collective warm-up all-reduce returned {float(x.item())}, "
            f"expected {expect}: the {backend} group is mis-wired")


def destroy_process_group() -> bool:
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    return True


def _metrics_to_host(out):
    """Host-convert a step's metrics payload (tensors anywhere in a dict,
    list or tuple become floats or CPU tensors); other payloads pass
    through.  Runs worker-side only on fetch steps, so the in-between
    steps never pay a device-to-host read or a payload pickle."""
    import sys

    torch = sys.modules.get("torch")
    if torch is None:
        return out

    def host(x):
        if isinstance(x, torch.Tensor):
            x = x.detach()
            return float(x.item()) if x.numel() == 1 and x.dim() == 0 \
                else x.cpu()
        if isinstance(x, dict):
            return {k: host(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(host(v) for v in x)
        return x

    return host(out)


@ray_tpu_torch.remote
class MeshWorker:
    """One rank's process of a mesh group.  Carries a state dict so
    stateful users (learners, inference replicas) can pin objects in the
    rank's process."""

    def __init__(self, rank: int, world_size: int, generation: int = 0):
        import os
        import threading

        from ray_tpu_torch._private import chaos

        self.rank = rank
        self.world_size = world_size
        self.generation = generation
        self.state: Dict[str, Any] = {}
        # Pipeline sequence gate: the actor pool runs methods on N threads,
        # so queued pipeline_step calls could otherwise race on the carry
        # state or execute out of order.  Steps wait here for their index.
        self._pipe_cv = threading.Condition()
        self._pipe_next = 0
        self._pipe_err: Optional[str] = None
        os.environ[chaos.GENERATION_ENV] = str(generation)

    def node_info(self) -> dict:
        import os
        import socket

        return {"rank": self.rank, "pid": os.getpid(),
                "host": socket.gethostname(),
                "visible": os.environ.get("CUDA_VISIBLE_DEVICES", "")}

    def ping(self) -> int:
        """Cheap liveness probe; runs on the actor's spare concurrency
        slot, so it answers even mid-run()."""
        return self.rank

    def setup_env(self, env: Dict[str, str]):
        import os

        os.environ.update(env)
        return True

    def bootstrap(self, coordinator: str, backend: str,
                  timeout: float = DEFAULT_TIMEOUT_S) -> dict:
        return bootstrap_torch_distributed(
            coordinator, self.world_size, self.rank, backend, timeout)

    def run(self, fn: Callable, *args, **kwargs):
        from ray_tpu_torch._private import chaos

        chaos.maybe_die("mesh_run", self.rank)
        return fn(*args, **kwargs)

    def run_stateful(self, fn: Callable, *args, **kwargs):
        """fn(state_dict, *args) — for building/using host-pinned state."""
        from ray_tpu_torch._private import chaos

        chaos.maybe_die("mesh_run", self.rank)
        return fn(self.state, *args, **kwargs)

    # ---- pipelined step stream (driven by StepPipeline) ----
    def pipeline_seek(self, next_step: int) -> int:
        """(Re)arm the sequence gate: the next pipeline_step this worker
        executes is ``next_step``.  Called at pipeline creation and after
        a gang restart (fresh processes start at 0, but the replay resumes
        from the oldest undrained step)."""
        with self._pipe_cv:
            self._pipe_next = int(next_step)
            self._pipe_err = None
            self._pipe_cv.notify_all()
        return self.rank

    def pipeline_step(self, step: int, fetch: bool, fn: Callable,
                      *args, **kwargs):
        """Execute one pipelined step in strict submission order.

        ``fn(state, *args)`` — the run_stateful shape: carry lives in the
        state dict as device arrays.  Steps queued ahead of their turn
        park on the sequence gate (they occupy actor-pool threads, which
        is why MeshGroup sizes max_concurrency to pipeline_depth + 2 —
        ping keeps a free slot).  Only ``fetch`` steps return metrics
        (host-converted here, one batched device_get); the rest reply
        None so nothing crosses the wire."""
        from ray_tpu_torch._private import chaos

        deadline = time.monotonic() + 3600.0
        with self._pipe_cv:
            while self._pipe_err is None and step != self._pipe_next:
                if step < self._pipe_next:
                    raise RuntimeError(
                        f"stale pipeline step {step} (worker already at "
                        f"{self._pipe_next}); was the pipeline re-seeked?")
                if not self._pipe_cv.wait(timeout=5.0) and \
                        time.monotonic() > deadline:
                    raise RuntimeError(
                        f"pipeline step {step} stalled waiting for step "
                        f"{self._pipe_next} to complete")
            if self._pipe_err is not None:
                raise RuntimeError(
                    f"pipeline aborted by earlier failure: {self._pipe_err}")
        chaos.maybe_die("pipeline_step", self.rank)
        try:
            out = fn(self.state, *args, **kwargs)
        except BaseException as e:
            # Poison the gate: later queued steps fail fast instead of
            # running against a carry the failed step left half-updated.
            with self._pipe_cv:
                self._pipe_err = f"step {step}: {type(e).__name__}: {e}"
                self._pipe_cv.notify_all()
            raise
        with self._pipe_cv:
            self._pipe_next = step + 1
            self._pipe_cv.notify_all()
        return _metrics_to_host(out) if fetch else None


def gang_get(futures: Sequence, timeout: Optional[float] = None,
             poll_interval: float = 0.25) -> List[Any]:
    """Resolve a gang's per-rank futures with eager failure detection.

    A plain ``ray_tpu_torch.get(list)`` resolves rank 0 first: if rank 0 is a
    survivor stuck in a collective poisoned by a dead peer, the driver
    blocks forever.  This polls ALL futures via ``wait``; as soon as any
    rank resolves to a gang-poisoning error (actor/worker death), a
    ``MeshGroupError(failed_ranks=...)`` is raised immediately and the
    remaining futures are abandoned.  A user exception (``TaskError``) is
    re-raised as-is — the gang is healthy, restart would not help.
    ``timeout`` bounds the whole fan-out; unresolved ranks at the deadline
    are reported in ``failed_ranks`` as ``GetTimeoutError``."""
    remaining: List[tuple] = list(enumerate(futures))  # (rank, ref)
    results: Dict[int, Any] = {}
    failed: Dict[int, BaseException] = {}
    deadline = None if timeout is None else time.monotonic() + timeout
    while remaining:
        refs = [r for _, r in remaining]
        ready, _ = ray_tpu_torch.wait(refs, num_returns=len(refs),
                                timeout=poll_interval)
        ready_ids = {id(r) for r in ready}
        still: List[tuple] = []
        for rank, ref in remaining:
            if id(ref) not in ready_ids:
                still.append((rank, ref))
                continue
            try:
                results[rank] = ray_tpu_torch.get(ref)
            except _GANG_ERRORS as e:
                failed[rank] = e
            except exc.RayTpuError as e:
                # A gloo transport abort surfaces as a TaskError whose
                # message names the race; it poisons the gang exactly like
                # a rank death (peers are stuck in the collective), so it
                # joins failed_ranks — tagged so supervisors can charge
                # the transport budget instead of the restart budget.
                if not _transport_text(str(e)):
                    raise  # user exception: gang is not poisoned
                failed[rank] = e
        remaining = still
        if failed:
            _abandon(remaining)
            err = exc.MeshGroupError("mesh rank(s) died mid-run",
                                     failed_ranks=failed)
            err.transport_abort = all(is_transport_abort(e)
                                      for e in failed.values())
            raise err
        if deadline is not None and remaining and time.monotonic() > deadline:
            late = {rank: exc.GetTimeoutError(
                f"rank {rank} produced no result within {timeout}s")
                for rank, _ in remaining}
            _abandon(remaining)
            raise exc.MeshGroupError("mesh rank(s) missed the deadline",
                                     failed_ranks=late)
    return [results[rank] for rank in range(len(futures))]


def _abandon(remaining) -> None:
    """Best-effort cancel of the poisoned peers' futures: queued-but-not-
    started calls are dropped; in-flight collective work is unrecoverable
    anyway and dies with the gang teardown."""
    for _, ref in remaining:
        try:
            ray_tpu_torch.cancel(ref)
        except Exception:
            pass


def rendezvous(workers: Sequence, gpus_per_rank: float = 0.0,
               timeout: float = DEFAULT_TIMEOUT_S) -> List[dict]:
    """Form one ``torch.distributed`` process group across an existing
    gang of actors, its backend from ``process_group_backend``.

    Workers must expose node_info/setup_env and either bootstrap() (native
    MeshWorker) or execute() (Train's TrainWorker).  Returns per-rank
    group info."""
    world = len(workers)
    infos = gang_get([w.node_info.remote() for w in workers],
                     timeout=timeout)
    hosts = {i["host"] for i in infos}
    backend = process_group_backend(
        gpus_per_rank, [(i["host"], i.get("visible", "")) for i in infos])
    # Allocate the address ON rank 0 (not the driver): the port must be
    # free on rank 0's machine and the ip routable from the other hosts.
    w0 = workers[0]
    caller = w0.run if hasattr(w0, "run") else w0.execute
    coordinator = ray_tpu_torch.get(
        caller.remote(_coordinator_address, len(hosts) == 1),
        timeout=timeout)
    env = {"RTTP_COORDINATOR": coordinator, "RTTP_WORLD_SIZE": str(world)}
    gang_get([w.setup_env.remote({**env, "RTTP_RANK": str(rank)})
              for rank, w in enumerate(workers)], timeout=timeout)
    calls = []
    for rank, w in enumerate(workers):
        if hasattr(w, "bootstrap"):
            calls.append(w.bootstrap.remote(coordinator, backend, timeout))
        else:
            calls.append(w.execute.remote(
                bootstrap_torch_distributed, coordinator, world, rank,
                backend, timeout))
    # The rendezvous itself is a collective: a rank dying inside
    # init_process_group would otherwise hang the peers (and the driver).
    return gang_get(calls, timeout=timeout)


def _restart_metrics():
    """Lazy metric handles (internal_kv needs a connected driver)."""
    from ray_tpu_torch.util.metrics import Counter

    return (Counter("mesh_group_restarts_total",
                    "successful MeshGroup gang restarts"),
            Counter("mesh_group_restart_failures_total",
                    "failed MeshGroup gang-restart attempts"))


# The bounded in-flight window primitive was extracted to the shared
# dataflow substrate (parallel/flow.py) along with the rest of the
# backpressure/drain machinery; re-exported here because the step
# pipeline's public docs and downstream code name it InflightWindow.
InflightWindow = flow.Window


class _InflightStep:
    """One dispatched-but-undrained step: the per-rank futures plus the
    spec needed to resubmit it after a gang restart (the window is bounded
    by depth, so holding specs is bounded memory)."""
    __slots__ = ("idx", "refs", "fetch", "fn", "args", "kwargs",
                 "dispatched_at", "trace_ctx")

    def __init__(self, idx, refs, fetch, fn, args, kwargs, dispatched_at):
        self.idx = idx
        self.refs = refs
        self.fetch = fetch
        self.fn = fn
        self.args = args
        self.kwargs = kwargs
        self.dispatched_at = dispatched_at
        # One trace per step: minted at first dispatch, reused for the
        # drain span and any replay re-dispatch so one step's dispatch,
        # worker execution, and drain assemble into one timeline.
        self.trace_ctx = None


def _pipeline_metrics():
    """Lazy metric handles (internal_kv needs a connected driver)."""
    from ray_tpu_torch.util.metrics import Counter, Gauge, Histogram

    return {
        "depth": Gauge("mesh_pipeline_depth",
                       "configured in-flight window of the step pipeline"),
        "inflight": Gauge("mesh_pipeline_inflight",
                          "steps currently in flight in the step pipeline"),
        "steps": Counter("mesh_pipeline_steps_total",
                         "pipeline steps drained"),
        "restarts": Counter("mesh_pipeline_replays_total",
                            "gang restarts absorbed by pipeline replay"),
        "dispatch": Histogram(
            "mesh_pipeline_dispatch_latency_s",
            "driver time to dispatch one step to every rank",
            boundaries=(0.0005, 0.002, 0.01, 0.05, 0.25, 1.0)),
        "drain": Histogram(
            "mesh_pipeline_drain_wait_s",
            "driver wait for the oldest in-flight step at backpressure",
            boundaries=(0.0005, 0.002, 0.01, 0.05, 0.25, 1.0, 5.0)),
    }


class StepPipeline:
    """Bounded-window asynchronous step stream over a MeshGroup.

    ``submit(fn, *args)`` dispatches ``fn(state, *args)`` to every rank
    and returns as soon as at most ``depth`` steps remain in flight — the
    workers always hold the next step(s) queued before the driver waits
    on any result, so driver RPC latency never serializes with device
    compute (zero per-step driver syncs; see driver_sync_count()).

    Results drain strictly in step order via the gang_get supervisor:
    rank death mid-window raises :class:`MeshGroupError` eagerly, and —
    when the group has restart budget — the gang is rebuilt,
    ``on_restart(group)`` re-materializes carry state, and the held
    in-flight window replays from the oldest undrained step.

    ``metrics_interval=N``: only every Nth step returns metrics (host-
    converted worker-side); others reply None.  ``on_result(idx, res)``
    fires for every drained step (res is None for non-fetch steps) — use
    it to checkpoint at drain cadence for exactly-once replay.

    Not thread-safe: one driver thread owns a pipeline.
    """

    def __init__(self, group: "MeshGroup", depth: int = 2,
                 metrics_interval: int = 1,
                 on_restart: Optional[Callable] = None,
                 on_result: Optional[Callable] = None,
                 drain_timeout: Optional[float] = None,
                 export_metrics: bool = True):
        if depth < 1:
            raise ValueError(f"pipeline depth must be >= 1, got {depth}")
        self.group = group
        self.depth = depth
        self.metrics_interval = max(1, int(metrics_interval))
        self.on_restart = on_restart
        self.on_result = on_result
        self.drain_timeout = drain_timeout
        self._inflight: InflightWindow = InflightWindow(depth)
        self._results: List[Any] = []
        self._next_idx = 0
        self._drained = 0
        self.replay_count = 0
        self._closed = False
        self._broken = False
        # fn -> store ref cache: serialize each distinct step fn once, not
        # once per step (workers resolve the ref from their local cache).
        self._fn_refs: Dict[int, tuple] = {}
        self._metrics = None
        if export_metrics:
            try:
                self._metrics = _pipeline_metrics()
                self._metrics["depth"].set(float(depth))
            except Exception:
                self._metrics = None
        self._seek(0)

    # ---- internals ----
    def _seek(self, idx: int) -> None:
        """Arm every rank's sequence gate (setup/restart path — the only
        blocking fan-outs a pipeline ever does outside its drains)."""
        gang_get([w.pipeline_seek.remote(idx) for w in self.group.workers],
                 timeout=self.group.bootstrap_timeout)

    def _fn_ref(self, fn: Callable):
        cached = self._fn_refs.get(id(fn))
        if cached is not None and cached[0] is fn:
            return cached[1]
        ref = ray_tpu_torch.put(fn)
        self._fn_refs[id(fn)] = (fn, ref)
        return ref

    def _dispatch(self, step: _InflightStep) -> None:
        t0 = time.perf_counter()
        from ray_tpu_torch import observability as obs
        from ray_tpu_torch._private import profiling

        minted = False
        if step.trace_ctx is None and obs.enabled():
            # Join the caller's trace when one is live (e.g. a learner
            # update_async boundary); mint a fresh per-step root else.
            step.trace_ctx = obs.get_context()
            if step.trace_ctx is None:
                step.trace_ctx = obs.mint_context()
                minted = True
        # Dispatch inside the step's trace so every rank's
        # pipeline_step submission (and its worker-side execution)
        # carries this step's trace id.
        saved = obs.set_context(step.trace_ctx) if step.trace_ctx else None
        try:
            fn_ref = self._fn_ref(step.fn)
            step.refs = [
                w.pipeline_step.remote(step.idx, step.fetch, fn_ref,
                                       *step.args, **step.kwargs)
                for w in self.group.workers
            ]
        finally:
            if step.trace_ctx:
                obs.set_context(saved)
        step.dispatched_at = time.perf_counter()
        # A freshly minted step records its dispatch AS the trace root so
        # the rank-side execute spans (parented to the root id) anchor a
        # real span — cross-process flow arrows need both ends.
        profiling.record_span("pipeline_dispatch", t0, step.dispatched_at,
                              step=step.idx, _trace_ctx=step.trace_ctx,
                              _root=minted)
        if self._metrics is not None and \
                step.idx % self.metrics_interval == 0:
            try:
                self._metrics["dispatch"].observe(step.dispatched_at - t0)
            except Exception:
                pass

    def _recover(self, cause: exc.MeshGroupError) -> None:
        """Gang restart + window replay.  Raises (budget exhausted /
        respawn failure) with the pipeline marked broken."""
        from ray_tpu_torch import observability as obs

        obs.flight_record(f"gang_restart: {cause}")
        try:
            self.group._restart(cause)  # raises when out of budget
        except BaseException:
            self._broken = True
            raise
        if self.on_restart is not None:
            self.on_restart(self.group)
        base = self._inflight.peek().idx if self._inflight else self._next_idx
        self._seek(base)
        for step in self._inflight:
            self._dispatch(step)
        self.replay_count += 1
        if self._metrics is not None:
            try:
                self._metrics["restarts"].inc()
            except Exception:
                pass

    def _drain_one(self) -> None:
        step = self._inflight.peek()
        t0 = time.perf_counter()
        while True:
            try:
                res = gang_get(step.refs, timeout=self.drain_timeout)
                break
            except exc.MeshGroupError as e:
                self._recover(e)
                step = self._inflight.peek()
            except BaseException:
                self._broken = True
                raise
        t1 = time.perf_counter()
        from ray_tpu_torch._private import profiling

        profiling.record_span("pipeline_drain", t0, t1, step=step.idx,
                              _trace_ctx=step.trace_ctx)
        self._inflight.popleft()
        self._drained += 1
        if step.fetch:
            self._results.append((step.idx, res))
        if self.on_result is not None:
            self.on_result(step.idx, res if step.fetch else None)
        if self._metrics is not None and \
                self._drained % self.metrics_interval == 0:
            try:
                self._metrics["steps"].inc(self.metrics_interval)
                self._metrics["inflight"].set(float(len(self._inflight)))
                self._metrics["drain"].observe(t1 - t0)
            except Exception:
                pass

    # ---- public API ----
    @property
    def inflight(self) -> int:
        return len(self._inflight)

    @property
    def steps_submitted(self) -> int:
        return self._next_idx

    @property
    def steps_drained(self) -> int:
        return self._drained

    def submit(self, fn: Callable, *args,
               fetch: Optional[bool] = None, **kwargs) -> int:
        """Dispatch one step to every rank; blocks (draining the oldest
        step) only once more than ``depth`` are in flight — so step N+1
        is always dispatched before step N-depth's result is awaited.
        Returns the step index."""
        if self._closed or self._broken:
            raise RuntimeError("pipeline is closed")
        idx = self._next_idx
        self._next_idx += 1
        if fetch is None:
            fetch = idx % self.metrics_interval == 0
        step = _InflightStep(idx, None, bool(fetch), fn, args, kwargs, 0.0)
        self._dispatch(step)
        self._inflight.append(step)
        while self._inflight.over_depth:
            self._drain_one()
        return idx

    def take_results(self) -> List[Any]:
        """Pop drained (idx, per-rank results) pairs accumulated so far —
        fetch steps only, in step order.  Non-blocking."""
        out, self._results = self._results, []
        return out

    def flush(self) -> List[Any]:
        """Drain every in-flight step, then return ALL fetched results
        accumulated since creation (non-destructive)."""
        while self._inflight:
            self._drain_one()
        return list(self._results)

    def close(self, flush: bool = True) -> None:
        if self._closed:
            return
        self._closed = True
        if flush and not self._broken:
            while self._inflight:
                self._drain_one()
        else:
            _abandon([(s.idx, r) for s in self._inflight
                      for r in (s.refs or [])])
            self._inflight.clear()

    def __enter__(self) -> "StepPipeline":
        return self

    def __exit__(self, exc_type, exc_val, tb) -> None:
        # On an exception unwind, don't block on (possibly poisoned) work.
        self.close(flush=exc_type is None)


class MeshGroup:
    """A gang of one actor per rank forming one ``torch.distributed``
    process group.

    ``MeshGroup(2)`` on one machine is two CPU ranks over gloo;
    ``MeshGroup(2, resources_per_host={"GPU": 0.5})`` two ranks sharing
    one card (gloo); ``MeshGroup(n, resources_per_host={"GPU": 1})`` a
    card a rank (NCCL).

    With ``max_group_restarts > 0`` the group self-heals: a rank death
    detected during ``run()`` tears the whole gang down (SPMD worlds die as
    a unit), re-spawns fresh worker processes, re-runs the rendezvous and
    retries the function — see the module docstring's *Fault tolerance*
    section.  ``restart_count`` and the ``mesh_group_restarts_total``
    metric record consumed budget.
    """

    def __init__(self, num_hosts: int,
                 resources_per_host: Optional[Dict[str, float]] = None,
                 strategy: str = "PACK",
                 bootstrap_timeout: float = 120.0,
                 max_group_restarts: int = 0,
                 restart_backoff_s: float = 0.5,
                 restart_backoff_max_s: float = 30.0,
                 pipeline_depth: int = 2,
                 transport_restart_budget: int = 2):
        self.num_hosts = num_hosts
        self.strategy = strategy
        self.bootstrap_timeout = bootstrap_timeout
        self.max_group_restarts = max_group_restarts
        self.restart_backoff_s = restart_backoff_s
        self.restart_backoff_max_s = restart_backoff_max_s
        self.restart_count = 0
        # Transport aborts (the gloo TCP race — see is_transport_abort)
        # rebuild under their own budget: they are environmental hiccups,
        # not workload failures, and must not consume the caller's
        # max_group_restarts headroom.
        self.transport_restart_budget = transport_restart_budget
        self.transport_restart_count = 0
        # Monotonic incarnation counter: every respawn (restart OR
        # resize) gets a fresh generation; equals restart_count when no
        # transport restarts/resizes occur, so generation-pinned chaos
        # schedules keep their meaning.
        self._generation = 0
        # Default StepPipeline window; also sizes the actor pool so up to
        # depth+1 queued pipeline steps can park on the sequence gate with
        # ping still answered on a free slot.
        self.pipeline_depth = max(1, int(pipeline_depth))
        self._resources = dict(resources_per_host or {"CPU": 1.0})
        self.pg = None
        self.workers: List[Any] = []
        # Group-level restart hooks: run inside _restart after every
        # successful respawn, BEFORE the caller's per-call on_restart —
        # for cross-cutting state that must react to any rebuild (e.g.
        # the checkpoint coordinator cancelling in-flight async commits
        # whose writers died with the old gang).
        self._restart_hooks: List[Callable] = []
        self._spawn(generation=0)

    # ---- gang lifecycle ----
    def _actor_opts(self) -> Dict[str, Any]:
        res = self._resources
        opts: Dict[str, Any] = {"max_concurrency": self.pipeline_depth + 2}
        if res.get("CPU"):
            opts["num_cpus"] = res["CPU"]
        if res.get("GPU"):
            opts["num_gpus"] = res["GPU"]
        extra = {k: v for k, v in res.items() if k not in ("CPU", "GPU")}
        if extra:
            opts["resources"] = extra
        return opts

    def _spawn(self, generation: int):
        """Reserve the placement group, spawn one fresh worker per host and
        form the process group."""
        opts = self._actor_opts()
        if self.num_hosts > 1:
            from ray_tpu_torch.util import PlacementGroupSchedulingStrategy
            from ray_tpu_torch.util.placement_group import placement_group

            self.pg = placement_group(
                [dict(self._resources) for _ in range(self.num_hosts)],
                strategy=self.strategy)
            self.pg.ready(timeout=self.bootstrap_timeout)
            opts["scheduling_strategy"] = PlacementGroupSchedulingStrategy(
                self.pg)
        # The rendezvous now includes a collective warm-up, so the gloo
        # connect race can surface right here — where a bounded in-place
        # retry (fresh actors, same placement group) is cheap and
        # invisible to the caller.
        attempts = 3
        for attempt in range(attempts):
            self.workers = [
                MeshWorker.options(**opts).remote(rank, self.num_hosts,
                                                  generation)
                for rank in range(self.num_hosts)
            ]
            try:
                self.device_info = rendezvous(
                    self.workers, self._resources.get("GPU", 0.0),
                    timeout=self.bootstrap_timeout)
                return
            except exc.MeshGroupError as e:
                if attempt >= attempts - 1 or not is_transport_abort(e):
                    raise
                for w in self.workers:
                    try:
                        ray_tpu_torch.kill(w)
                    except Exception:
                        pass
                self.workers = []
                time.sleep(0.2 * (attempt + 1))

    def _teardown_workers(self):
        for w in self.workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:
                pass
        self.workers = []
        if self.pg is not None:
            from ray_tpu_torch.util.placement_group import (
                remove_placement_group)

            try:
                remove_placement_group(self.pg)
            except Exception:
                pass
            self.pg = None

    def _restart(self, cause: exc.MeshGroupError) -> None:
        """One gang restart attempt: teardown + backoff + respawn.

        Raises ``MeshGroupError`` (the original cause, annotated with the
        consumed restart count) when the budget is exhausted; re-raises a
        respawn failure wrapped the same way."""
        restarts_total, restart_failures = None, None
        try:
            restarts_total, restart_failures = _restart_metrics()
        except Exception:
            pass  # metrics are best-effort (e.g. driver disconnecting)
        transport = is_transport_abort(cause)
        if transport:
            if self.transport_restart_count >= self.transport_restart_budget:
                cause.restarts = self.restart_count
                raise cause
            self.transport_restart_count += 1
        else:
            if self.restart_count >= self.max_group_restarts:
                cause.restarts = self.restart_count
                raise cause
            self.restart_count += 1
        attempt = self.restart_count + self.transport_restart_count
        backoff = min(
            self.restart_backoff_s * (2 ** (attempt - 1)),
            self.restart_backoff_max_s)
        self._teardown_workers()
        time.sleep(backoff)
        self._generation += 1
        try:
            self._spawn(generation=self._generation)
        except Exception as e:
            if restart_failures is not None:
                try:
                    restart_failures.inc()
                except Exception:
                    pass
            raise exc.MeshGroupError(
                f"gang restart {self.restart_count}/"
                f"{self.max_group_restarts} failed to respawn: {e}",
                failed_ranks=cause.failed_ranks,
                restarts=self.restart_count) from e
        if restarts_total is not None:
            try:
                restarts_total.inc()
            except Exception:
                pass
        for hook in self._restart_hooks:
            try:
                hook(self)
            except Exception:
                # Group-level hooks are advisory (cancellation, metrics);
                # state re-materialization belongs to per-call on_restart,
                # whose failures DO propagate.
                pass

    def add_restart_hook(self, hook: Callable[["MeshGroup"], None]) -> None:
        """Register ``hook(group)`` to run after every successful gang
        rebuild, before the per-call ``on_restart``.  Exceptions are
        swallowed — use for cross-cutting reactions (cancelling pending
        checkpoint commits, cache invalidation), not state rebuilds."""
        self._restart_hooks.append(hook)

    def resize(self, num_hosts: int) -> None:
        """Tear the gang down and rebuild it at ``num_hosts`` hosts.

        A process group is fixed-size, so elasticity means a
        full rebuild: fresh worker processes, fresh placement group,
        fresh rendezvous, next generation.  The caller owns state — this
        carries nothing over (ElasticMeshGroup re-broadcasts its boundary
        snapshot afterwards)."""
        if num_hosts < 1:
            raise ValueError(f"num_hosts must be >= 1, got {num_hosts}")
        self._teardown_workers()
        self.num_hosts = int(num_hosts)
        self._generation += 1
        self._spawn(generation=self._generation)

    # ---- health ----
    def health_check(self, deadline: float = 10.0) -> List[int]:
        """Ping every rank with a deadline.  Returns the rank list on
        success; raises ``MeshGroupError`` naming dead/unresponsive ranks.
        Safe to call while a ``run()`` is in flight (pings ride the spare
        concurrency slot)."""
        _note_driver_sync()
        futures = [w.ping.remote() for w in self.workers]
        return gang_get(futures, timeout=deadline)

    @property
    def world_size(self) -> int:
        return self.device_info[0]["world_size"]

    # ---- execution ----
    def run(self, fn: Callable, *args, on_restart: Optional[Callable] = None,
            timeout: Optional[float] = None, **kwargs) -> List[Any]:
        """Fan fn out to every host process; returns per-rank results.

        Supervised: a rank death raises ``MeshGroupError`` eagerly; with
        ``max_group_restarts > 0`` the gang is rebuilt (fresh processes +
        rendezvous), ``on_restart(group)`` — if given — re-materializes
        host-pinned state, and fn is retried.  ``timeout`` is a per-attempt
        deadline for the whole fan-out."""
        _note_driver_sync()
        return self._supervised(
            lambda: gang_get([w.run.remote(fn, *args, **kwargs)
                              for w in self.workers], timeout=timeout),
            on_restart)

    def run_async(self, fn: Callable, *args, **kwargs):
        return [w.run.remote(fn, *args, **kwargs) for w in self.workers]

    def run_stateful(self, fn: Callable, *args,
                     on_restart: Optional[Callable] = None,
                     timeout: Optional[float] = None, **kwargs) -> List[Any]:
        _note_driver_sync()
        return self._supervised(
            lambda: gang_get([w.run_stateful.remote(fn, *args, **kwargs)
                              for w in self.workers], timeout=timeout),
            on_restart)

    # ---- pipelined execution (the zero-sync hot path) ----
    def pipeline(self, depth: Optional[int] = None,
                 metrics_interval: int = 1,
                 on_restart: Optional[Callable] = None,
                 on_result: Optional[Callable] = None,
                 drain_timeout: Optional[float] = None,
                 export_metrics: bool = True) -> StepPipeline:
        """Open a :class:`StepPipeline` over this gang (see its docs).
        ``depth`` defaults to the group's ``pipeline_depth``."""
        return StepPipeline(self, depth=depth or self.pipeline_depth,
                            metrics_interval=metrics_interval,
                            on_restart=on_restart, on_result=on_result,
                            drain_timeout=drain_timeout,
                            export_metrics=export_metrics)

    def run_pipelined(self, fn: Callable, num_steps: int, *args,
                      depth: Optional[int] = None,
                      metrics_interval: int = 1,
                      args_fn: Optional[Callable] = None,
                      on_restart: Optional[Callable] = None,
                      on_result: Optional[Callable] = None,
                      timeout: Optional[float] = None,
                      **kwargs) -> List[Any]:
        """Drive ``num_steps`` pipelined ``fn(state, *args)`` steps and
        return the fetched ``(step_idx, per-rank results)`` pairs (every
        ``metrics_interval``-th step).  ``args_fn(i)`` — when given —
        produces per-step positional args (e.g. a batch ref); otherwise
        every step receives ``*args``.  Supervision matches ``run()``:
        rank death restarts the gang under the restart budget and replays
        the in-flight window after ``on_restart``."""
        with self.pipeline(depth=depth, metrics_interval=metrics_interval,
                           on_restart=on_restart, on_result=on_result,
                           drain_timeout=timeout) as pipe:
            for i in range(num_steps):
                step_args = args_fn(i) if args_fn is not None else args
                pipe.submit(fn, *step_args, **kwargs)
            return pipe.flush()

    # ---- ordered per-rank dispatch (the MPMD stage-gang primitive) ----
    def seek_ranks(self, idx: int) -> None:
        """(Re)arm every rank's pipeline sequence gate at ``idx`` — the
        setup/restart fan-out for callers that drive the gang through
        :meth:`submit_ordered` instead of a :class:`StepPipeline`."""
        gang_get([w.pipeline_seek.remote(idx) for w in self.workers],
                 timeout=self.bootstrap_timeout)

    def submit_ordered(self, seq: int, calls: Sequence[tuple],
                       kwargs: Optional[dict] = None) -> List[Any]:
        """Dispatch one gated op per rank at sequence position ``seq``
        and return the per-rank refs WITHOUT draining.

        ``calls[r] = (fn, *args)`` runs ``fn(state, *args)`` on rank r
        through the MeshWorker pipeline gate: every rank executes its
        ops in the same global order, which is what keeps compiled
        cross-process collectives matched across ranks even though each
        op is an independent actor task.  The MPMD pipeline plane drives
        its multi-host stage gangs through this (one ``seq`` per
        schedule op); unlike ``run*`` it performs no blocking driver
        sync — callers drain the refs themselves (``gang_get``)."""
        if len(calls) != len(self.workers):
            raise ValueError(
                f"submit_ordered needs one call per rank "
                f"({len(self.workers)}), got {len(calls)}")
        kw = kwargs or {}
        return [
            w.pipeline_step.remote(seq, True, *calls[r], **kw)
            for r, w in enumerate(self.workers)
        ]

    def _supervised(self, attempt: Callable[[], List[Any]],
                    on_restart: Optional[Callable]) -> List[Any]:
        while True:
            try:
                return attempt()
            except exc.MeshGroupError as e:
                self._restart(e)  # raises when the budget is exhausted
                if on_restart is not None:
                    on_restart(self)

    def run_rank(self, rank: int, fn: Callable, *args, **kwargs):
        _note_driver_sync()
        return ray_tpu_torch.get(
            self.workers[rank].run.remote(fn, *args, **kwargs))

    def run_rank_stateful(self, rank: int, fn: Callable, *args, **kwargs):
        _note_driver_sync()
        return ray_tpu_torch.get(
            self.workers[rank].run_stateful.remote(fn, *args, **kwargs))

    def shutdown(self):
        self._teardown_workers()
