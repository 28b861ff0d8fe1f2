"""Gang fan-out with eager rank-death detection (counterpart of
``ray_tpu/parallel/mesh_group.py``).

Only what the Train stack's ``BackendExecutor`` needs is copied:
``gang_get`` (``:442``), ``_abandon``, ``is_transport_abort`` (``:145``)
and their constants.  A gang's ranks share one process group, so one
dead rank can leave its peers blocked in a collective: ``gang_get`` polls
every rank's future with ``wait`` and raises ``MeshGroupError`` naming the
failed ranks as soon as one resolves to a death, instead of blocking on a
survivor.  The rest of ``MeshGroup`` (rendezvous of a jax world, the step
pipeline, gang restarts) belongs to ROADMAP Queue 1 item 6.

Copied from ``ray_tpu/parallel/mesh_group.py`` (the JAX package).
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence

import ray_tpu_torch
from ray_tpu_torch import exceptions as exc

# Errors that poison the gang (vs. a user exception raised by fn, which is
# re-raised as-is: the worker is alive and a restart would not help).
# RpcTimeoutError counts: a rank whose control-plane edge blew its
# deadline is indistinguishable from a hung rank — the supervisor must
# treat it as failed (restart path) rather than assume the reply will
# eventually arrive (replies either arrive or the process died is no
# longer the plane's contract; deadlines are).
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

