"""Driver-side save coordination: gang fan-out, background commit, GC.

The coordinator never touches array bytes — ranks write their own shards
(phase 1); the coordinator's only writes are the atomic manifest rename
(phase 2) and garbage collection.  ``commit_when_complete`` polls for the
rank files instead of holding a rendezvous, so persist can be fully
asynchronous worker-side (a pipeline step snapshots and returns; a
background thread writes) and a crashed rank simply times the commit out —
leaving the store at the previous committed checkpoint.

Copied from ``ray_tpu/checkpoint/coordinator.py`` (the JAX package); a
rank reads its rank and world from ``RTTP_RANK``/``RTTP_WORLD_SIZE``,
which the gang's rendezvous sets.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ray_tpu_torch.checkpoint import manifest as mf


def _flow_token():
    # Lazy: checkpoint/ stays importable without the parallel package.
    from ray_tpu_torch.parallel.flow import CancellationToken

    return CancellationToken()


def commit_when_complete(root: str, step: int, world_size: int,
                         meta: Optional[dict] = None,
                         timeout: float = 120.0,
                         poll_interval: float = 0.05,
                         in_progress: Optional[List[int]] = None) -> dict:
    """Wait for every rank's shard file, then commit + sweep orphans.
    Raises TimeoutError (store untouched, previous checkpoint stands) if
    the shards don't all land within ``timeout``.  ``in_progress`` lists
    steps with saves still in flight (e.g. pending async commits) so the
    orphan sweep never deletes a step that is about to commit."""
    from ray_tpu_torch._private import profiling

    t0 = time.perf_counter()
    deadline = time.monotonic() + timeout
    while True:
        missing = mf.missing_rank_files(root, step, world_size)
        if not missing:
            break
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"checkpoint step {step}: ranks {missing} never persisted "
                f"their shards within {timeout}s; not committing")
        time.sleep(poll_interval)
    manifest = mf.commit_manifest(root, step, world_size, meta=meta)
    mf.gc_orphans(root, in_progress=in_progress or (), below=step)
    profiling.record_span("checkpoint_commit", t0, time.perf_counter(),
                          step=int(step))
    return manifest


class AsyncCommitter:
    """Background commit threads for async sharded saves.  One commit per
    step; ``flush()`` joins them and re-raises the first failure.

    Each commit thread carries a :class:`ray_tpu_torch.parallel.flow.
    CancellationToken`; ``cancel_pending()`` — wired into MeshGroup
    restart hooks, so gang restart is ONE call — cancels every pending
    step's token (the flow drain contract).  A cancelled commit wakes
    from its poll immediately instead of sleeping it out, and a
    cancelled-then-resaved step simply registers a FRESH token, so stale
    cancellations can never suppress a replayed save."""

    def __init__(self):
        # (thread, token) per step; a re-registered step replaces both.
        self._pending: Dict[int, Tuple[threading.Thread,
                                       CancellationToken]] = {}
        self._errors: List[BaseException] = []
        self._lock = threading.Lock()

    def commit_async(self, root: str, step: int, world_size: int,
                     meta: Optional[dict] = None,
                     timeout: float = 120.0,
                     on_commit: Optional[Callable[[dict], None]] = None
                     ) -> None:
        token = _flow_token()

        def run():
            try:
                poll = 0.05
                deadline = time.monotonic() + timeout
                while True:
                    if not mf.missing_rank_files(root, step, world_size):
                        break
                    if time.monotonic() > deadline:
                        raise TimeoutError(
                            f"checkpoint step {step} commit timed out")
                    # token.wait doubles as the poll sleep: a cancel (gang
                    # restart killed the writers) wakes and exits NOW.
                    if token.wait(poll):
                        return
                if token.cancelled:
                    return
                manifest = mf.commit_manifest(root, step, world_size,
                                              meta=meta)
                # Sibling commits still pending (e.g. step N while we are
                # N+1) have fully persisted, manifest-less dirs — exempt
                # them from the sweep or we'd destroy a valid save in the
                # window between its poll and its manifest rename.
                with self._lock:
                    pending = [s for s in self._pending if s != int(step)]
                mf.gc_orphans(root, in_progress=pending, below=step)
                if on_commit is not None:
                    on_commit(manifest)
            except BaseException as e:  # noqa: BLE001 — surfaced by flush
                with self._lock:
                    self._errors.append(e)
            finally:
                with self._lock:
                    # A cancelled-then-resaved step re-registers under the
                    # same key: only deregister if we still own it.
                    entry = self._pending.get(int(step))
                    if entry is not None and entry[0] is t:
                        self._pending.pop(int(step), None)

        t = threading.Thread(target=run, daemon=True,
                             name=f"ckpt-commit-{step}")
        with self._lock:
            # A fresh save supersedes any stale cancellation of this step
            # (a restart can roll training back and replay through a step
            # whose earlier save was cancelled): the fresh thread owns a
            # fresh token the stale cancel never touched.
            self._pending[int(step)] = (t, token)
        t.start()

    def cancel_pending(self) -> None:
        """Abandon uncommitted saves (e.g. after a gang restart killed the
        writers): their step dirs become orphans for the next GC."""
        with self._lock:
            tokens = [tok for _, tok in self._pending.values()]
        for tok in tokens:
            tok.cancel()

    def pending_steps(self) -> List[int]:
        """Steps whose commit threads are still registered."""
        with self._lock:
            return list(self._pending.keys())

    def flush(self, timeout: Optional[float] = None) -> None:
        with self._lock:
            threads = [t for t, _ in self._pending.values()]
        for t in threads:
            t.join(timeout)
        with self._lock:
            errors, self._errors = self._errors, []
        if errors:
            raise errors[0]


def _rank_persist_shard(state, root, step, tree_fn, sync, extra):
    """Worker-side (run_stateful shape): snapshot this rank's tree and
    persist it — synchronously, or on the rank's background thread."""
    import os

    from ray_tpu_torch.checkpoint.saver import ShardWriter

    rank = int(os.environ.get("RTTP_RANK", "0"))
    world = int(os.environ.get("RTTP_WORLD_SIZE", "1"))
    writer = state.get("_ckpt_writer")
    if writer is None or writer.root != root:
        writer = ShardWriter(root, rank, world)
        state["_ckpt_writer"] = writer
    snap = writer.snapshot(tree_fn(state))
    if sync:
        writer.persist(snap, step, extra=extra)
    else:
        writer.persist_async(snap, step, extra=extra)
    return {"rank": rank, "step": int(step)}


def _rank_wait_persisted(state, timeout):
    writer = state.get("_ckpt_writer")
    if writer is not None:
        writer.wait(timeout)
    return True


class DistributedCheckpointer:
    """Sharded checkpointing over a MeshGroup gang.

    ``tree_fn(state) -> pytree`` (picklable) extracts the rank's local
    tree from its worker state dict.  ``save()`` is the lockstep form;
    ``save_async()`` overlaps persist with the step stream: ranks snapshot
    (the bounded pause) and return, chunk writes ride rank background
    threads, and a driver-side committer publishes the manifest when the
    shards land.  ``num_to_keep`` evicts old committed steps (and their
    now-unreferenced chunks) after each commit.
    """

    def __init__(self, group, root: str,
                 tree_fn: Callable[[dict], Any],
                 num_to_keep: Optional[int] = None,
                 commit_timeout: float = 120.0):
        self.group = group
        self.root = root
        self.tree_fn = tree_fn
        self.num_to_keep = num_to_keep
        self.commit_timeout = commit_timeout
        self.committer = AsyncCommitter()
        self.last_manifest: Optional[dict] = None
        # In-flight async saves die with the gang: stop their committers
        # from publishing a half-written step after a rebuild.
        if hasattr(group, "add_restart_hook"):
            group.add_restart_hook(lambda g: self.committer.cancel_pending())

    def _post_commit(self, manifest: dict) -> None:
        self.last_manifest = manifest
        if self.num_to_keep:
            try:
                mf.evict_steps(self.root, self.num_to_keep)
            except Exception:
                pass

    def save(self, step: int, meta: Optional[dict] = None) -> dict:
        """Lockstep sharded save: every rank persists, then commit."""
        self.group.run_stateful(_rank_persist_shard, self.root, step,
                                self.tree_fn, True, meta)
        manifest = commit_when_complete(self.root, step,
                                        self.group.num_hosts, meta=meta,
                                        timeout=self.commit_timeout,
                                        in_progress=self.committer
                                        .pending_steps())
        self._post_commit(manifest)
        return manifest

    def save_async(self, step: int, meta: Optional[dict] = None) -> None:
        """Async sharded save: ranks snapshot and return (persist runs on
        their background threads); the manifest commits from a driver
        thread when every shard lands."""
        self.group.run_stateful(_rank_persist_shard, self.root, step,
                                self.tree_fn, False, meta)
        self.committer.commit_async(self.root, step, self.group.num_hosts,
                                    meta=meta, timeout=self.commit_timeout,
                                    on_commit=self._post_commit)

    def flush(self, timeout: Optional[float] = None) -> None:
        """Barrier: worker persists joined, pending commits published."""
        self.group.run_stateful(_rank_wait_persisted, self.commit_timeout)
        self.committer.flush(timeout)

    def latest_step(self) -> Optional[int]:
        return mf.latest_committed_step(self.root)
