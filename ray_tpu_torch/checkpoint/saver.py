"""Per-rank shard persistence: bounded-pause snapshot + background write.

``ShardWriter`` runs INSIDE a rank's process.  ``snapshot()`` is the only
piece on the step path — one batched device→host fetch of the local shard
(the bounded pause; nothing else blocks the device).  ``persist()`` /
``persist_async()`` then chunk, hash and write the snapshot into the
content-addressed store and drop the rank's shard-metadata file — phase 1
of the commit protocol (``ray_tpu_torch.checkpoint.manifest``).  A commit
(phase 2) is the coordinator's job and may run on any process once every
rank file exists.

Metrics: ``checkpoint_save_seconds`` (persist latency histogram),
``checkpoint_bytes_written``, ``checkpoint_chunks_reused_total`` (dedup
hits).  Spans: ``checkpoint_snapshot`` / ``checkpoint_persist`` in the
``ray_tpu_torch._private.profiling`` recorder lane.

Leaves may be ``torch.Tensor``s on any device where the reference takes
``jax.Array``s; a bfloat16 tensor is stored as its raw bytes under the
name ``bfloat16`` (``_to_host``) and restored bit for bit.

Copied from ``ray_tpu/checkpoint/saver.py`` (the JAX package).
"""
from __future__ import annotations

import os
import pickle
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ray_tpu_torch.checkpoint.chunks import ChunkStore
from ray_tpu_torch.checkpoint import manifest as mf
from ray_tpu_torch.checkpoint.tree import IndexFn, flatten_with_paths, full_index


def _save_metrics():
    """Lazy metric handles (internal_kv needs a connected process)."""
    from ray_tpu_torch.util.metrics import Counter, Histogram

    return {
        "seconds": Histogram(
            "checkpoint_save_seconds",
            "per-rank shard persist latency (chunk+hash+write)",
            boundaries=(0.005, 0.02, 0.1, 0.5, 2.0, 10.0)),
        "bytes": Counter("checkpoint_bytes_written",
                         "chunk bytes written by shard persists"),
        "reused": Counter("checkpoint_chunks_reused_total",
                          "chunks deduped against earlier saves"),
    }


class RawArray(np.ndarray):
    """A host copy of a tensor whose dtype numpy lacks (bfloat16): its
    bytes, viewed as the unsigned integer of the same width, with the
    tensor's dtype name in ``dtype_name``, which the shard metadata
    records in place of the integer's."""

    dtype_name: str = ""


def dtype_name(arr: np.ndarray) -> str:
    """The dtype a snapshot array records: a ``RawArray``'s tensor dtype,
    else numpy's name."""
    return getattr(arr, "dtype_name", "") or str(arr.dtype)


def _to_host(leaf) -> Optional[np.ndarray]:
    """One leaf to a host numpy array (None passes through).  A
    ``torch.Tensor`` (on any device) is copied to the host; a bfloat16
    one becomes a ``RawArray`` of its raw bytes, since numpy has no
    bfloat16 (the reference writes ml_dtypes' bfloat16, whose bytes and
    name are the same)."""
    if leaf is None:
        return None
    if isinstance(leaf, np.ndarray):
        return np.ascontiguousarray(leaf)
    torch = sys.modules.get("torch")
    if torch is not None and isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu").contiguous()
        if t.dtype == torch.bfloat16:
            raw = t.view(torch.int16).numpy().view(np.uint16).view(RawArray)
            raw.dtype_name = "bfloat16"
            return raw
        return np.ascontiguousarray(t.numpy())
    arr = np.asarray(leaf)
    if arr.dtype == object:
        raise TypeError(
            f"checkpoint leaves must be arrays/scalars, got object dtype "
            f"for {type(leaf).__name__}")
    return np.ascontiguousarray(arr)


class ShardWriter:
    """One rank's writer into a checkpoint root."""

    def __init__(self, root: str, rank: int = 0, world_size: int = 1,
                 chunk_bytes: Optional[int] = None):
        self.root = root
        self.rank = int(rank)
        self.world_size = int(world_size)
        self.store = ChunkStore(root, chunk_bytes)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.last_stats: Dict[str, Any] = {}

    # ---- phase 0: the bounded pause ----
    def snapshot(self, tree: Any) -> List[Tuple[str, np.ndarray]]:
        """Device→host copy of the local shard, flattened with paths.
        This is the only step-path cost; everything after runs off it."""
        from ray_tpu_torch._private import profiling

        t0 = time.perf_counter()
        host = [(p, _to_host(leaf)) for p, leaf in flatten_with_paths(tree)]
        profiling.record_span("checkpoint_snapshot", t0, time.perf_counter(),
                              rank=self.rank)
        return host

    # ---- phase 1: persist ----
    def persist(self, snapshot: List[Tuple[str, np.ndarray]], step: int,
                index_fn: Optional[IndexFn] = None,
                extra: Optional[dict] = None) -> Dict[str, Any]:
        """Chunk + write the snapshot and publish this rank's shard file.
        Returns persist stats ({"bytes_written", "chunks_reused", ...})."""
        from ray_tpu_torch._private import chaos, profiling

        t0 = time.perf_counter()
        arrays: Dict[str, dict] = {}
        written = 0
        reused = 0
        for path, arr in snapshot:
            if arr is None:
                continue
            gshape_index = index_fn(path, arr) if index_fn else None
            replicated = gshape_index is None
            if replicated:
                gshape = tuple(int(d) for d in arr.shape)
                index = full_index(gshape)
            else:
                gshape, index = gshape_index
            entry = {
                "dtype": dtype_name(arr),
                "shape": [int(d) for d in arr.shape],
                "global_shape": [int(d) for d in gshape],
                "index": [[int(s), int(e)] for s, e in index],
                "nbytes": int(arr.nbytes),
                "replicated": bool(replicated),
                "chunks": None,
            }
            # Replicated arrays are identical on every rank: only rank 0
            # pays the hash+write; the others record metadata only.
            if not replicated or self.rank == 0:
                hashes, w, r = self.store.put_buffer(arr.data)
                entry["chunks"] = hashes
                entry["chunk_size"] = self.store.chunk_bytes
                written += w
                reused += r
            arrays[path] = entry
        meta = {
            "rank": self.rank,
            "world_size": self.world_size,
            "arrays": arrays,
            "extra": dict(extra or {}),
        }
        # Chaos kill site "checkpoint_shard:<rank>:<nth>": dies between the
        # chunk writes and this rank's metadata publish.
        chaos.maybe_die("checkpoint_shard", self.rank)
        mf.write_rank_meta(self.root, step, self.rank, meta)
        t1 = time.perf_counter()
        profiling.record_span("checkpoint_persist", t0, t1,
                              rank=self.rank, step=int(step))
        stats = {"rank": self.rank, "step": int(step),
                 "bytes_written": written, "chunks_reused": reused,
                 "seconds": t1 - t0}
        self.last_stats = stats
        try:
            m = _save_metrics()
            m["seconds"].observe(t1 - t0)
            if written:
                m["bytes"].inc(written)
            if reused:
                m["reused"].inc(reused)
        except Exception:
            pass
        return stats

    def persist_async(self, snapshot: List[Tuple[str, np.ndarray]],
                      step: int, index_fn: Optional[IndexFn] = None,
                      extra: Optional[dict] = None) -> None:
        """Run ``persist`` on a background thread (one at a time per
        writer: a still-running earlier persist is joined first so shard
        files always appear in step order)."""
        self.wait()

        def run():
            try:
                self.persist(snapshot, step, index_fn, extra)
            except BaseException as e:  # noqa: BLE001 — surfaced by wait()
                self._error = e

        self._thread = threading.Thread(
            target=run, daemon=True, name=f"ckpt-persist-r{self.rank}")
        self._thread.start()

    def wait(self, timeout: Optional[float] = None) -> None:
        """Join the in-flight background persist; re-raises its error."""
        t = self._thread
        if t is not None:
            t.join(timeout)
            if t.is_alive():
                raise TimeoutError("background checkpoint persist did not "
                                   f"finish within {timeout}s")
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def save_tree(root: str, tree: Any, step: int,
              meta: Optional[dict] = None,
              chunk_bytes: Optional[int] = None) -> Dict[str, Any]:
    """Single-process convenience: snapshot + persist + commit one full
    (world_size=1) tree.  Returns persist stats with the manifest."""
    writer = ShardWriter(root, rank=0, world_size=1, chunk_bytes=chunk_bytes)
    stats = writer.persist(writer.snapshot(tree), step)
    manifest = mf.commit_manifest(root, step, 1, meta=meta)
    mf.gc_orphans(root, below=step)
    stats["manifest"] = manifest
    return stats


def persist_dict_checkpoint(root: str, step: int, data: Dict[str, Any],
                            meta: Optional[dict] = None) -> dict:
    """Persist a plain dict checkpoint under the same commit protocol
    (kind="dict"): payload first, manifest rename last — so manifest
    discovery treats driver-side dict checkpoints and rank-sharded saves
    uniformly."""
    sdir = mf.step_dir(root, step)
    os.makedirs(sdir, exist_ok=True)
    tmp = os.path.join(sdir, mf.DICT_PAYLOAD + ".tmp")
    with open(tmp, "wb") as f:
        pickle.dump(data, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(sdir, mf.DICT_PAYLOAD))
    manifest = mf.commit_manifest(root, step, 1, meta=meta, kind="dict")
    mf.gc_orphans(root, below=step)
    return manifest
