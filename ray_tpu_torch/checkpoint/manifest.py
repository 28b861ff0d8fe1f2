"""Step directories, rank shard metadata, and the atomic commit protocol.

Two-phase commit:

1. **Persist** — each rank writes its chunks into the content-addressed
   store, then its ``rank_<r>.json`` shard metadata into the step dir
   (tmp + ``os.replace``, so a rank file is never half-written).
2. **Commit** — once every rank file exists, ONE writer (the coordinator)
   writes ``MANIFEST.json`` via tmp + atomic rename.  The manifest is the
   existence predicate: readers only ever look at steps that have one, so
   a crash anywhere before the rename leaves the previous committed
   checkpoint as the latest — never a partial view.

Aborted saves (step dirs without a manifest) are swept by ``gc_orphans``
on the next commit; chunks referenced by no committed manifest are swept
by ``gc_chunks`` after eviction.

Copied from ``ray_tpu/checkpoint/manifest.py`` (the JAX package).
"""
from __future__ import annotations

import json
import os
import shutil
import time
import uuid
from typing import Dict, Iterable, List, Optional, Set

from ray_tpu_torch.checkpoint.chunks import ChunkStore

MANIFEST_FILE = "MANIFEST.json"
STEPS_DIR = "steps"
_STEP_FMT = "step_{:08d}"
_RANK_FMT = "rank_{:05d}.json"
DICT_PAYLOAD = "checkpoint.pkl"


def step_dir(root: str, step: int) -> str:
    return os.path.join(root, STEPS_DIR, _STEP_FMT.format(int(step)))


def rank_file(sdir: str, rank: int) -> str:
    return os.path.join(sdir, _RANK_FMT.format(int(rank)))


def _atomic_write_json(path: str, payload: dict) -> None:
    tmp = path + f".tmp_{uuid.uuid4().hex[:8]}"
    with open(tmp, "w") as f:
        json.dump(payload, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def write_rank_meta(root: str, step: int, rank: int, meta: dict) -> str:
    sdir = step_dir(root, step)
    os.makedirs(sdir, exist_ok=True)
    path = rank_file(sdir, rank)
    _atomic_write_json(path, meta)
    return path


def missing_rank_files(root: str, step: int, world_size: int) -> List[int]:
    sdir = step_dir(root, step)
    return [r for r in range(world_size)
            if not os.path.exists(rank_file(sdir, r))]


def commit_manifest(root: str, step: int, world_size: int,
                    meta: Optional[dict] = None,
                    kind: str = "sharded") -> dict:
    """Phase 2: atomically publish ``step`` as committed.  Raises
    ``FileNotFoundError`` if any rank's shard file is missing — commit
    must never outrun persist."""
    from ray_tpu_torch._private import chaos

    sdir = step_dir(root, step)
    if kind == "sharded":
        missing = missing_rank_files(root, step, world_size)
        if missing:
            raise FileNotFoundError(
                f"cannot commit step {step}: missing shard files for "
                f"ranks {missing} under {sdir}")
    manifest = {
        "kind": kind,
        "step": int(step),
        "world_size": int(world_size),
        "created_at": time.time(),
        "meta": dict(meta or {}),
    }
    # Chaos kill site: a schedule entry "checkpoint_commit:0:<nth>" SIGKILLs
    # here — after every shard persisted, before the atomic publish — the
    # exact window the two-phase protocol must make invisible to readers.
    chaos.maybe_die("checkpoint_commit", 0)
    _atomic_write_json(os.path.join(sdir, MANIFEST_FILE), manifest)
    try:
        _commit_metrics()
    except Exception:
        pass
    return manifest


def _commit_metrics() -> None:
    from ray_tpu_torch.util.metrics import Counter

    Counter("checkpoint_commits_total",
            "committed distributed checkpoints").inc()


def read_manifest(root: str, step: int) -> dict:
    with open(os.path.join(step_dir(root, step), MANIFEST_FILE)) as f:
        return json.load(f)


def _step_of(name: str) -> Optional[int]:
    if not name.startswith("step_"):
        return None
    try:
        return int(name[len("step_"):])
    except ValueError:
        return None


def all_steps(root: str) -> List[int]:
    """Every step dir on disk, committed or not."""
    d = os.path.join(root, STEPS_DIR)
    if not os.path.isdir(d):
        return []
    steps = [_step_of(n) for n in os.listdir(d)]
    return sorted(s for s in steps if s is not None)


def committed_steps(root: str) -> List[int]:
    return [s for s in all_steps(root)
            if os.path.exists(os.path.join(step_dir(root, s), MANIFEST_FILE))]


def latest_committed_step(root: str) -> Optional[int]:
    steps = committed_steps(root)
    return steps[-1] if steps else None


def load_rank_metas(root: str, step: int) -> List[dict]:
    manifest = read_manifest(root, step)
    sdir = step_dir(root, step)
    metas = []
    for r in range(manifest["world_size"]):
        with open(rank_file(sdir, r)) as f:
            metas.append(json.load(f))
    return metas


def delete_step(root: str, step: int) -> None:
    shutil.rmtree(step_dir(root, step), ignore_errors=True)


def gc_orphans(root: str, in_progress: Iterable[int] = (),
               below: Optional[int] = None) -> List[int]:
    """Sweep aborted saves: step dirs with no manifest that aren't part of
    a save currently in flight.  ``below`` (the committing step) bounds
    the sweep — steps ABOVE it may be concurrent saves still persisting
    their shards (async pipelines overlap save N+1 with N's commit), so
    only steps strictly below are provably dead; a crashed newer step is
    swept by the next, higher-numbered commit.  Returns deleted steps."""
    keep = set(int(s) for s in in_progress)
    committed = set(committed_steps(root))
    deleted = []
    for s in all_steps(root):
        if s in committed or s in keep:
            continue
        if below is not None and s >= below:
            continue
        delete_step(root, s)
        deleted.append(s)
    if deleted:
        try:
            from ray_tpu_torch.util.metrics import Counter

            Counter("checkpoint_gc_orphans_total",
                    "aborted partial saves garbage-collected").inc(
                        len(deleted))
        except Exception:
            pass
    return deleted


def referenced_chunks(root: str) -> Set[str]:
    """Chunks referenced by ANY shard file on disk — committed or not: an
    in-flight async save's chunks must survive a concurrent eviction's
    sweep (its step dir only becomes collectable once gc_orphans removes
    it, after which the next sweep reclaims the chunks)."""
    refs: Set[str] = set()
    for s in all_steps(root):
        sdir = step_dir(root, s)
        try:
            names = os.listdir(sdir)
        except OSError:
            continue  # concurrently evicted
        for name in names:
            if not (name.startswith("rank_") and name.endswith(".json")):
                continue
            try:
                with open(os.path.join(sdir, name)) as f:
                    meta = json.load(f)
                for arr in meta.get("arrays", {}).values():
                    refs.update(arr.get("chunks") or ())
            except (OSError, json.JSONDecodeError, KeyError, AttributeError):
                continue
    return refs


def gc_chunks(root: str) -> int:
    """Delete chunks no committed manifest references; returns count."""
    return ChunkStore(root).gc(referenced_chunks(root))


def evict_steps(root: str, num_to_keep: int) -> List[int]:
    """Delete the oldest committed steps beyond ``num_to_keep``, then sweep
    now-unreferenced chunks.  Returns the evicted steps."""
    steps = committed_steps(root)
    evicted = steps[:-num_to_keep] if num_to_keep > 0 else []
    for s in evicted:
        delete_step(root, s)
    if evicted:
        gc_chunks(root)
    return evicted
