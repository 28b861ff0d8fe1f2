"""Content-addressed chunk store: the dedup layer under sharded saves.

Array bytes are split into fixed-size chunks; each chunk is stored once
under its content hash (``chunks/<hh>/<hash>``).  A re-save of unchanged
state hashes to the same names and writes nothing — frequent checkpoints
pay only for the chunks that actually changed (the hard-link-style reuse
from incremental checkpointing, done by reference instead of by link so
eviction is a plain unreferenced-chunk sweep).

Writes are atomic (tmp file + ``os.replace``): a chunk file either exists
with its full content or not at all, so a crash mid-save can never corrupt
a chunk another manifest already references.

Copied from ``ray_tpu/checkpoint/chunks.py`` (the JAX package).
"""
from __future__ import annotations

import hashlib
import os
import time
import uuid
from typing import Iterator, List, Optional, Set, Tuple

CHUNK_BYTES_ENV = "RAY_TPU_TORCH_CHECKPOINT_CHUNK_BYTES"
_DEFAULT_CHUNK_BYTES = 1 << 20  # 1 MiB

GC_GRACE_ENV = "RAY_TPU_TORCH_CHECKPOINT_GC_GRACE_SECONDS"
_DEFAULT_GC_GRACE = 300.0

CHUNKS_DIR = "chunks"


def default_chunk_bytes() -> int:
    try:
        return max(4096, int(os.environ.get(CHUNK_BYTES_ENV,
                                            _DEFAULT_CHUNK_BYTES)))
    except ValueError:
        return _DEFAULT_CHUNK_BYTES


def gc_grace_seconds() -> float:
    try:
        return max(0.0, float(os.environ.get(GC_GRACE_ENV,
                                             _DEFAULT_GC_GRACE)))
    except ValueError:
        return _DEFAULT_GC_GRACE


def hash_chunk(view) -> str:
    # blake2b: ~2x sha256 throughput; 20 bytes is plenty for a store that
    # holds thousands, not trillions, of chunks.
    return hashlib.blake2b(view, digest_size=20).hexdigest()


def split_chunks(buf, chunk_bytes: int) -> Iterator[memoryview]:
    view = memoryview(buf).cast("B")
    for off in range(0, len(view), chunk_bytes):
        yield view[off:off + chunk_bytes]
    if len(view) == 0:
        yield view  # zero-size arrays still get one (empty) chunk


class ChunkStore:
    """The ``chunks/`` directory of one checkpoint root."""

    def __init__(self, root: str, chunk_bytes: Optional[int] = None):
        self.root = root
        self.dir = os.path.join(root, CHUNKS_DIR)
        self.chunk_bytes = chunk_bytes or default_chunk_bytes()

    def _path(self, h: str) -> str:
        return os.path.join(self.dir, h[:2], h)

    def put(self, view) -> Tuple[str, int]:
        """Store one chunk; returns (hash, bytes_written) — 0 bytes when
        the chunk already exists (dedup hit)."""
        h = hash_chunk(view)
        path = self._path(h)
        if os.path.exists(path):
            # Refresh mtime so a dedup-reused chunk counts as "young" to a
            # concurrent gc(): without this, a chunk referenced only by a
            # step being evicted could be swept in the window between this
            # existence check and our rank file publishing.
            try:
                os.utime(path, None)
            except OSError:
                pass
            return h, 0
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = os.path.join(self.dir, f".tmp_{uuid.uuid4().hex}")
        with open(tmp, "wb") as f:
            f.write(view)
        # Concurrent writers of the same content race benignly: both tmp
        # files hold identical bytes and replace() is atomic.
        os.replace(tmp, path)
        return h, len(view)

    def put_buffer(self, buf) -> Tuple[List[str], int, int]:
        """Chunk + store a whole buffer; returns (hashes, bytes_written,
        chunks_reused)."""
        hashes: List[str] = []
        written = 0
        reused = 0
        for view in split_chunks(buf, self.chunk_bytes):
            h, w = self.put(view)
            hashes.append(h)
            written += w
            if w == 0 and len(view):
                reused += 1
        return hashes, written, reused

    def read(self, h: str) -> bytes:
        with open(self._path(h), "rb") as f:
            return f.read()

    def read_into(self, hashes: List[str], dest) -> None:
        """Reassemble a chunk list into a writable buffer."""
        view = memoryview(dest).cast("B")
        off = 0
        for h in hashes:
            data = self.read(h)
            view[off:off + len(data)] = data
            off += len(data)
        if off != len(view):
            raise ValueError(
                f"chunk list reassembles to {off} bytes, buffer wants "
                f"{len(view)}")

    def known_chunks(self) -> Set[str]:
        out: Set[str] = set()
        if not os.path.isdir(self.dir):
            return out
        for sub in os.listdir(self.dir):
            p = os.path.join(self.dir, sub)
            if not os.path.isdir(p):
                continue
            out.update(os.listdir(p))
        return out

    def gc(self, referenced: Set[str],
           grace_seconds: Optional[float] = None) -> int:
        """Delete chunks not in ``referenced``; returns deleted count.

        Chunks younger than the grace window are kept even when
        unreferenced: a rank persist writes (or utime-refreshes) its
        chunks BEFORE publishing its rank file, so a concurrent sweep
        computed from on-disk rank files would otherwise delete chunks an
        about-to-commit step needs.  Also unlinks stale ``.tmp_*`` files
        left in the store root by writers that crashed between the tmp
        write and ``os.replace`` (``known_chunks`` never sees those, so
        no other sweep reclaims them)."""
        grace = gc_grace_seconds() if grace_seconds is None else grace_seconds
        cutoff = time.time() - grace
        deleted = 0
        for h in self.known_chunks() - set(referenced):
            path = self._path(h)
            try:
                if os.path.getmtime(path) > cutoff:
                    continue
                os.remove(path)
                deleted += 1
            except OSError:
                pass
        if os.path.isdir(self.dir):
            for name in os.listdir(self.dir):
                if not name.startswith(".tmp_"):
                    continue
                p = os.path.join(self.dir, name)
                try:
                    if os.path.getmtime(p) <= cutoff:
                        os.remove(p)
                except OSError:
                    pass
        return deleted
