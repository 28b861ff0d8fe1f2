"""Plasma-equivalent shared-memory object store.

The reference implements this as a dlmalloc arena over one big mmap inside the
raylet (src/ray/object_manager/plasma/store.h:55, dlmalloc.cc) with fd-passing
to clients.  Our TPU-native design keeps the same *contract* — named,
immutable, sealed, zero-copy-readable shared-memory objects with create/seal/
get/delete and eviction accounting — but maps each object to its own POSIX
shm segment (``multiprocessing.shared_memory``), which any worker process on
the node can attach by name.  A C++ arena allocator (ray_tpu/_native) can be
slotted under the same interface later for allocation-rate-bound workloads;
for ML workloads the store holds few, large, numpy-backed objects
(SampleBatches, checkpoints, dataset blocks) where per-object segments are
ideal: the kernel does the zero-copy, and there is no fragmentation.

Small objects never come here — they live in the in-process memory store
(memory_store.py), exactly like the reference's CoreWorkerMemoryStore
(src/ray/core_worker/store_provider/memory_store/memory_store.h:43).

Copied from ``ray_tpu/_private/object_store.py`` (the JAX package).
"""
from __future__ import annotations

import atexit
import os
import threading
import weakref
from collections import OrderedDict, deque
from multiprocessing import resource_tracker, shared_memory
from typing import Dict, Optional, Tuple

from ray_tpu_torch._private.ids import ObjectID

# Objects <= this many bytes are inlined in task replies / the memory store.
INLINE_OBJECT_THRESHOLD = 100 * 1024

# Distinct from the JAX package's "rtpu_": a sweep of one package's
# segments never unlinks the other's.
_PREFIX = "rttp_"

# Monotonic suffix for replica segment names (put_replica): replicas of the
# same object on different stores of one process must not collide.
_replica_counter = 0


def _segment_name(object_id: ObjectID) -> str:
    return _PREFIX + object_id.hex()


# Names this process has already told the resource tracker to forget; a
# second unregister makes the tracker process log KeyErrors at exit.
# Bounded: delete() calls forget_untracked() when a segment is unlinked,
# so long-lived drivers don't accumulate one entry per object ever seen.
_untracked: set = set()

# Segments THIS process created, keeps registered with the tracker, and
# will unlink itself (store-created + pooled segments).  A same-process
# attach must NOT untrack these: stripping the creator's registration
# makes the eventual unlink() a double-unregister (KeyError spam in the
# tracker daemon) and loses the crash-cleanup safety net.
_process_owned: set = set()


def note_owned(shm: shared_memory.SharedMemory):
    _process_owned.add(shm._name)  # type: ignore[attr-defined]


def untrack(shm: shared_memory.SharedMemory):
    """Tell the resource tracker this process does NOT own the segment.

    Python 3.12 registers every SharedMemory (even attaches) with the
    tracker, which would unlink live objects when this process exits."""
    name = shm._name  # type: ignore[attr-defined]
    if name in _untracked or name in _process_owned:
        return
    try:
        resource_tracker.unregister(name, "shared_memory")
        _untracked.add(name)
    except Exception:
        pass


def retrack(shm: shared_memory.SharedMemory):
    """Undo untrack() before this process unlinks the segment itself.

    unlink() unregisters the name with the tracker daemon; if untrack()
    already did, the daemon logs a KeyError per segment.  Used on the
    abort path of a worker's pull-into-store (the segment was created
    here, untracked in anticipation of the store adopting it, and must
    now be destroyed because the pull failed)."""
    name = shm._name  # type: ignore[attr-defined]
    if name in _untracked:
        try:
            resource_tracker.register(name, "shared_memory")
        except Exception:
            pass
        _untracked.discard(name)


def forget_untracked(shm: shared_memory.SharedMemory):
    """The segment is gone (unlinked): drop its bookkeeping entries so
    neither name set grows without bound in long-lived processes."""
    name = shm._name  # type: ignore[attr-defined]
    _untracked.discard(name)
    _process_owned.discard(name)


# Every SharedMemory this process opens (create or attach) is tracked in
# a weak set so interpreter shutdown can DEFUSE the mappings that still
# have live C-level buffer exports.  Zero-copy reads hand numpy views
# over segment mmaps to user code (sample batches, weights); when such a
# view survives to interpreter teardown, SharedMemory.__del__ -> close()
# -> mmap.close() raises "BufferError: cannot close exported pointers
# exist" and CPython prints an ignored-exception traceback per segment —
# the bench-tail spam.  The atexit hook below releases what is
# releasable and detaches the rest (fd closed, mmap handle dropped; the
# mapping itself dies with the process microseconds later).
_live_shms: "weakref.WeakSet[shared_memory.SharedMemory]" = weakref.WeakSet()


def track_for_exit(shm: shared_memory.SharedMemory
                   ) -> shared_memory.SharedMemory:
    _live_shms.add(shm)
    return shm


def defuse_shm(shm: shared_memory.SharedMemory) -> bool:
    """Deterministically release a segment handle that may still have
    exported buffer pointers.  Returns True when close() fully succeeded;
    on a live export the mmap/fd handles are dropped so a later __del__
    (or a second close()) is a silent no-op instead of a BufferError
    traceback."""
    try:
        shm.close()
        return True
    except BufferError:
        pass
    except Exception:
        return False
    buf = getattr(shm, "_buf", None)
    if buf is not None:
        try:
            buf.release()
        except BufferError:
            pass
        shm._buf = None  # type: ignore[attr-defined]
    # The mmap still has exporters (numpy views): leak the mapping — the
    # process is exiting (or the last view owner will drop it) — but
    # close the fd and clear the handles so __del__ cannot raise.
    shm._mmap = None  # type: ignore[attr-defined]
    fd = getattr(shm, "_fd", -1)
    if fd >= 0:
        try:
            os.close(fd)
        except OSError:
            pass
        shm._fd = -1  # type: ignore[attr-defined]
    return False


def _defuse_all_at_exit() -> None:
    for shm in list(_live_shms):
        try:
            defuse_shm(shm)
        except Exception:
            pass


# Registered at import (atexit is LIFO): runs AFTER the store/worker
# shutdown hooks registered later, as the last line of defense.
atexit.register(_defuse_all_at_exit)


# The atexit hook covers interpreter shutdown, but SharedMemory.__del__
# also fires whenever GC frees a segment handle while a consumer still
# holds numpy/arrow views into its mmap (zero-copy reads hand such views
# to user code); stock __del__ only swallows OSError, so the BufferError
# from mmap.close() escapes and CPython prints an ignored-exception
# traceback per segment — the bench-tail spam.  Route every __del__
# through the same defusal: try the normal close, and on a live export
# drop the handles instead of raising.  Locals are bound as defaults so
# the wrapper stays callable during late interpreter teardown.
_orig_shm_del = shared_memory.SharedMemory.__del__


def _shm_del(self, _orig=_orig_shm_del, _defuse=defuse_shm):
    try:
        _orig(self)
    except BufferError:
        try:
            _defuse(self)
        except Exception:
            pass
    except Exception:
        pass  # __del__ must never raise (late-shutdown torn-down globals)


# The JAX package's copy of this module installs the same wrapper; both
# may be imported in one process (the tests hold one against the other).
# Install this one only over the stock __del__, so neither package's
# import replaces the other's guard.
if _orig_shm_del.__module__ == shared_memory.__name__:
    shared_memory.SharedMemory.__del__ = _shm_del


def attach(object_id: ObjectID,
           segment: Optional[str] = None) -> shared_memory.SharedMemory:
    """Attach to an existing sealed object's segment (any process on node).

    ``segment`` overrides the canonical per-object name for objects whose
    bytes landed in a recycled pool segment (see SegmentPool)."""
    shm = shared_memory.SharedMemory(name=segment or _segment_name(object_id))
    untrack(shm)
    return track_for_exit(shm)


class SegmentPool:
    """Size-classed free lists of pre-created, pre-faulted shm segments.

    The reference gets its put throughput from a pre-mapped dlmalloc arena
    (plasma dlmalloc.cc): steady-state allocation never touches the kernel.
    Per-object segments pay ``shm_open + ftruncate + mmap`` per put and —
    far worse — fault in zero pages across the whole object on first
    write, capping large-put bandwidth at roughly half of memcpy.  The
    pool keeps that envelope with per-segment simplicity: segments are
    recycled through power-of-two size classes instead of unlinked, so a
    steady-state put reuses an already-mapped, already-faulted segment and
    runs at memcpy speed.

    Segments are named ``rttp_pool_<pid>_<n>`` — readers learn the name
    from the object's resolution (``segment`` field) instead of deriving
    it from the object id.  Recycling follows plasma semantics: once an
    object's refcount hits zero its memory may be reused, so holding
    zero-copy views past the last ObjectRef is undefined (it was a
    stale-but-valid read in the unlink-per-object design).
    """

    MIN_CLASS = 1 << 20          # segments below 1 MiB aren't worth pooling
    MAX_CLASS = 1 << 31          # 2 GiB: larger objects get dedicated segments

    def __init__(self, max_bytes: int):
        self.max_bytes = max_bytes
        self._free: Dict[int, deque] = {}
        self.free_bytes = 0
        self._lock = threading.Lock()
        self._counter = 0
        # Per-pool uniquifier: several stores (each with its own pool) can
        # live in ONE process — virtual multi-node clusters, a restarted
        # in-process head — and per-pid naming alone would collide.
        self._uid = os.urandom(3).hex()
        self._closed = False
        self._prewarm_thread: Optional[threading.Thread] = None
        self.hits = 0
        self.misses = 0
        self.created = 0

    @classmethod
    def class_for(cls, size: int) -> Optional[int]:
        if size > cls.MAX_CLASS:
            return None
        c = cls.MIN_CLASS
        while c < size:
            c <<= 1
        return c

    def _new_segment(self, cls_size: int) -> shared_memory.SharedMemory:
        with self._lock:
            self._counter += 1
            n = self._counter
        shm = shared_memory.SharedMemory(
            name=f"{_PREFIX}pool_{os.getpid()}_{self._uid}_{n}", create=True,
            size=cls_size)
        note_owned(shm)
        track_for_exit(shm)
        self.created += 1
        return shm

    def acquire(self, size: int
                ) -> Optional[Tuple[shared_memory.SharedMemory, int]]:
        """A segment of the right size class — recycled when one is free,
        freshly created otherwise.  None when the size is un-poolable."""
        cls_size = self.class_for(size)
        if cls_size is None or self._closed:
            return None
        with self._lock:
            q = self._free.get(cls_size)
            if q:
                self.hits += 1
                self.free_bytes -= cls_size
                return q.popleft(), cls_size
            self.misses += 1
        try:
            return self._new_segment(cls_size), cls_size
        except Exception:
            return None

    def release(self, shm: shared_memory.SharedMemory, cls_size: int) -> bool:
        """Return a segment to its free list.  False when the pool is full
        or closed — the caller unlinks the segment instead."""
        with self._lock:
            if self._closed or self.free_bytes + cls_size > self.max_bytes:
                return False
            self._free.setdefault(cls_size, deque()).append(shm)
            self.free_bytes += cls_size
            return True

    # -- background prewarm ------------------------------------------------
    def prewarm(self, spec: str):
        """Pre-create and pre-fault segments per a 'SIZE:COUNT,...' spec on
        a background thread, so the first puts of a fresh store hit the
        pool instead of faulting zero pages on the hot path."""
        plan = _parse_prewarm(spec)
        if not plan:
            return

        def run():
            for cls_size, count in plan:
                for _ in range(count):
                    if self._closed:
                        return
                    try:
                        shm = self._new_segment(cls_size)
                    except Exception:
                        return
                    _pretouch(shm.buf)
                    if not self.release(shm, cls_size):
                        _unlink_quiet(shm)
                        return

        self._prewarm_thread = threading.Thread(
            target=run, name="rtpu-pool-prewarm", daemon=True)
        self._prewarm_thread.start()

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"pool_hits": self.hits, "pool_misses": self.misses,
                    "pool_created": self.created,
                    "pool_free_bytes": self.free_bytes,
                    "pool_free_segments": sum(
                        len(q) for q in self._free.values())}

    def close(self):
        with self._lock:
            self._closed = True
            frees, self._free = list(self._free.values()), {}
            self.free_bytes = 0
        for q in frees:
            for shm in q:
                _unlink_quiet(shm)


def _parse_prewarm(spec: str):
    """'64MiB:4,8MiB:8' -> [(class_size, count), ...] (bad entries skipped)."""
    plan = []
    for part in (spec or "").split(","):
        part = part.strip()
        if not part or ":" not in part:
            continue
        size_s, _, count_s = part.partition(":")
        try:
            size = _parse_size(size_s)
            count = int(count_s)
        except ValueError:
            continue
        cls_size = SegmentPool.class_for(size)
        if cls_size is not None and count > 0:
            plan.append((cls_size, count))
    return plan


def _parse_size(s: str) -> int:
    s = s.strip().lower()
    for suffix, mult in (("kib", 1 << 10), ("mib", 1 << 20),
                         ("gib", 1 << 30), ("kb", 10**3), ("mb", 10**6),
                         ("gb", 10**9), ("k", 1 << 10), ("m", 1 << 20),
                         ("g", 1 << 30), ("b", 1)):
        if s.endswith(suffix):
            return int(float(s[: -len(suffix)]) * mult)
    return int(s)


def _pretouch(buf: memoryview, page: int = 4096):
    """Fault every page in (cheap sequential writes of one byte/page)."""
    try:
        import numpy as np

        arr = np.frombuffer(buf, dtype=np.uint8)
        arr[::page] = 0
    except Exception:
        for off in range(0, len(buf), page):
            buf[off] = 0


def _unlink_quiet(shm: shared_memory.SharedMemory):
    try:
        retrack(shm)  # unlink() re-unregisters; a no-op for owned names
        shm.unlink()
    except Exception:
        pass
    forget_untracked(shm)
    defuse_shm(shm)


class PlasmaObject:
    __slots__ = ("shm", "metadata", "data_size", "sealed", "_view",
                 "pool_class")

    def __init__(self, shm: shared_memory.SharedMemory, data_size: int,
                 pool_class: Optional[int] = None):
        self.shm = shm
        self.metadata: bytes = b""
        self.data_size = data_size
        self.sealed = False
        # Size class of the pooled segment backing this object (None for
        # dedicated per-object segments) — delete() recycles rather than
        # unlinks when set.
        self.pool_class = pool_class
        # ONE canonical zero-copy view per object, handed to every writer
        # (create) and reader (get).  Readers slice it for chunked sends —
        # slices borrow the underlying mmap, not this view, so the store
        # can release it deterministically at delete time and shm.close()
        # stops failing with "cannot close exported pointers exist".
        self._view: Optional[memoryview] = None

    def view(self) -> memoryview:
        if self._view is None:
            self._view = (self.shm.buf[:self.data_size] if self.data_size
                          else memoryview(b""))
        return self._view

    def release_view(self) -> bool:
        """Deterministic reclaim of the exported view (delete/shutdown
        path).  Any reader still holding the canonical view sees a
        released memoryview (ValueError on access) instead of silently
        leaking the whole segment mapping.  Returns False when a C-level
        buffer export is still live (the segment must NOT be recycled —
        the exporter would read freshly-written bytes)."""
        v, self._view = self._view, None
        if v is not None:
            try:
                v.release()
            except BufferError:
                return False  # a C-level buffer export is live; close()
                # will leak this one segment rather than crash the reader
        return True


class SharedMemoryStore:
    """Node-local store (owner side). Lives in the node's raylet.

    Accounting and LRU-style eviction of *unreferenced* sealed objects mirror
    plasma's ObjectLifecycleManager + EvictionPolicy
    (src/ray/object_manager/plasma/object_lifecycle_manager.h,
    eviction_policy.h).  Spill-to-disk hooks on eviction of referenced
    objects are the round-2 extension point (local_object_manager.h:41).
    """

    def __init__(self, capacity_bytes: int = 2 * 1024**3,
                 use_native_arena: bool = True,
                 spill_dir: Optional[str] = None):
        self.capacity = capacity_bytes
        self.used = 0
        self._objects: "OrderedDict[ObjectID, PlasmaObject]" = OrderedDict()
        self._pinned: Dict[ObjectID, int] = {}
        self._lock = threading.RLock()
        # Called with the ObjectID when LRU eviction frees an object, so the
        # object directory can mark it lost / trigger lineage reconstruction.
        self.evict_callback = None
        # Spilling (reference: local_object_manager.h:41): under memory
        # pressure, evicted objects whose bytes must survive (referenced /
        # unknown) are written to spill_dir instead of dropped; get()
        # restores them.  None disables spilling (pre-round-3 behavior).
        self.spill_dir = spill_dir
        self._spilled: Dict[ObjectID, Tuple[str, bytes, int]] = {}
        # Policy hook: should_spill(oid) -> bool.  When unset, every evicted
        # object spills (safe default for stores that cannot see refcounts,
        # e.g. on remote node agents); the head wires this to the object
        # directory so unreferenced objects are simply dropped.
        self.should_spill = None
        self.spill_callback = None  # notified with (oid) after a spill
        # Native C++ arena (plasma-core equivalent, ray_tpu/_native): used for
        # owner-process writes (driver puts).  Worker-created objects keep
        # the per-segment zero-round-trip path; both are zero-copy reads.
        self.arena = None
        from ray_tpu_torch._private.config import CONFIG

        if use_native_arena and CONFIG.native_store:
            try:
                from ray_tpu_torch import _native

                if _native.available():
                    self.arena = _native.NativeArenaStore(
                        _PREFIX + "arena_" + os.urandom(6).hex(), capacity_bytes)
            except Exception:
                self.arena = None
        # Segment pool: steady-state large puts reuse pre-faulted recycled
        # segments instead of paying shm_open + kernel page-zeroing per
        # object (see SegmentPool).  Free-list bytes are NOT charged to
        # `used` — like plasma's arena, pooled memory is store overhead.
        self.pool: Optional[SegmentPool] = None
        if CONFIG.segment_pool:
            pool_cap = CONFIG.segment_pool_bytes or capacity_bytes
            self.pool = SegmentPool(pool_cap)
            spec = CONFIG.segment_pool_prewarm
            if spec:
                self.pool.prewarm(spec)
        # Monotone create counter: "no new segments appeared here" checks
        # (e.g. the cooperative-broadcast smoke asserting the owner's
        # store stayed untouched) can't be fooled by a create+delete pair
        # the way num_objects can.
        self.segments_created_total = 0

    # -- create/seal ------------------------------------------------------
    def create(self, object_id: ObjectID, data_size: int,
               overcommit: bool = False,
               segment: Optional[str] = None) -> memoryview:
        """Allocate a writable segment for a new object.

        ``overcommit=True`` keeps the zero-round-trip in-process put path
        lossless under pressure: after eviction/spill the create proceeds
        even above capacity (the same contract adopt() gives worker-
        written segments) instead of raising.

        ``segment`` forces a dedicated shm segment with that name instead
        of the canonical per-object one — required for replica writes,
        where the canonical name may already exist on this machine (the
        primary copy in a sibling virtual node's store)."""
        with self._lock:
            if object_id in self._objects:
                raise ObjectExistsError(object_id)
            if data_size > self.capacity and not overcommit:
                raise OutOfMemoryError(
                    f"object of {data_size} bytes exceeds store capacity {self.capacity}"
                )
            self._evict_until(data_size)
            if self.used + data_size > self.capacity:
                if not overcommit:
                    raise OutOfMemoryError(
                        f"store full: need {data_size}, "
                        f"free {self.capacity - self.used} of {self.capacity}"
                    )
                import logging

                logging.getLogger(__name__).warning(
                    "object store over capacity: %d + %d > %d",
                    self.used, data_size, self.capacity)
            pool_class = None
            shm = None
            if segment is None and self.pool is not None \
                    and data_size >= SegmentPool.MIN_CLASS:
                acq = self.pool.acquire(data_size)
                if acq is not None:
                    shm, pool_class = acq
            if shm is None:
                shm = shared_memory.SharedMemory(
                    name=segment or _segment_name(object_id), create=True,
                    size=max(1, data_size))
                note_owned(shm)
                track_for_exit(shm)
            obj = PlasmaObject(shm, data_size, pool_class=pool_class)
            self._objects[object_id] = obj
            self.used += data_size
            self.segments_created_total += 1
            return obj.view()

    def segment_of(self, object_id: ObjectID) -> Optional[str]:
        """Segment name when it differs from the canonical per-object name
        (pooled segments, replica segments); None means readers derive it
        from the id."""
        with self._lock:
            obj = self._objects.get(object_id)
            if obj is None:
                return None
            name = obj.shm.name
            return name if name != _segment_name(object_id) else None

    def seal(self, object_id: ObjectID, metadata: bytes = b""):
        with self._lock:
            obj = self._objects[object_id]
            obj.metadata = metadata
            obj.sealed = True
            self._objects.move_to_end(object_id)

    def put(self, object_id: ObjectID, metadata: bytes, data: bytes) -> None:
        buf = self.create(object_id, len(data))
        if len(data):
            buf[:] = data
        self.seal(object_id, metadata)

    def put_replica(self, object_id: ObjectID, metadata: bytes,
                    data) -> Optional[str]:
        """Store a durability replica of an object owned by another node.

        Always lands in a uniquely-named segment: on a multi-virtual-node
        machine the primary's canonical segment already exists host-wide,
        so a canonical-name create would collide.  Returns the segment
        name (readers resolve it via ``segment_of``), or None when the
        object is already present here."""
        global _replica_counter
        with self._lock:
            if object_id in self._objects:
                return self.segment_of(object_id)
            _replica_counter += 1
            seg = f"{_PREFIX}rep_{os.getpid()}_{_replica_counter}"
        try:
            buf = self.create(object_id, len(data), segment=seg)
        except ObjectExistsError:
            return self.segment_of(object_id)
        if len(data):
            buf[:] = data
        self.seal(object_id, metadata)
        return seg

    # -- read -------------------------------------------------------------
    def contains(self, object_id: ObjectID) -> bool:
        with self._lock:
            o = self._objects.get(object_id)
            return o is not None and o.sealed

    def get(self, object_id: ObjectID) -> Optional[Tuple[bytes, memoryview]]:
        """Returns (metadata, data) or None. Zero-copy: data is the
        object's canonical shm view — shared by all readers, reclaimed by
        the store at delete/shutdown (readers slice it for chunked sends;
        slices borrow the mmap directly and die with the reader)."""
        with self._lock:
            obj = self._objects.get(object_id)
            if obj is None or not obj.sealed:
                return None
            self._objects.move_to_end(object_id)  # LRU touch
            return obj.metadata, obj.view()

    def meta(self, object_id: ObjectID) -> Optional[bytes]:
        with self._lock:
            obj = self._objects.get(object_id)
            return obj.metadata if obj and obj.sealed else None

    # -- pin/delete/evict -------------------------------------------------
    def pin(self, object_id: ObjectID):
        with self._lock:
            self._pinned[object_id] = self._pinned.get(object_id, 0) + 1

    def unpin(self, object_id: ObjectID):
        with self._lock:
            n = self._pinned.get(object_id, 0) - 1
            if n <= 0:
                self._pinned.pop(object_id, None)
            else:
                self._pinned[object_id] = n

    def adopt(self, object_id: ObjectID, data_size: int, metadata: bytes,
              segment: Optional[str] = None):
        """Adopt a segment created (and already written) by a worker process.

        Workers create+write the segment directly — zero round-trips, like
        plasma's mmap'd create — then notify their raylet, which takes over
        ownership/accounting here."""
        with self._lock:
            if object_id in self._objects:
                return
            self._evict_until(data_size)
            shm = attach(object_id, segment)
            obj = PlasmaObject(shm, data_size)
            obj.metadata = metadata
            obj.sealed = True
            self._objects[object_id] = obj
            self.used += data_size
            if self.used > self.capacity:
                # The segment already exists (worker wrote it), so the
                # overflow is a fact; shed OTHER objects (evict or spill)
                # until the store is back under capacity instead of only
                # logging — the reference instead backpressures at create
                # time (plasma create_request_queue.h), which needs a
                # create RPC and trades away the zero-round-trip write.
                self._evict_until(0, exclude=object_id)
                if self.used > self.capacity:
                    import logging

                    logging.getLogger(__name__).warning(
                        "object store over capacity after adopt: %d > %d "
                        "(remaining objects pinned or unsealed)",
                        self.used, self.capacity)

    def delete(self, object_id: ObjectID, evicted: bool = False,
               keep_spilled: bool = False):
        with self._lock:
            if self.arena is not None:
                self.arena.delete(object_id.binary())
            if not keep_spilled:
                self._drop_spill_file(object_id)
            obj = self._objects.pop(object_id, None)
            was_pinned = self._pinned.pop(object_id, None) is not None
            if obj is not None:
                self.used -= obj.data_size
                view_clean = False
                if not was_pinned:
                    # Reclaim the canonical exported view BEFORE close():
                    # without this every object ever read leaves an
                    # exported pointer and close() fails (the BufferError
                    # spam in the bench tail).  Pinned objects are being
                    # actively chunk-read; leave their view to the leak-
                    # tolerant path below rather than yank it mid-send.
                    view_clean = obj.release_view()
                if (obj.pool_class is not None and view_clean
                        and self.pool is not None
                        and self.pool.release(obj.shm, obj.pool_class)):
                    # Recycled: the mapped, faulted segment goes back to
                    # its size-class free list for the next put.  Pinned
                    # or export-leaking segments are never recycled — an
                    # active reader must see stale bytes, not new ones.
                    pass
                else:
                    try:
                        # Adopted segments were attach-registered and then
                        # untracked; unlink()'s unregister must find the
                        # name registered or the tracker daemon logs a
                        # KeyError per deleted object.
                        retrack(obj.shm)
                        obj.shm.unlink()
                    except Exception:
                        pass
                    forget_untracked(obj.shm)
                    # defuse, not plain close: when a reader's view still
                    # borrows the mapping, a failed close() used to leave
                    # the handles set and __del__ retried it at interpreter
                    # shutdown — the BufferError traceback spam in the
                    # bench tail.  Defusing drops the handles so the
                    # mapping dies silently with its last view.
                    defuse_shm(obj.shm)
                if evicted and self.evict_callback is not None:
                    try:
                        self.evict_callback(object_id)
                    except Exception:
                        pass

    def _evict_until(self, needed: int, exclude: Optional[ObjectID] = None):
        # Evict unpinned sealed objects, least recently used first; objects
        # the policy says must survive are spilled to disk instead of
        # dropped (plasma eviction_policy.h + local_object_manager.h:41).
        if self.used + needed <= self.capacity:
            return
        for oid in list(self._objects.keys()):
            if self.used + needed <= self.capacity:
                break
            if oid == exclude or oid in self._pinned:
                continue
            if not self._objects[oid].sealed:
                continue
            if self.spill_dir is not None and (
                    self.should_spill is None or self.should_spill(oid)):
                self._spill(oid)
            else:
                self.delete(oid, evicted=True)

    def _spill(self, oid: ObjectID):
        obj = self._objects.get(oid)
        if obj is None or not obj.sealed:
            return
        os.makedirs(self.spill_dir, exist_ok=True)
        path = os.path.join(self.spill_dir, oid.hex() + ".bin")
        with open(path, "wb") as f:
            f.write(obj.shm.buf[: obj.data_size])
        self._spilled[oid] = (path, obj.metadata, obj.data_size)
        # Free the memory; the spilled record + file survive this delete.
        self.delete(oid, keep_spilled=True)
        if self.spill_callback is not None:
            try:
                self.spill_callback(oid)
            except Exception:
                pass

    def backup(self, oid: ObjectID) -> Optional[Tuple[str, bytes, int]]:
        """Durability spill: copy a sealed object's bytes to the spill dir
        WITHOUT evicting it — the in-memory copy keeps serving zero-copy
        reads, the disk copy survives this node's death (restore path:
        head-side spill records, see head._try_reconstruct).  Returns the
        (path, meta, size) record, or None when the object is gone or the
        store has no spill dir."""
        with self._lock:
            obj = self._objects.get(oid)
            if obj is None or not obj.sealed or self.spill_dir is None:
                return self._spilled.get(oid)
            rec = self._spilled.get(oid)
            if rec is not None:
                return rec  # already on disk (spilled or backed up)
            os.makedirs(self.spill_dir, exist_ok=True)
            path = os.path.join(self.spill_dir, oid.hex() + ".bin")
            with open(path, "wb") as f:
                f.write(obj.shm.buf[: obj.data_size])
            rec = (path, obj.metadata, obj.data_size)
            self._spilled[oid] = rec
        if self.spill_callback is not None:
            try:
                self.spill_callback(oid)
            except Exception:
                pass
        return rec

    def spilled_lookup(self, oid: ObjectID):
        with self._lock:
            rec = self._spilled.get(oid)
            if rec is None:
                return None
            path, meta, size = rec
            return {"kind": "spilled", "path": path, "meta": meta,
                    "size": size}

    def read_spilled(self, oid: ObjectID) -> Optional[Tuple[bytes, bytes]]:
        with self._lock:
            rec = self._spilled.get(oid)
        if rec is None:
            return None
        path, meta, _ = rec
        try:
            with open(path, "rb") as f:
                return meta, f.read()
        except FileNotFoundError:
            return None

    def _drop_spill_file(self, oid: ObjectID):
        rec = self._spilled.pop(oid, None)
        if rec is not None:
            try:
                os.remove(rec[0])
            except OSError:
                pass

    # -- native arena paths (owner process only) --
    def arena_write(self, object_id: ObjectID, size: int) -> Optional[memoryview]:
        if self.arena is None:
            return None
        return self.arena.allocate(object_id.binary(), size)

    def arena_seal(self, object_id: ObjectID, metadata: bytes):
        self.arena.seal(object_id.binary(), metadata)

    def arena_lookup(self, object_id: ObjectID):
        if self.arena is None:
            return None
        hit = self.arena.lookup(object_id.binary())
        if hit is None:
            return None
        offset, size, meta = hit
        return {"kind": "arena", "store": self.arena.name, "offset": offset,
                "size": size, "meta": meta, "capacity": self.arena.capacity}

    def shutdown(self, keep_spilled: bool = False):
        """``keep_spilled=True`` is the node-death teardown: in-memory
        objects die with the store, but on-disk spill/backup copies are
        the durability plane's restore source and must survive."""
        with self._lock:
            for oid in list(self._objects.keys()):
                self.delete(oid, keep_spilled=keep_spilled)
            if self.arena is not None:
                self.arena.close()
                self.arena = None
            if self.pool is not None:
                self.pool.close()

    def stats(self) -> Dict[str, int]:
        with self._lock:
            out = {
                "num_objects": len(self._objects),
                "used_bytes": self.used,
                "capacity_bytes": self.capacity,
                "num_pinned": len(self._pinned),
                "segments_created_total": self.segments_created_total,
            }
            if self.pool is not None:
                out.update(self.pool.stats())
            return out


class ObjectExistsError(Exception):
    pass


class OutOfMemoryError(Exception):
    pass
