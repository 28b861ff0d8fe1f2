"""Serialization: cloudpickle + out-of-band zero-copy buffers for arrays.

Equivalent of the reference's SerializationContext
(python/ray/_private/serialization.py:92), redesigned for a JAX-first stack:

- cloudpickle (pickle protocol 5) for arbitrary Python objects,
- numpy arrays >= INLINE_THRESHOLD are carried as out-of-band
  ``PickleBuffer``s so the object store can place them contiguously and the
  reader can reconstruct a zero-copy view over shared memory,
- ``torch.Tensor``s, at the top level or nested in any container, are
  copied to the host exactly once at the put-boundary and travel as raw
  bytes with a dtype tag (bf16 has no numpy dtype), out of band from
  INLINE_THRESHOLD bytes like numpy arrays; on-device data never travels
  through the object store.  They are read back as CPU tensors of the same
  dtype and shape over the store's memory, and the reader moves them to
  its own device.
- ObjectRefs serialize by ID with an ownership record so the borrowing
  protocol can register them (see object_store.py / gcs.py).

Copied from ``ray_tpu/_private/serialization.py`` (the JAX package), with
torch tensors in place of its ``jax.Array`` handling.
"""
from __future__ import annotations

import io
import pickle
import sys
import threading
from typing import Any, List, Optional, Tuple

import cloudpickle
import numpy as np

# Arrays below this size are pickled in-band.
INLINE_ARRAY_THRESHOLD = 1024

# Types safe for the plain-pickle fast path (see serialize()).
_SCALAR_FAST_TYPES = (type(None), bool, int, float, str, bytes)


# ---------------------------------------------------------------------------
# Parallel memcpy (pack_into hot path)
# ---------------------------------------------------------------------------
# numpy's assignment into a uint8 view is a real memcpy that RELEASES the
# GIL, so a small worker pool copies disjoint chunks of one large buffer
# concurrently and scales with memory bandwidth instead of one core.  The
# pool is process-global, lazily built, and sized by CONFIG.copy_threads
# (0 = auto).  Buffers below CONFIG.parallel_copy_min_bytes — and every
# copy when the pool resolves to a single thread — take the plain
# single-call path.
_copy_pool = None
_copy_pool_lock = threading.Lock()
_copy_threads = 0


def _get_copy_pool():
    global _copy_pool, _copy_threads
    if _copy_threads:
        return _copy_pool
    with _copy_pool_lock:
        if _copy_threads:
            return _copy_pool
        import os

        from ray_tpu_torch._private.config import CONFIG

        n = CONFIG.copy_threads
        if n <= 0:
            n = min(4, max(1, (os.cpu_count() or 2) // 2))
        if n > 1:
            from concurrent.futures import ThreadPoolExecutor

            try:
                _copy_pool = ThreadPoolExecutor(
                    max_workers=n - 1, thread_name_prefix="rtpu-memcpy")
            except Exception:
                _copy_pool, n = None, 1
        _copy_threads = n
        return _copy_pool


def _memcpy(dst: memoryview, src: memoryview) -> None:
    """Copy src -> dst (equal-length byte views), in parallel chunks when
    the buffer is large enough and the copy pool has workers."""
    n = src.nbytes
    dst_a = np.frombuffer(dst, np.uint8)
    src_a = np.frombuffer(src, np.uint8)
    from ray_tpu_torch._private.config import CONFIG

    pool = _get_copy_pool() if n >= CONFIG.parallel_copy_min_bytes else None
    if pool is None:
        dst_a[:] = src_a
        return
    nthreads = _copy_threads
    # 64-byte-aligned chunk bounds keep every slice cache-line disjoint.
    step = -(-n // nthreads + 63) & ~63
    futs = [pool.submit(_copy_chunk, dst_a, src_a, off, min(off + step, n))
            for off in range(step, n, step)]
    dst_a[:min(step, n)] = src_a[:min(step, n)]  # chunk 0 on this thread
    for f in futs:
        f.result()


def _copy_chunk(dst_a, src_a, lo: int, hi: int) -> None:
    dst_a[lo:hi] = src_a[lo:hi]


class _RefSerializationContext(threading.local):
    """Collects ObjectRefs seen while (de)serializing a value, so the caller
    can register borrows / contained-ids (reference: contained object ids in
    src/ray/core_worker/reference_count.h)."""

    def __init__(self):
        self.refs: List[Any] = []
        self.owners: dict = {}  # oid binary -> owner address dict
        self.active = False

    def start(self):
        self.refs = []
        self.owners = {}
        self.active = True

    def stop(self) -> List[Any]:
        self.active = False
        refs, self.refs = self.refs, []
        self.owners = {}
        return refs

    def stop_with_owners(self):
        self.active = False
        refs, self.refs = self.refs, []
        owners, self.owners = self.owners, {}
        return refs, owners


ref_context = _RefSerializationContext()


def _tensor_types(torch) -> tuple:
    """``torch.Tensor`` and ``nn.Parameter``, as far as torch's import has
    bound them: another thread may be mid-``import torch`` (the module is
    in sys.modules, its attributes not yet), and no object of a class that
    is not bound yet can exist."""
    tensor = getattr(torch, "Tensor", None)
    if tensor is None:
        return ()
    param = getattr(getattr(torch, "nn", None), "Parameter", None)
    return (tensor,) if param is None else (tensor, param)


def _reduce_tensor(torch, obj):
    """Reduce a dense tensor to (bytes, dtype, shape): one copy to the host
    for a device tensor, none for a contiguous CPU tensor.  The bytes go
    out as a PickleBuffer, so from INLINE_ARRAY_THRESHOLD on they travel
    out of band like a numpy array's."""
    t = obj.detach().contiguous()
    if t.device.type != "cpu":
        t = t.cpu()
    raw = t.reshape(-1).view(torch.uint8).numpy()
    return (_rebuild_tensor,
            (pickle.PickleBuffer(raw), str(t.dtype).replace("torch.", ""),
             tuple(t.shape), obj.requires_grad,
             isinstance(obj, torch.nn.Parameter)))


def _rebuild_tensor(buf, dtype: str, shape: tuple, requires_grad: bool,
                    parameter: bool):
    """A CPU tensor over ``buf``.  Where the buffer is writable (the
    store's shared-memory segments), the tensor shares it, and an in-place
    write lands there, as it does in a numpy array read back from the same
    memory.  Where it is read-only (the native arena and spill files are
    mapped without write access, inline data is ``bytes``), a tensor over
    it could still be written and would fault or change an immutable
    object, so the tensor gets a private copy."""
    import torch

    arr = np.frombuffer(buf, dtype=np.uint8)
    if not arr.flags.writeable:
        arr = arr.copy()
    t = torch.from_numpy(arr).view(getattr(torch, dtype)).reshape(shape)
    if parameter:
        return torch.nn.Parameter(t, requires_grad=requires_grad)
    return t.requires_grad_(requires_grad)


class _Pickler(cloudpickle.CloudPickler):
    """cloudpickle with torch tensors reduced by _reduce_tensor: torch's
    own reducer would pickle a CUDA tensor with its device (which a CPU
    worker cannot load) and a view with its whole storage."""

    def reducer_override(self, obj):
        # No tensor can exist before torch is imported, so a process that
        # never imports torch never pays for it here (the reference's
        # _is_jax_array makes the same argument for jax).
        torch = sys.modules.get("torch")
        if torch is not None and type(obj) in _tensor_types(torch) \
                and obj.layout == torch.strided \
                and obj.device.type != "meta" and not obj.is_quantized:
            return _reduce_tensor(torch, obj)
        return super().reducer_override(obj)


class SerializedObject:
    """A serialized value: a pickle blob + out-of-band raw buffers.

    Layout written to the object store:
        [8B pickle-len][pickle blob][buffer 0][buffer 1]...
    with an index of (offset, length) pairs carried in the metadata, so
    readers can rebuild zero-copy memoryviews.
    """

    __slots__ = ("inband", "buffers", "contained_refs", "contained_owners")

    def __init__(self, inband: bytes, buffers: List[Any], contained_refs: List[Any],
                 contained_owners: Optional[dict] = None):
        self.inband = inband
        self.buffers = buffers  # list of objects supporting the buffer protocol
        self.contained_refs = contained_refs
        # oid binary -> owner address for contained refs whose bytes live in
        # a process's in-process store (ownership protocol, see direct.py).
        self.contained_owners = contained_owners or {}

    @property
    def total_bytes(self) -> int:
        return len(self.inband) + sum(len(memoryview(b).cast("B")) for b in self.buffers)


def serialize(value: Any) -> SerializedObject:
    buffers: List[pickle.PickleBuffer] = []

    def buffer_callback(buf: pickle.PickleBuffer) -> bool:
        raw = buf.raw()
        if raw.nbytes >= INLINE_ARRAY_THRESHOLD:
            buffers.append(buf)
            return False  # out-of-band
        return True  # serialize in-band

    ref_context.start()
    try:
        # Plain pickle (C fast path, ~5x cheaper per call than a
        # CloudPickler instance) ONLY for scalar types that can never
        # reference a __main__-defined class: a plain pickle of such a
        # class succeeds by REFERENCE in the driver but fails to load in a
        # worker (whose __main__ is default_worker) — cloudpickle instead
        # serializes it by value.  Containers stay on cloudpickle because
        # their elements may embed arbitrary user types.
        if type(value) in _SCALAR_FAST_TYPES:
            inband = pickle.dumps(value, protocol=5)
        else:
            out = io.BytesIO()
            _Pickler(out, protocol=5,
                     buffer_callback=buffer_callback).dump(value)
            inband = out.getvalue()
    finally:
        contained, owners = ref_context.stop_with_owners()
    return SerializedObject(inband, [b.raw() for b in buffers], contained,
                            owners)


def deserialize(inband: bytes, buffers: List[memoryview]) -> Tuple[Any, List[Any]]:
    """Returns (value, contained_object_refs)."""
    ref_context.start()
    try:
        value = pickle.loads(inband, buffers=buffers)
    finally:
        contained = ref_context.stop()
    return value, contained


def pack(serialized: SerializedObject) -> Tuple[bytes, bytes]:
    """Pack into (metadata, data) byte strings for the object store.

    metadata is a small pickle of the buffer index; data is the concatenation
    of the in-band pickle and all raw buffers, 64-byte aligned so numpy views
    over shared memory are cache-line aligned (reference aligns to 64 in
    plasma: src/ray/object_manager/plasma/ allocation alignment).
    """
    if not serialized.buffers:
        # No out-of-band buffers: the data IS the in-band pickle (readers
        # slice data[:inband_len]; padding only matters for buffer align).
        return _bufferless_meta(len(serialized.inband)), serialized.inband
    offsets = []
    pos = _align(len(serialized.inband))
    for b in serialized.buffers:
        n = memoryview(b).cast("B").nbytes
        offsets.append((pos, n))
        pos = _align(pos + n)
    meta = pickle.dumps({"inband_len": len(serialized.inband), "buffers": offsets})
    out = io.BytesIO()
    out.write(serialized.inband)
    _pad(out, _align(len(serialized.inband)) - len(serialized.inband))
    for b, (off, n) in zip(serialized.buffers, offsets):
        assert out.tell() == off
        out.write(memoryview(b).cast("B"))
        _pad(out, _align(off + n) - (off + n))
    return meta, out.getvalue()


def packed_size(serialized: SerializedObject) -> int:
    pos = _align(len(serialized.inband))
    for b in serialized.buffers:
        n = memoryview(b).cast("B").nbytes
        pos = _align(pos + n)
    return pos


def pack_into(serialized: SerializedObject, dest: memoryview) -> bytes:
    """Zero-intermediate-copy pack directly into a writable memoryview
    (a shared-memory segment). Returns metadata."""
    offsets = []
    pos = _align(len(serialized.inband))
    for b in serialized.buffers:
        n = memoryview(b).cast("B").nbytes
        offsets.append((pos, n))
        pos = _align(pos + n)
    if offsets:
        meta = pickle.dumps({"inband_len": len(serialized.inband),
                             "buffers": offsets})
    else:
        meta = _bufferless_meta(len(serialized.inband))
    dest[: len(serialized.inband)] = serialized.inband
    for b, (off, n) in zip(serialized.buffers, offsets):
        # numpy memcpy (CPython's memoryview slice assignment takes a
        # bytewise path ~4x slower), split across the copy-thread pool
        # for large buffers — see _memcpy.
        _memcpy(dest[off:off + n], memoryview(b).cast("B"))
    return meta


def unpack(meta: bytes, data: memoryview) -> Tuple[Any, List[Any]]:
    """Inverse of pack/pack_into over a (possibly shared-memory) buffer.

    numpy arrays come back as zero-copy views over ``data``."""
    index = pickle.loads(meta)
    inband = bytes(data[: index["inband_len"]])
    buffers = [data[off : off + n] for off, n in index["buffers"]]
    return deserialize(inband, buffers)


def num_oob_buffers(meta: bytes) -> int:
    """Number of out-of-band buffers recorded in an object's metadata —
    i.e. whether deserializing it yields zero-copy views over the store."""
    return len(pickle.loads(meta)["buffers"])


# Bufferless-object metadata depends only on inband length; small puts
# (ints, short strings) mint one per call otherwise — a measurable slice
# of the sub-100KB put path.  Bounded dict, hot lengths stabilize fast.
_bufferless_meta_cache: dict = {}


def _bufferless_meta(inband_len: int) -> bytes:
    meta = _bufferless_meta_cache.get(inband_len)
    if meta is None:
        meta = pickle.dumps({"inband_len": inband_len, "buffers": ()})
        if len(_bufferless_meta_cache) < 4096:
            _bufferless_meta_cache[inband_len] = meta
    return meta


def _align(n: int, a: int = 64) -> int:
    return (n + a - 1) & ~(a - 1)


def _pad(out: io.BytesIO, n: int):
    if n:
        out.write(b"\x00" * n)
