"""Native (C++) components, built on demand with g++ and bound via ctypes.

Currently: the shared-memory arena store (shm_store.cpp) — the plasma-core
equivalent.  Falls back gracefully (callers check `available()`).

Copied from ``ray_tpu/_native/__init__.py`` (the JAX package).
"""
from __future__ import annotations

import ctypes
import mmap as mmap_mod
import os
import subprocess
import threading
from typing import Optional, Tuple

_HERE = os.path.dirname(os.path.abspath(__file__))
# Built at first use into the port's build directory (listed in
# .gitignore); no binary is committed.
_SO = os.path.join(os.path.dirname(_HERE), "_build", "libshm_store.so")
_SRC = os.path.join(_HERE, "shm_store.cpp")

_lib = None
_build_lock = threading.Lock()
_build_failed = False


def _build() -> Optional[ctypes.CDLL]:
    global _build_failed
    with _build_lock:
        if os.path.exists(_SO) and os.path.getmtime(_SO) >= os.path.getmtime(_SRC):
            try:
                return ctypes.CDLL(_SO)
            except OSError:
                # A stale binary built against a different glibc/toolchain
                # (e.g. checked out on an older container) must not break
                # the graceful fallback — rebuild from source below.
                pass
        if _build_failed:
            return None
        # Build to a per-process name and rename: workers that start
        # together may each build, and none loads a half-written library.
        tmp = f"{_SO}.{os.getpid()}.tmp"
        try:
            os.makedirs(os.path.dirname(_SO), exist_ok=True)
            subprocess.run(
                ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", _SRC,
                 "-o", tmp, "-lrt"],
                check=True, capture_output=True, timeout=120)
            os.replace(tmp, _SO)
            return ctypes.CDLL(_SO)
        except Exception:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            _build_failed = True
            return None


def _get_lib() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is None:
        lib = _build()
        if lib is None:
            return None
        lib.rtpu_store_create.restype = ctypes.c_void_p
        lib.rtpu_store_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        lib.rtpu_store_destroy.argtypes = [ctypes.c_void_p]
        lib.rtpu_store_allocate.restype = ctypes.c_int64
        lib.rtpu_store_allocate.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_uint64]
        lib.rtpu_store_seal.restype = ctypes.c_int
        lib.rtpu_store_seal.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p,
            ctypes.c_int]
        lib.rtpu_store_get.restype = ctypes.c_int64
        lib.rtpu_store_get.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_int)]
        lib.rtpu_store_get_meta.restype = ctypes.c_int
        lib.rtpu_store_get_meta.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p,
            ctypes.c_int]
        lib.rtpu_store_delete.restype = ctypes.c_int
        lib.rtpu_store_delete.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
        lib.rtpu_store_used.restype = ctypes.c_uint64
        lib.rtpu_store_used.argtypes = [ctypes.c_void_p]
        lib.rtpu_store_num_objects.restype = ctypes.c_uint64
        lib.rtpu_store_num_objects.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


def available() -> bool:
    return _get_lib() is not None


class NativeArenaStore:
    """Owner-side handle (lives in the head process)."""

    def __init__(self, name: str, capacity: int):
        lib = _get_lib()
        if lib is None:
            raise RuntimeError("native store unavailable (g++ build failed)")
        self._lib = lib
        self.name = name
        self.capacity = capacity
        self._handle = lib.rtpu_store_create(name.encode(), capacity)
        if not self._handle:
            raise RuntimeError(f"failed to create native store {name!r}")
        # Owner-side view over the whole arena for zero-copy writes.
        fd = os.open(f"/dev/shm/{name}", os.O_RDWR)
        try:
            self._map = mmap_mod.mmap(fd, capacity)
        finally:
            os.close(fd)

    def allocate(self, object_id: bytes, size: int) -> Optional[memoryview]:
        off = self._lib.rtpu_store_allocate(self._handle, object_id,
                                            len(object_id), size)
        if off < 0:
            return None
        return memoryview(self._map)[off: off + size]

    def seal(self, object_id: bytes, metadata: bytes):
        rc = self._lib.rtpu_store_seal(self._handle, object_id,
                                       len(object_id), metadata, len(metadata))
        if rc != 0:
            raise KeyError(f"seal: unknown object {object_id.hex()}")

    def lookup(self, object_id: bytes) -> Optional[Tuple[int, int, bytes]]:
        """Returns (offset, size, metadata) for sealed objects, else None."""
        size = ctypes.c_uint64()
        meta_len = ctypes.c_int()
        off = self._lib.rtpu_store_get(self._handle, object_id,
                                       len(object_id),
                                       ctypes.byref(size),
                                       ctypes.byref(meta_len))
        if off < 0:
            return None
        buf = ctypes.create_string_buffer(meta_len.value)
        self._lib.rtpu_store_get_meta(self._handle, object_id, len(object_id),
                                      ctypes.cast(buf, ctypes.c_char_p),
                                      meta_len.value)
        return int(off), int(size.value), buf.raw

    def view(self, offset: int, size: int) -> memoryview:
        return memoryview(self._map)[offset: offset + size]

    def delete(self, object_id: bytes) -> bool:
        return self._lib.rtpu_store_delete(self._handle, object_id,
                                           len(object_id)) == 0

    @property
    def used(self) -> int:
        return int(self._lib.rtpu_store_used(self._handle))

    @property
    def num_objects(self) -> int:
        return int(self._lib.rtpu_store_num_objects(self._handle))

    def close(self):
        if self._handle:
            try:
                self._map.close()
            except Exception:
                pass
            self._lib.rtpu_store_destroy(self._handle)
            self._handle = None


class ArenaReader:
    """Reader-side attach (worker processes): mmap the arena read-only."""

    _cache: dict = {}
    _lock = threading.Lock()

    @classmethod
    def view(cls, store_name: str, offset: int, size: int,
             capacity: int) -> memoryview:
        with cls._lock:
            m = cls._cache.get(store_name)
            if m is None:
                fd = os.open(f"/dev/shm/{store_name}", os.O_RDONLY)
                try:
                    m = mmap_mod.mmap(fd, capacity, prot=mmap_mod.PROT_READ)
                finally:
                    os.close(fd)
                cls._cache[store_name] = m
        return memoryview(m)[offset: offset + size]
