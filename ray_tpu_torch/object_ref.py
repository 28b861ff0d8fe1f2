"""ObjectRef: the user-facing future handle for an object in the cluster.

Reference equivalent: ObjectRef in python/ray/includes/object_ref.pxi.
A ref carries its owner's address when the bytes live in a process's
in-process store (ownership protocol, src/ray/core_worker/
reference_count.h:61): serialization ships the address with the id, and
deserialization registers the receiving process as a *borrower* with the
owner (see _private/direct.py).  Refs without an owner address resolve
through the head directory as before.

Copied from ``ray_tpu/object_ref.py`` (the JAX package).
"""
from __future__ import annotations

from typing import Optional

from ray_tpu_torch._private import serialization as ser
from ray_tpu_torch._private.ids import ObjectID

# Set by ray_tpu_torch._private.worker at init; avoids an import cycle.
_get_global_worker = lambda: None  # noqa: E731


class ObjectRef:
    # _hold_args: driver-side pin for large-literal task args promoted to
    # put objects (worker.make_args) — holding them on the RESULT ref
    # keeps the promoted objects alive at least as long as the caller
    # cares about the task, closing the race where ref-gc frees an arg
    # before the executing worker resolves it.  Never serialized.
    __slots__ = ("id", "owner_addr", "_owner_registered", "_hold_args",
                 "__weakref__")

    def __init__(self, object_id: ObjectID, skip_adding_local_ref: bool = False,
                 owner_addr: Optional[dict] = None):
        self.id = object_id
        self.owner_addr = owner_addr
        self._owner_registered = False
        self._hold_args = None
        if not skip_adding_local_ref:
            w = _get_global_worker()
            if w is not None:
                w.add_local_ref(object_id, owner_addr)
                self._owner_registered = True

    def binary(self) -> bytes:
        return self.id.binary()

    def hex(self) -> str:
        return self.id.hex()

    def task_id(self):
        return self.id.task_id()

    def future(self):
        """Return a concurrent.futures.Future resolving to the value."""
        w = _get_global_worker()
        return w.get_async(self)

    def __await__(self):
        import asyncio

        w = _get_global_worker()
        fut = w.get_async(self)
        return asyncio.wrap_future(fut).__await__()

    def __hash__(self):
        return hash(self.id)

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other.id == self.id

    def __repr__(self):
        return f"ObjectRef({self.id.hex()})"

    def _effective_owner(self) -> Optional[dict]:
        """The address to ship with this ref: an explicit borrow source, or
        this process's own direct address when it owns the bytes."""
        if self.owner_addr is not None:
            return self.owner_addr
        w = _get_global_worker()
        if w is not None and getattr(w, "_owned", None) is not None \
                and w._owned.contains(self.id):
            return getattr(w, "direct_addr", None)
        return None

    def __reduce__(self):
        owner = self._effective_owner()
        if ser.ref_context.active:
            ser.ref_context.refs.append(self.id)
            if owner is not None:
                ser.ref_context.owners[self.id.binary()] = owner
        return (_deserialize_ref, (self.id.binary(), owner))

    def __del__(self):
        # Finalizers run at arbitrary points (including inside transport
        # sends/recvs mid-pickle): hand the removal to the worker's ref-gc
        # drainer instead of doing transport I/O on this thread.
        if self._owner_registered:
            w = _get_global_worker()
            if w is not None:
                try:
                    w.remove_local_ref_deferred(self.id, self.owner_addr)
                except Exception:
                    pass


def _deserialize_ref(binary: bytes, owner_addr: Optional[dict] = None) -> ObjectRef:
    ref = ObjectRef(ObjectID(binary), owner_addr=owner_addr)
    if ser.ref_context.active:
        ser.ref_context.refs.append(ref.id)
        if owner_addr is not None:
            ser.ref_context.owners[ref.id.binary()] = owner_addr
    return ref
