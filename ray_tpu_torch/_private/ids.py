"""Unique identifiers for jobs, tasks, actors, objects, nodes and placement groups.

TPU-native rethink of the reference's ID scheme (ref: src/ray/common/id.h,
python/ray/includes/unique_ids.pxi).  We keep the load-bearing design decision —
**ObjectIDs embed the ID of the task that created them plus a return-index**, so
ownership and lineage can be derived from the ID itself — but use a simpler
fixed-width random scheme rather than the reference's bit-packed flags.

Copied from ``ray_tpu/_private/ids.py`` (the JAX package).
"""
from __future__ import annotations

import os
import binascii
import random
import threading

_NIL = b"\x00"

# Process-local PRNG seeded from the OS once: ID generation is on the task
# submission hot path and os.urandom's syscall per ID costs ~100x a PRNG
# draw.  Uniqueness needs 128 random bits, not cryptographic strength.
# Re-seeded after fork so children don't replay the parent's stream.
_rng = random.Random(os.urandom(16))
_rng_pid = os.getpid()
_rng_lock = threading.Lock()


def _random_bytes(n: int) -> bytes:
    global _rng, _rng_pid
    with _rng_lock:
        if os.getpid() != _rng_pid:
            _rng = random.Random(os.urandom(16))
            _rng_pid = os.getpid()
        return _rng.getrandbits(n * 8).to_bytes(n, "little")


class BaseID:
    """A fixed-size binary identifier. Hashable, comparable, hex-printable."""

    SIZE = 16
    __slots__ = ("_bytes", "_hash")

    def __init__(self, id_bytes: bytes):
        if len(id_bytes) != self.SIZE:
            raise ValueError(
                f"{type(self).__name__} requires {self.SIZE} bytes, got {len(id_bytes)}"
            )
        self._bytes = id_bytes
        self._hash = hash((type(self).__name__, id_bytes))

    @classmethod
    def from_random(cls):
        return cls(_random_bytes(cls.SIZE))

    @classmethod
    def nil(cls):
        return cls(_NIL * cls.SIZE)

    @classmethod
    def from_hex(cls, hex_str: str):
        return cls(binascii.unhexlify(hex_str))

    def binary(self) -> bytes:
        return self._bytes

    def hex(self) -> str:
        return self._bytes.hex()

    def is_nil(self) -> bool:
        return self._bytes == _NIL * self.SIZE

    def __hash__(self):
        return self._hash

    def __eq__(self, other):
        return type(other) is type(self) and other._bytes == self._bytes

    def __lt__(self, other):
        return self._bytes < other._bytes

    def __repr__(self):
        return f"{type(self).__name__}({self._bytes.hex()[:16]})"

    def __reduce__(self):
        return (type(self), (self._bytes,))


class JobID(BaseID):
    SIZE = 4


class NodeID(BaseID):
    SIZE = 16


class WorkerID(BaseID):
    SIZE = 16


class ActorID(BaseID):
    """Actor id: 12 random bytes + 4-byte job id suffix."""

    SIZE = 16

    @classmethod
    def of(cls, job_id: JobID):
        return cls(os.urandom(cls.SIZE - JobID.SIZE) + job_id.binary())

    def job_id(self) -> JobID:
        return JobID(self._bytes[-JobID.SIZE:])


class TaskID(BaseID):
    SIZE = 16

    @classmethod
    def for_driver(cls, job_id: JobID):
        return cls(b"\xff" * (cls.SIZE - JobID.SIZE) + job_id.binary())


# Submission-hot-path task-id factory: a random 10-byte per-process prefix
# + 6-byte counter (GIL makes the counter draw atomic).  ~3x cheaper than
# from_random's locked PRNG draw; uniqueness holds because prefixes are
# process-unique and workers are spawned, never forked.
_task_id_prefix = os.urandom(10)
_task_id_prefix_pid = os.getpid()
_task_id_ctr = iter(range(1, 2**47))


def fast_task_id() -> TaskID:
    global _task_id_prefix, _task_id_prefix_pid, _task_id_ctr
    if os.getpid() != _task_id_prefix_pid:
        _task_id_prefix = os.urandom(10)
        _task_id_prefix_pid = os.getpid()
        _task_id_ctr = iter(range(1, 2**47))
    return TaskID(_task_id_prefix + next(_task_id_ctr).to_bytes(6, "little"))


class PlacementGroupID(BaseID):
    SIZE = 16


class ObjectID(BaseID):
    """Object id = task id (16B) + 4-byte big-endian return index.

    Index 0..2**31 are task returns; ``put`` objects use the high bit set,
    mirroring the reference's put-index space (src/ray/common/id.h).
    """

    SIZE = 20
    PUT_BIT = 1 << 31

    @classmethod
    def for_task_return(cls, task_id: TaskID, index: int):
        return cls(task_id.binary() + index.to_bytes(4, "big"))

    @classmethod
    def for_put(cls, task_id: TaskID, put_index: int):
        return cls(task_id.binary() + (cls.PUT_BIT | put_index).to_bytes(4, "big"))

    def task_id(self) -> TaskID:
        return TaskID(self._bytes[:TaskID.SIZE])

    def return_index(self) -> int:
        return int.from_bytes(self._bytes[16:], "big") & ~self.PUT_BIT

    def is_put(self) -> bool:
        return bool(int.from_bytes(self._bytes[16:], "big") & self.PUT_BIT)


# The reference calls these *Ref in the public API.
ObjectRefID = ObjectID
