"""Binary identifiers for jobs, tasks, actors, objects, nodes and workers.

Equivalent role to the reference's 128/160-bit binary IDs
(``src/ray/common/id.h``): stable, hashable, cheaply serializable IDs that
embed lineage information (an ObjectID embeds the TaskID that created it,
a TaskID embeds its JobID).  We use 16-byte random IDs with small structured
prefixes rather than the reference's exact layouts — the layout is our own.
"""

from __future__ import annotations

import os
import threading

_ID_SIZE = 16

_local = threading.local()


_POOL_REFILL = 256 * _ID_SIZE


def _random_bytes(n: int = _ID_SIZE) -> bytes:
    """Entropy from a thread-local urandom pool: one syscall buys 256
    ids (a per-task urandom() call was ~13% of submission CPU in the
    core microbench)."""
    buf = getattr(_local, "pool", b"")
    if len(buf) < n:
        buf = os.urandom(max(_POOL_REFILL, n))
    _local.pool = buf[n:]
    return buf[:n]


# a forked child must never replay the parent's pooled entropy
# (workers here are spawned, not forked — this is belt-and-braces)
os.register_at_fork(after_in_child=lambda: setattr(_local, "pool", b""))


class BaseID:
    """Immutable binary ID. Subclasses differ only by kind tag."""

    __slots__ = ("_bytes", "_hash")

    KIND = b"\x00"

    def __init__(self, id_bytes: bytes):
        if not isinstance(id_bytes, bytes) or len(id_bytes) != _ID_SIZE:
            raise ValueError(
                f"{type(self).__name__} requires {_ID_SIZE} bytes, got {id_bytes!r}"
            )
        self._bytes = id_bytes
        self._hash = hash(id_bytes)

    @classmethod
    def from_random(cls):
        return cls(cls.KIND + _random_bytes(_ID_SIZE - 1))

    @classmethod
    def nil(cls):
        return cls(b"\xff" * _ID_SIZE)

    def is_nil(self) -> bool:
        return self._bytes == b"\xff" * _ID_SIZE

    def binary(self) -> bytes:
        return self._bytes

    def hex(self) -> str:
        return self._bytes.hex()

    @classmethod
    def from_hex(cls, hex_str: str):
        return cls(bytes.fromhex(hex_str))

    def __hash__(self):
        return self._hash

    def __eq__(self, other):
        return isinstance(other, BaseID) and other._bytes == self._bytes

    def __ne__(self, other):
        return not self.__eq__(other)

    def __repr__(self):
        return f"{type(self).__name__}({self._bytes.hex()[:16]})"

    def __reduce__(self):
        return (type(self), (self._bytes,))


class JobID(BaseID):
    KIND = b"\x01"


class NodeID(BaseID):
    KIND = b"\x02"


class WorkerID(BaseID):
    KIND = b"\x03"


class TaskID(BaseID):
    KIND = b"\x04"

    @classmethod
    def for_job(cls, job_id: JobID):
        """Derive a fresh task id carrying the job id in its suffix."""
        return cls(cls.KIND + _random_bytes(_ID_SIZE - 5) + job_id.binary()[1:5])


class ActorID(BaseID):
    KIND = b"\x05"


class ObjectID(BaseID):
    """Object ids embed the creating task's entropy so lineage can be traced.

    Reference analogue: ObjectID = TaskID + return-index
    (``src/ray/common/id.h`` ObjectID::FromIndex).
    """

    KIND = b"\x06"

    @classmethod
    def for_task_return(cls, task_id: TaskID, index: int):
        """Layout: task-id entropy bytes [1:16) + 1-byte return index, so the
        full creating TaskID is recoverable (see ObjectRef.task_id)."""
        if index < 0 or index > 0xFF:
            raise ValueError(f"return index out of range: {index}")
        return cls(task_id.binary()[1:16] + index.to_bytes(1, "big"))

    @classmethod
    def for_gen_item(cls, task_id: "TaskID", index: int):
        """Dynamic (streaming) return item ids. Layout: task-id entropy
        [1:11) + 0xFE marker + u32 index — a streaming task can yield up
        to 2**32 items (reference: ObjectRefGenerator's dynamically
        allocated return ids, ``_raylet.pyx:252``)."""
        if index < 0 or index > 0xFFFFFFFF:
            raise ValueError(f"generator item index out of range: {index}")
        return cls(task_id.binary()[1:12] + b"\xfe"
                   + index.to_bytes(4, "big"))

    @classmethod
    def for_put(cls, owner: WorkerID):
        """Layout: KIND + 7 owner-entropy bytes + 8 random, so the owning
        worker is identifiable from the id during debugging/recovery."""
        return cls(cls.KIND + owner.binary()[1:8]
                   + _random_bytes(_ID_SIZE - 8))

    def task_entropy(self) -> bytes:
        return self._bytes[:15]

    def return_index(self) -> int:
        return self._bytes[15]


class PlacementGroupID(BaseID):
    KIND = b"\x07"
